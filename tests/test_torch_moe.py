"""Port parity for the MoE FFN (`repro_torch.models.moe`) against the JAX
package's single-device path (`repro.models.moe`: `_route`, `_fill_slots`,
`_moe_local`, `moe_block`; plain jnp, no Pallas kernel), with the
reference's weights set on the port's module and inputs from a seeded numpy
generator.

Tolerances:
  * the slot filling, the dispatch buffer and the combine: bit for bit,
    given the reference's routes (its expert ids and gates): integer
    bookkeeping, copies, and the same float adds in the same order.
  * the routing: gates and the aux loss's pieces within 1e-6 (the router
    product in another summation order moves a probability by an ulp or
    so); expert ids equal, except where the reference's probabilities at
    the differing rank and the next are within 1e-5 of each other (a
    near-tie such an ulp can flip).
  * the block's output: TOL, rtol 1e-4 / atol 1e-5 (float32 batched
    products in another summation order); its aux within 1e-6.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import api as ref_api
from repro.models import lm as ref_lm
from repro.models.moe import MoEConfig as RefMoEConfig
from repro.models.moe import _fill_slots, _route, init_moe, moe_block
from repro_torch.configs import ARCHS
from repro_torch.models import (
    decode_step,
    init_model,
    param_count,
    params_from_reference,
    prefill,
)
from repro_torch.models.lm import LM
from repro_torch.models.moe import (
    MoE,
    MoEConfig,
    balance_loss,
    capacity,
    combine,
    dispatch,
    expert_mlp,
    fill_slots,
    recording,
    route,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-5)
ROUTE_TOL = 1e-6
NEAR_TIE = 1e-5
MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")


def _cfgs(**kw):
    kw = dict(dict(d_model=32, d_ff=48, n_experts=8, top_k=2), **kw)
    return RefMoEConfig(**kw), MoEConfig(**kw)


def _pair(seed: int = 0, **kw):
    """The reference's parameters (numpy) and the port's module holding them."""
    ref_cfg, cfg = _cfgs(**kw)
    p = jax.tree.map(np.array, init_moe(jax.random.key(seed), ref_cfg))
    mod = MoE(cfg)
    named = dict(mod.named_parameters())
    flat = {k: v for k, v in p.items() if k != "shared"}
    flat.update({f"shared.{k}": v for k, v in p.get("shared", {}).items()})
    assert sorted(named) == sorted(flat)
    with torch.no_grad():
        for name, arr in flat.items():
            named[name].copy_(torch.from_numpy(np.array(arr)))
    return ref_cfg, cfg, p, mod.requires_grad_(False)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ref_routes(x: np.ndarray, p, ref_cfg):
    gates, eidx, _, _ = _route(jnp.asarray(x), jnp.asarray(p["router"]), ref_cfg)
    return np.array(gates), np.array(eidx)


@pytest.mark.parametrize("E,K", [(8, 1), (8, 2), (128, 8), (128, 1)])
def test_route_matches_reference(E, K):
    ref_cfg, _, p, _ = _pair(n_experts=E, top_k=K)
    x = _x(200, 32)
    gates, eidx, frac_t, frac_p = _route(jnp.asarray(x), jnp.asarray(p["router"]), ref_cfg)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1))
    want = [np.asarray(gates), np.asarray(eidx), probs]
    got = [a.numpy() for a in route(torch.from_numpy(x), torch.from_numpy(p["router"]), K)]
    for i in (0, 2):  # gates, probabilities
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=ROUTE_TOL)
    aux = balance_loss(torch.from_numpy(got[1]), torch.from_numpy(got[2]))
    np.testing.assert_allclose(float(aux), float(E * jnp.sum(frac_t * frac_p)), rtol=0,
                               atol=ROUTE_TOL)
    ranked = -np.sort(-probs, axis=-1)
    rows, ranks = np.nonzero(got[1] != want[1])
    for r, k in zip(rows, ranks):  # only near-ties may differ
        assert ranked[r, k] - ranked[r, k + 1] <= NEAR_TIE * ranked[r, k]
    assert len(rows) <= 2


def test_route_breaks_ties_to_the_lower_expert():
    """Experts 2, 5 and 6 share one router column: their probabilities are
    equal, and both packages take them in index order (`lax.top_k`'s
    contract; `torch.topk` does not promise it)."""
    ref_cfg, _, p, _ = _pair(top_k=2)
    router = p["router"].copy()
    router[:, 5] = router[:, 6] = router[:, 2] = np.abs(router).max(1) * 4
    x = np.abs(_x(16, 32, seed=3))
    want = np.asarray(_route(jnp.asarray(x), jnp.asarray(router), ref_cfg)[1])
    got = route(torch.from_numpy(x), torch.from_numpy(router), 2)[1].numpy()
    assert (want == [2, 5]).all() and np.array_equal(got, want)


@pytest.mark.parametrize("cap", [1, 3, 13, 100])
@pytest.mark.parametrize("K", [1, 2])
def test_fill_slots_is_bit_for_bit_given_the_reference_routes(K, cap):
    ref_cfg, _, p, _ = _pair(top_k=K)
    gates, eidx = _ref_routes(_x(50, 32, seed=1), p, ref_cfg)
    want = [np.asarray(a) for a in _fill_slots(jnp.asarray(eidx), jnp.asarray(gates), cap, 8)]
    got = fill_slots(torch.from_numpy(eidx).long(), torch.from_numpy(gates), cap, 8)
    for g, w in zip(got[:4], want):
        assert np.array_equal(g.numpy(), w)
    if cap * 8 < 50 * K:  # fewer slots than assignments
        assert int((want[3] == 0).sum()) > 0


@pytest.mark.parametrize("zero_gates", [False, True])
@pytest.mark.parametrize("cap", [2, 20])
def test_dispatch_and_combine_are_bit_for_bit(cap, zero_gates):
    """The reference's dispatch (`moe.py:119-121`) and combine (`:123-125`)
    written out in jnp over its own slots, against the port's, from the
    same routes and the same expert outputs.  With `zero_gates`, assignments
    ranked within `cap` get gate exactly 0: kept by rank, dropped by gate
    (`keep = sg > 0`), so their slots stay 0 and they add nothing."""
    ref_cfg, _, p, _ = _pair(top_k=2)
    T, E, D = 40, 8, 32
    xt = _x(T, D, seed=2)
    gates, eidx = _ref_routes(xt, p, ref_cfg)
    if zero_gates:
        gates[::3, 1] = 0.0
    slot_e, slot_r, st, sg = _fill_slots(jnp.asarray(eidx), jnp.asarray(gates), cap, E)
    keep = sg > 0.0
    buf = jnp.zeros((E, cap, D), jnp.float32).at[slot_e, slot_r].add(
        jnp.where(keep[:, None], jnp.asarray(xt)[st], 0.0))
    eo = _x(E, cap, D, seed=4)
    out = jnp.zeros((T, D), jnp.float32).at[st].add(jnp.asarray(eo)[slot_e, slot_r]
                                                    * sg[:, None])
    routes = fill_slots(torch.from_numpy(eidx).long(), torch.from_numpy(gates), cap, E)
    assert np.array_equal(dispatch(torch.from_numpy(xt), routes, E, cap).numpy(),
                          np.asarray(buf))
    assert np.array_equal(combine(torch.from_numpy(eo), routes, T).numpy(), np.asarray(out))
    if zero_gates:
        assert int((~keep & (np.asarray(slot_r) < cap - 1)).sum()) > 0


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["cf 1.25", "forced drops"])
@pytest.mark.parametrize("shared", [0, 40], ids=["no shared", "shared"])
@pytest.mark.parametrize("K", [1, 2])
def test_moe_block_matches_reference(K, shared, cf):
    ref_cfg, cfg, p, mod = _pair(top_k=K, shared_expert_ff=shared, capacity_factor=cf)
    x = _x(3, 20, 32, seed=5)
    want, want_aux = moe_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x), ref_cfg)
    with recording(mod) as calls:
        got, aux = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=ROUTE_TOL)
    gates, eidx = _ref_routes(x.reshape(60, 32), p, ref_cfg)
    cap = int(max(K, 60 * K * cf / 8))  # the reference's capacity, written out
    assert capacity(60, cfg) == cap
    want_drops = int((np.asarray(_fill_slots(jnp.asarray(eidx), jnp.asarray(gates), cap, 8)[3])
                      == 0).sum())
    assert len(calls) == 1 and int(calls[0].dropped) == want_drops
    own = route(torch.from_numpy(x).reshape(60, 32), mod.router, K)
    assert torch.equal(calls[0].eidx, own[1]) and torch.equal(calls[0].probs, own[2])
    if cf < 1:
        assert want_drops > 0


def test_moe_block_at_one_token_a_sequence():
    """Decode's shape: T = B tokens.  llama4-maverick's capacity there is
    max(K, 4 * 1.25 / 128) = 1 slot an expert, so tokens that choose one
    expert drop all but the first."""
    ref_cfg, cfg, p, mod = _pair(top_k=1, n_experts=128, shared_expert_ff=40)
    assert capacity(4, MoEConfig(5120, 8192, 128, 1)) == 1
    assert capacity(2560, MoEConfig(4096, 1536, 128, 8)) == 200
    x = _x(64, 1, 32, seed=6)
    want, want_aux = moe_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x), ref_cfg)
    got, aux = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=ROUTE_TOL)


def test_expert_groups_give_the_same_bits(monkeypatch):
    """The expert SwiGLU in groups of experts (EXPERT_CHUNK_ELEMS) equals
    one group: each expert's products are its own."""
    from repro_torch.models import moe

    _, _, p, mod = _pair()
    buf = torch.from_numpy(_x(8, 5, 32, seed=7))
    whole = expert_mlp(buf, mod.e_gate, mod.e_up, mod.e_down)
    monkeypatch.setattr(moe, "EXPERT_CHUNK_ELEMS", 5 * 48 * 3)
    assert torch.equal(expert_mlp(buf, mod.e_gate, mod.e_up, mod.e_down), whole)
    with torch.no_grad():  # in place, over buf's own rows
        mine = buf.clone()
        got = expert_mlp(mine, mod.e_gate, mod.e_up, mod.e_down)
    assert got.data_ptr() == mine.data_ptr() and torch.equal(got, whole)


def test_moe_init_follows_the_reference_distributions():
    """dense_init: the router's fan-in D; the experts' fan-in on axis 1 (D
    for gate and up, F for down); the shared expert an MLP's."""
    cfg = MoEConfig(d_model=256, d_ff=512, n_experts=8, top_k=2, shared_expert_ff=384)
    mod = MoE(cfg)
    gen = torch.Generator().manual_seed(0)
    mod.reset_parameters(gen)
    for w, fan in ((mod.router, 256), (mod.e_gate, 256), (mod.e_up, 256), (mod.e_down, 512),
                   (mod.shared.w_gate, 256), (mod.shared.w_down, 384)):
        assert abs(float(w.std()) * np.sqrt(fan) - 1.0) < 0.05
    assert mod.shared.activation == "silu" and mod.shared.w_gate is not None


def test_recording_collects_each_layer_and_nests():
    _, _, p, mod = _pair(capacity_factor=0.25)
    x = torch.from_numpy(_x(2, 10, 32, seed=8))
    with recording(mod) as outer:
        mod(x)
        with recording(mod) as inner:
            mod(x)
            mod(x)
        mod(x)
    assert len(outer) == 2 and len(inner) == 2
    assert int(outer[0].dropped) == int(inner[0].dropped) == int(inner[1].dropped) > 0
    want = route(x.reshape(20, 32), torch.from_numpy(p["router"]), 2)
    for rec in (outer[0], outer[1], inner[0]):  # the outer block collects again after
        assert torch.equal(rec.eidx, want[1]) and torch.equal(rec.probs, want[2])
    mod(x)  # outside any block: nothing collects
    assert len(outer) == 2


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_count_matches_reference(arch):
    """At smoke size on the weights, and at full size from the shapes alone
    (the port's LM on the meta device, the reference's `init_model` under
    `jax.eval_shape`): qwen3-moe 235B, llama4-maverick 400B as named."""
    ref_cfg, cfg = REF_ARCHS[arch].smoke(), ARCHS[arch].smoke()
    params = ref_api.init_model(jax.random.key(0), ref_cfg)
    assert param_count(init_model(cfg, device="cpu")) == ref_api.param_count(params)
    full = ARCHS[arch]
    shapes = jax.eval_shape(lambda k: ref_api.init_model(k, REF_ARCHS[arch]), jax.random.key(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    got = param_count(LM(full, device="meta"))
    assert got == want
    billions = {"qwen3-moe-235b-a22b": 235, "llama4-maverick-400b-a17b": 400}[arch]
    assert abs(got / 1e9 - billions) / billions < 0.15, got


# the MoE models' decode-vs-forward limits (chip_smoke.py, phase lm_moe) are
# derived from the reference at the depth the card runs (LM_MOE) with all
# 128 experts and the config's K, at capacity_factor E / K, over these
# widths (d_model; expert F and the shared expert at the config's F / D;
# head_dim d_model / 4), and held to at least GAP_MARGIN times the larger of
# the widest reading and the fit's extrapolation to the full width
MOE_GAP_WIDTHS = (128, 256, 512)
GAP_MARGIN = 8


def _moe_at_width(cfg, width: int, depth: int):
    full = dataclasses.replace(cfg, n_layers=depth, repeats=depth // len(cfg.pattern))
    ff = max(8, round(width * cfg.d_ff / cfg.d_model))
    return dataclasses.replace(
        full.smoke(), repeats=full.repeats, n_layers=depth, d_model=width, d_ff=ff,
        head_dim=min(width // 4, 256), n_experts=cfg.n_experts, moe_top_k=cfg.moe_top_k,
        capacity_factor=cfg.n_experts / cfg.moe_top_k,
        shared_expert_ff=ff if cfg.shared_expert_ff else 0)


def _per_layer(recs: list, n: int, rows: int, dim: int):
    """Each MoE layer's (eidx, probs) over the calls in `recs` (n layers a
    call, in layer order), (rows, -1, K / E) a call, joined along `dim`."""
    return [tuple(torch.cat([torch.as_tensor(np.asarray(r[f])).reshape(rows, -1, r[f].shape[-1])
                             for r in recs[l::n]], dim) for f in (0, 1)) for l in range(n)]


def _reference_moe_gap(ref_cfg, toks: np.ndarray, prompt: int, log: list, replay: list, smoke):
    """The reference's unembed(forward), then its teacher-forced decode with
    the forward's expert choices replayed (the patched `_route` records into
    `log` and, while `replay` holds them, takes them from it), through
    chip_smoke's `moe_replay_gap`; and its parameters."""
    B, L = toks.shape
    n = ref_cfg.pattern.count("moe") * ref_cfg.repeats
    params = ref_api.init_model(jax.random.key(0), ref_cfg)
    log.clear()
    hidden, _ = jax.jit(lambda p, t: ref_lm.forward(p, t, ref_cfg))(params, jnp.asarray(toks))
    jax.effects_barrier()
    forward = np.asarray(ref_lm.unembed(ref_cfg, params, hidden))[:, prompt - 1:]
    fwd = _per_layer(list(log), n, B, 1)
    replay[:] = [np.asarray(e, np.int32) for e in
                 smoke.replay_order([e.numpy() for e, _ in fwd], prompt, per_sequence=False)]
    log.clear()
    logits, caches = jax.jit(lambda p, t: ref_api.prefill(p, {"tokens": t}, ref_cfg, L))(
        params, jnp.asarray(toks[:, :prompt]))
    step = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, ref_cfg))
    out = [np.asarray(logits)]
    for i in range(prompt, L):
        logits, caches = step(params, jnp.asarray(toks[:, i:i + 1]), caches)
        out.append(np.asarray(logits))
    jax.effects_barrier()
    assert not replay  # every call took its replayed choice
    res = smoke.moe_replay_gap(torch.from_numpy(np.stack(out, 1)), torch.from_numpy(forward),
                               _per_layer(list(log), n, B, 1), fwd)
    return res, params


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reference_moe_decode_gap_is_under_the_card_tolerance(arch, monkeypatch):
    """chip_smoke.py holds each MoE model's teacher-forced decode logits, at
    full width and the depth it runs, to unembed(forward) at capacity_factor
    E / K over every position, the forward's expert choices replayed in
    decode, within DECODE_VS_FORWARD_TOL[arch], and the router's
    perturbation within MOE_ROUTE_TOL[arch] (`moe_replay_gap`).  Here the
    reference's own readings at that depth over MOE_GAP_WIDTHS, its routes
    replayed the same way, fitted in log-log and extrapolated to the full
    width: GAP_MARGIN times the larger of the extrapolation and the largest
    reading is within each limit.  And the port's readings at the first
    width (its plain versions, its own forward, `moe_replay`) are within
    them too."""
    import repro.models.moe as ref_moe
    from jax.experimental import io_callback

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as smoke
    finally:
        sys.path.remove(str(ROOT))
    log: list = []
    replay: list = []
    route_fn = ref_moe._route

    def recorded_route(xt, router, cfg):
        """The reference's `_route`, or with `replay` set when traced, its
        formulas at the next replayed expert ids."""
        probs = jax.nn.softmax(xt.astype(jnp.float32) @ router, axis=-1)
        if replay:
            eidx = io_callback(lambda: replay.pop(0),
                               jax.ShapeDtypeStruct((xt.shape[0], cfg.top_k), jnp.int32),
                               ordered=True)
            gates = jnp.take_along_axis(probs, eidx, axis=1)
            gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
            frac_t = jnp.mean(jax.nn.one_hot(eidx[:, 0], cfg.n_experts, dtype=jnp.float32), 0)
            out = (gates, eidx, frac_t, jnp.mean(probs, axis=0))
        else:
            out = route_fn(xt, router, cfg)
        jax.debug.callback(lambda e, p: log.append((np.asarray(e), np.asarray(p))), out[1],
                           probs, ordered=True)
        return out

    monkeypatch.setattr(ref_moe, "_route", recorded_route)
    prompt, steps, depth = 24, 16, smoke.LM_MOE[arch]
    full = REF_ARCHS[arch]
    toks = np.random.default_rng(0).integers(0, full.smoke().vocab,
                                             (4, prompt + steps)).astype(np.int32)
    readings = []
    for width in MOE_GAP_WIDTHS:
        res, params = _reference_moe_gap(_moe_at_width(full, width, depth), toks, prompt, log,
                                         replay, smoke)
        assert res["replayed"] and res["flip_tie_over_bound"] <= 1.0 + smoke.FLIP_BOUND_SLACK
        readings.append((res["gap"], res["route_perturbation"]))
        if width == MOE_GAP_WIDTHS[0]:
            first_params = params
    assert all(g > 0 and e > 0 for g, e in readings), readings
    limits = (smoke.DECODE_VS_FORWARD_TOL[arch], smoke.MOE_ROUTE_TOL[arch])
    for i, limit in enumerate(limits):
        vals = [r[i] for r in readings]
        slope, icpt = np.polyfit(np.log(MOE_GAP_WIDTHS), np.log(vals), 1)
        predicted = max(max(vals), float(np.exp(icpt + slope * np.log(full.d_model))))
        assert GAP_MARGIN * predicted <= limit, (i, vals, slope, predicted)

    cfg = _moe_at_width(ARCHS[arch], MOE_GAP_WIDTHS[0], depth)
    model = params_from_reference(cfg, jax.tree.map(np.asarray, first_params), "cpu")
    n = cfg.pattern.count("moe") * cfg.repeats
    with torch.no_grad(), recording(model) as fwd:
        forward = model.unembed(model(torch.from_numpy(toks).long()))[:, prompt - 1:]
    fwd = _per_layer([(r.eidx.numpy(), r.probs.numpy()) for r in fwd], n, 4, 1)
    order = smoke.replay_order([e for e, _ in fwd], prompt, per_sequence=False)
    with smoke.moe_replay(order), recording(model) as dec:
        logits, caches = prefill(model, {"tokens": toks[:, :prompt]}, prompt + steps)
        out = [logits]
        for i in range(prompt, prompt + steps):
            logits, caches = decode_step(model, toks[:, i:i + 1], caches)
            out.append(logits)
    assert len(dec) == len(order)
    port = smoke.moe_replay_gap(torch.stack(out, 1), forward,
                                _per_layer([(r.eidx.numpy(), r.probs.numpy()) for r in dec],
                                           n, 4, 1), fwd)
    assert port["replayed"] and port["flip_tie_over_bound"] <= 1.0 + smoke.FLIP_BOUND_SLACK
    assert port["gap"] <= limits[0] and port["route_perturbation"] <= limits[1], port
