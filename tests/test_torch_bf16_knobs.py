"""Port parity for the bf16 activation knobs (`attn_bf16_probs`,
`ssm_bf16_acts` with `ssm_fused_chunks`) against the JAX package, on the
CPU at small sizes, inputs from a seeded numpy generator (the CUDA kernels'
bf16 forms are held to these plain versions in
tests/test_torch_kernels_cuda.py and chip_smoke.py):

  (a) `ssm_scan` fed bf16 dt, x, B, C against the reference's
      `_mamba1_fused` fed the same bf16 values, at rtol = atol = 1e-5 (the
      same rounded inputs, float32 after); the gradients of the bf16
      inputs come back bf16 in both, within one bf16 step of each other;
  (b) `Mamba1` with the knob against `mamba1_block(fused=True,
      bf16_acts=True)` (forward and prefill) and a decode step against
      `mamba1_decode`, which never rounds (nor does the port's);
  (c) the plain `flash_attention(bf16_probs=True)` against
      `chunked_attention(bf16_probs=True)`: where the keys fit one chunk,
      the mean gap at most KNOB_SHARE of the knob's own mean gap (the
      port rounds where the reference rounds); at kv_chunk 16 under 64
      keys (the reference rounds each chunk's sum, the port once) within
      2x the knob's largest gap; the gradients likewise;
  (d) the smoke LM's loss of gemma-2b, zamba2-7b, qwen2-vl-7b and
      falcon-mamba-7b with the knobs on, and one float32 train step's loss
      and gradient norm, within MODEL_SHARE of the reference's knob gap;
  (e) prefill and decode with the knobs on against the reference's,
      likewise;
  (f) whisper-tiny, whose reference ignores the knob, unchanged by it in
      both packages.

The knob's gap is |reference with the knob - reference without it| on the
same inputs: a port that skipped the rounding would sit a whole gap away."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode import _bf16_step
from test_torch_models import _set, _x
from torch_train_cases import batch, ref_state, ref_step, to_port

from repro.configs import ARCHS as REF_ARCHS
from repro.models import api as ref_api
from repro.models.attention import chunked_attention
from repro.models.ssm import Mamba1Config as RefMamba1Config
from repro.models.ssm import _mamba1_fused, init_mamba1, mamba1_block, mamba1_decode
from repro_torch.configs import ARCHS
from repro_torch.kernels import common
from repro_torch.kernels.flash_attn import (flash_attention, flash_attention_bf16_tiles_ref,
                                            flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models import decode_step, loss_fn, params_from_reference, prefill
from repro_torch.models.ssm import Mamba1, Mamba1Config
from repro_torch.train import make_train_step

torch.set_num_threads(2)

SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
# the share of the knob's own gap that the port may sit from the reference
# with the knob on: both round at the same places, so what is left is
# float32 summation order (and a rare rounding flipped by it)
KNOB_SHARE = 0.01
# the same at the smoke models' outputs (losses, logits): there the knob
# moves a loss of ~6 by 3e-5 to 3e-4, a few dozen float32 steps, and the
# float32 order of two packages' sums alone moves it by a few (up to 7 %
# of the gap seen)
MODEL_SHARE = 0.25
KNOB_ARCHS = ("gemma-2b", "zamba2-7b", "qwen2-vl-7b", "falcon-mamba-7b")


def knobs_on(cfg):
    """cfg with the bf16 activation knobs on (Mamba-1's through its fused
    path, as the reference reads it)."""
    return dataclasses.replace(cfg, attn_bf16_probs=True, ssm_fused_chunks=True,
                               ssm_bf16_acts=True)


def _assert_share_of_gap(got, on, off, share: float = KNOB_SHARE) -> None:
    """mean |got - on| within `share` of the knob's mean gap |on - off|,
    which must not be 0 (the knob acted)."""
    got, on, off = (np.asarray(a, np.float64) for a in (got, on, off))
    gap = float(np.abs(on - off).mean())
    assert gap > 0.0
    assert float(np.abs(got - on).mean()) <= share * gap, (np.abs(got - on).mean(), gap)


# -- (a) the scan's bf16 form -------------------------------------------------


def _scan_inputs(B, L, D, N, seed):
    rng = np.random.default_rng(seed)
    dt = np.abs(rng.normal(size=(B, L, D))).astype(np.float32) * 0.1
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    Bc = rng.normal(size=(B, L, N)).astype(np.float32)
    Cc = rng.normal(size=(B, L, N)).astype(np.float32)
    A = -np.abs(rng.normal(size=(D, N))).astype(np.float32)
    h0 = rng.normal(size=(B, D, N)).astype(np.float32)
    return dt, x, Bc, Cc, A, h0


@pytest.mark.parametrize("B,L,D,N", [(2, 37, 24, 16), (3, 8, 40, 4)])
def test_scan_bf16_form_matches_reference_fused(B, L, D, N):
    dt, x, Bc, Cc, A, h0 = _scan_inputs(B, L, D, N, B * L)
    acts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (dt, x, Bc, Cc)]
    before = common.launch_counts()
    y, h = ssm_scan(*acts, torch.from_numpy(A), torch.from_numpy(h0), seq_chunk=16)
    assert common.launch_counts() == before  # CPU: the plain version
    assert y.dtype == h.dtype == torch.float32
    j_acts = [jnp.asarray(a, jnp.bfloat16) for a in (dt, x, Bc, Cc)]
    # the same rounded bits in both packages
    for t, j in zip(acts, j_acts):
        assert np.array_equal(t.detach().float().numpy(), np.asarray(j, np.float32))
    f = lambda a, b, c, d: _mamba1_fused(a, b, c, d, jnp.asarray(A), jnp.asarray(h0), 8)
    (y_r, h_r), vjp = jax.vjp(f, *j_acts)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_r), **SCAN_TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_r), **SCAN_TOL)
    # the gradients: bf16 in both, the float32 sums rounded once
    rng = np.random.default_rng(1)
    dy = rng.normal(size=y.shape).astype(np.float32)
    dh = rng.normal(size=h.shape).astype(np.float32)
    torch.autograd.backward((y, h), (torch.from_numpy(dy), torch.from_numpy(dh)))
    for t, g in zip(acts, vjp((jnp.asarray(dy), jnp.asarray(dh)))):
        assert t.grad.dtype == torch.bfloat16 and g.dtype == jnp.bfloat16
        a, b = t.grad.float(), torch.from_numpy(np.asarray(g, np.float32))
        bound = _bf16_step(torch.maximum(a.abs(), b.abs())) + 1e-5 * b.abs() + 1e-6
        assert bool(((a - b).abs() <= bound).all())


@pytest.mark.parametrize("which,named", [("A", "A"), ("h0", "h0"), ("x", "dt")])
def test_scan_refuses_a_mixed_bf16_set(which, named):
    """The bf16 form takes dt, x, B, C in bf16 and A, h0 float32, and nothing
    else: with the four in bf16, a bf16 A or h0 raises naming it; with x
    left float32 among them, float32 is asked of each, and dt raises."""
    names = ("dt", "x", "Bc", "Cc", "A", "h0")
    args = [torch.from_numpy(a) for a in _scan_inputs(2, 5, 8, 4, 0)]
    for i in range(4):
        args[i] = args[i].to(torch.bfloat16)
    i = names.index(which)
    args[i] = args[i].to(torch.float32 if which == "x" else torch.bfloat16)
    with pytest.raises(TypeError, match=rf"^{named}: dtype torch.bfloat16"):
        ssm_scan(*args)


# -- (b) Mamba-1 with the knob --------------------------------------------------

M1 = dict(d_model=32, d_inner=64, d_state=16, dt_rank=8, d_conv=4)


@functools.lru_cache(maxsize=None)
def _mamba1():
    p = jax.tree.map(np.asarray, init_mamba1(jax.random.key(3), RefMamba1Config(**M1)))
    rng = np.random.default_rng(4)
    p = dict(p, conv_b=rng.normal(size=64).astype(np.float32) * 0.1,
             dt_bias=rng.normal(size=64).astype(np.float32) * 0.1,
             D=rng.normal(size=64).astype(np.float32))
    mods = []
    for bf16 in (False, True):
        mod = Mamba1(Mamba1Config(**M1), bf16_acts=bf16)
        _set(mod, p)
        mods.append(mod)
    return p, mods


def test_mamba1_forward_and_prefill_round_as_the_reference():
    p, (off, on) = _mamba1()
    jp, rcfg = jax.tree.map(jnp.asarray, p), RefMamba1Config(**M1)
    x = _x(3, 19, 32, seed=2)
    want_off = mamba1_block(jp, jnp.asarray(x), rcfg, chunk=8, fused=True)
    want, want_cache = mamba1_block(jp, jnp.asarray(x), rcfg, chunk=8, fused=True,
                                    bf16_acts=True, return_cache=True)
    with torch.no_grad():
        got = on(torch.from_numpy(x))
        got_pre, cache = on.prefill(torch.from_numpy(x))
    assert torch.equal(got, got_pre)
    _assert_share_of_gap(got.numpy(), want, want_off)
    np.testing.assert_allclose(cache.state.numpy(), np.asarray(want_cache.state), rtol=1e-3,
                               atol=1e-4)
    assert cache.length == 19


def test_mamba1_decode_step_never_rounds():
    """A decode step scans in float32 with the knob on, as the reference's
    `mamba1_decode` does: the port's step with the knob equals its step
    without it bit for bit, and the reference's step from the same cache."""
    p, (off, on) = _mamba1()
    jp, rcfg = jax.tree.map(jnp.asarray, p), RefMamba1Config(**M1)
    x = _x(3, 19, 32, seed=2)
    step = _x(3, 1, 32, seed=5)
    _, ref_cache = mamba1_block(jp, jnp.asarray(x), rcfg, chunk=8, fused=True, bf16_acts=True,
                                return_cache=True)
    with torch.no_grad():
        _, cache = on.prefill(torch.from_numpy(x))
        cache = cache._replace(conv_tail=torch.from_numpy(np.asarray(ref_cache.conv_tail)),
                               state=torch.from_numpy(np.asarray(ref_cache.state)))
        before = common.launch_counts()
        got, new = on.decode(torch.from_numpy(step), cache)
        plain, _ = off.decode(torch.from_numpy(step), cache)
    assert common.launch_counts() == before
    assert torch.equal(got, plain)
    want, want_cache = mamba1_decode(jp, jnp.asarray(step), rcfg, ref_cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(new.state.numpy(), np.asarray(want_cache.state), rtol=1e-4,
                               atol=1e-5)


# -- (c) the plain attention's bf16-P function ---------------------------------

ATTN_CASES = {
    "causal": dict(B=2, S=24, Hq=4, Hkv=2, dh=16, kw=dict(causal=True)),
    "window softcap": dict(B=2, S=24, Hq=4, Hkv=1, dh=32,
                           kw=dict(causal=True, window=8, softcap=5.0)),
    "not causal": dict(B=1, S=20, Hq=2, Hkv=2, dh=16, kw=dict(causal=False)),
}


def _attn_inputs(B, S, Hq, Hkv, dh, seed, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    q = rng.normal(size=(B, S, Hq, dh)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, dh)).astype(np.float32)
    do = rng.normal(size=(B, S, Hq, dh)).astype(np.float32)
    return q, k, v, do


def _reference(q, k, v, do, kw, kv_chunk, bf16):
    """The reference's attention and its gradients (jax.vjp), the ends
    aligned."""
    f = lambda a, b, c: chunked_attention(a, b, c, q_offset=k.shape[1] - q.shape[1],
                                          kv_chunk=kv_chunk, bf16_probs=bf16, **kw)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port(q, k, v, do, kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ts, bf16_probs=True, **kw)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_plain_bf16_probs_rounds_where_the_reference_rounds(name):
    """Keys within one chunk: the same function, forward and gradients."""
    c = ATTN_CASES[name]
    q, k, v, do = _attn_inputs(c["B"], c["S"], c["Hq"], c["Hkv"], c["dh"], seed=len(name))
    out, grads = _port(q, k, v, do, c["kw"])
    on, on_g = _reference(q, k, v, do, c["kw"], 1024, True)
    off, off_g = _reference(q, k, v, do, c["kw"], 1024, False)
    _assert_share_of_gap(out, on, off)
    for got, want, plain in zip(grads, on_g, off_g):
        _assert_share_of_gap(got, want, plain)


def test_plain_bf16_probs_across_reference_chunks():
    """kv_chunk 16 under 64 keys: the reference rounds each chunk's sum, the
    port once; within 2x the knob's largest gap, forward and gradients."""
    q, k, v, do = _attn_inputs(2, 64, 4, 2, 16, seed=3)
    kw = dict(causal=True)
    out, grads = _port(q, k, v, do, kw)
    on, on_g = _reference(q, k, v, do, kw, 16, True)
    off, off_g = _reference(q, k, v, do, kw, 16, False)
    for got, want, plain in ((out, on, off), *zip(grads, on_g, off_g)):
        assert np.abs(got - want).max() <= 2 * np.abs(want - plain).max()


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_bwd_ref_bf16_probs_within_the_knob_gap(name):
    """The bf16-P backward kernel's formulas (`flash_attention_bwd_ref`,
    rounding the normalised P and dO, each rounding's derivative 1) against
    autograd of the plain forward: within 2x the knob's largest gap."""
    c = ATTN_CASES[name]
    q, k, v, do = _attn_inputs(c["B"], c["S"], c["Hq"], c["Hkv"], c["dh"], seed=len(name))
    _, grads = _port(q, k, v, do, c["kw"])
    _, off_g = _reference(q, k, v, do, c["kw"], 1024, False)
    ts = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = flash_attention_ref(*ts[:3], return_lse=True, bf16_probs=True, **c["kw"])
    kern = flash_attention_bwd_ref(*ts[:3], o, lse, ts[3], bf16_probs=True, **c["kw"])
    plain = flash_attention_bwd_ref(*ts[:3], *flash_attention_ref(*ts[:3], return_lse=True,
                                                                  **c["kw"]), ts[3], **c["kw"])
    for got, want, p32, ref32 in zip(kern, grads, plain, off_g):
        np.testing.assert_allclose(p32.numpy(), ref32, rtol=1e-4, atol=1e-5)
        assert not torch.equal(got, p32)
        assert np.abs(got.numpy() - want).max() <= 2 * np.abs(want - ref32).max()


# -- the card kernel's bf16-P walk: the plain mirror of its key tiles ---------
#
# The bf16-P kernel rounds each key tile's p against the running max and
# rescales; `flash_attention_bf16_tiles_ref` walks the same tiles in plain
# torch, and the card tests and chip_smoke.py hold the kernel's mean gap from
# it to KNOB_MIRROR_FACTOR of the knob's mean gap.  These tests check the
# mirror's walk and show the gate's margins: the scores moved by 1e-6 of
# themselves (3xTF32 products against float32 sums) stay well under it, and
# the functions a kernel could compute by mistake lie far above it.

KNOB_MIRROR_FACTOR = 0.02  # chip_smoke.py's and tests/test_torch_kernels_cuda.py's
MIRROR_CASES = {  # tiles: (rows a block, keys a tile) as the kernel's two launch shapes
    "gemma-2b serving heads, short tiles": dict(B=4, S=32, Hq=8, Hkv=1, dh=256,
                                               kw=dict(causal=True), tiles=(32, 16)),
    "GQA, long tiles": dict(B=2, S=200, Hq=8, Hkv=2, dh=128, kw=dict(causal=True),
                            tiles=(128, 32)),
    "window softcap": dict(B=2, S=200, Hq=4, Hkv=1, dh=64,
                           kw=dict(causal=True, window=64, softcap=50.0), tiles=(32, 16)),
    "not causal, dh 112": dict(B=2, S=100, Hq=4, Hkv=4, dh=112, kw=dict(causal=False),
                               tiles=(32, 16)),
}


def _mirror_case(name, seed=0):
    c = MIRROR_CASES[name]
    q, k, v, _ = _attn_inputs(c["B"], c["S"], c["Hq"], c["Hkv"], c["dh"], seed=seed)
    kw = dict(dict(window=0, softcap=0.0), **c["kw"])
    return [torch.from_numpy(a) for a in (q, k, v)], kw, c["tiles"]


def _rounded(q, k, v, kw, p: bool, vv: bool, acc: bool):
    """The row-max attention with any of its three roundings (bf16 P, V, the
    product's sum) taken or left out."""
    from repro_torch.kernels.flash_attn.ref import _bf16, _scores

    B, Sq, Hq, dh = q.shape
    z, _, _, _, _ = _scores(q, k, kw["causal"], kw["window"], kw["softcap"])
    m = z.amax(dim=-1, keepdim=True)
    e = torch.exp(z - torch.where(torch.isneginf(m), torch.zeros_like(m), m))
    l = e.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
    pv = torch.einsum("bhgst,bthd->bshgd", _bf16(e) if p else e, _bf16(v) if vv else v)
    return ((_bf16(pv) if acc else pv) / torch.clamp(l, min=1e-30)).reshape(B, Sq, Hq, dh)


def _mean_share(got, mirror, on, off) -> float:
    return float((got - mirror).abs().mean()) / float((on - off).abs().mean())


@pytest.mark.parametrize("name", list(MIRROR_CASES))
def test_tile_mirror_with_one_tile_is_the_plain_knob(name):
    """One tile over every key is the row-max function of the plain knob."""
    (q, k, v), kw, (rows, _) = _mirror_case(name)
    one = flash_attention_bf16_tiles_ref(q, k, v, block_rows=rows, key_tile=1 << 20, **kw)
    _assert_share_of_gap(one, flash_attention_ref(q, k, v, bf16_probs=True, **kw),
                         flash_attention_ref(q, k, v, **kw))


@pytest.mark.parametrize("name", list(MIRROR_CASES))
def test_tile_mirror_gate_tells_the_knob_from_its_near_misses(name):
    (q, k, v), kw, (rows, keys) = _mirror_case(name)
    mirror = flash_attention_bf16_tiles_ref(q, k, v, block_rows=rows, key_tile=keys, **kw)
    on = flash_attention_ref(q, k, v, bf16_probs=True, **kw)
    off = flash_attention_ref(q, k, v, **kw)
    g = torch.Generator().manual_seed(len(name))
    moved = [t * (1 + 1e-6 * torch.randn(t.shape, generator=g)) for t in (q, k)]
    near = flash_attention_bf16_tiles_ref(*moved, v, block_rows=rows, key_tile=keys, **kw)
    assert _mean_share(near, mirror, on, off) <= KNOB_MIRROR_FACTOR / 2
    for rounds in ((0, 0, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1)):
        miss = _rounded(q, k, v, kw, *rounds)
        assert _mean_share(miss, mirror, on, off) >= 10 * KNOB_MIRROR_FACTOR, rounds


def _walk_one_row_at_a_time(q, k, v, kw, rows, keys):
    """The kernel's walk written row by row: the row's block, its first key,
    each tile's max, p, the rescaled l and accumulator."""
    from repro_torch.kernels.flash_attn.ref import LOG2E, _bf16, _scores

    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    x = _scores(q, k, kw["causal"], kw["window"], kw["softcap"])[0] * LOG2E
    out = torch.zeros((B, Sq, Hq, dh))
    for b in range(B):
        for h in range(Hkv):
            for i in range(Sq):
                for gi in range(G):
                    r0 = (i * G + gi) // rows * rows
                    lo = max(0, r0 // G + Skv - Sq - kw["window"] + 1) if kw["window"] else 0
                    m, l, acc = float("-inf"), torch.zeros(()), torch.zeros(dh)
                    for j0 in range(lo, Skv, keys):
                        xt = x[b, h, gi, i, j0:j0 + keys]
                        m_new = max(m, float(xt.max()))
                        m_use = 0.0 if m_new == float("-inf") else m_new
                        alpha = torch.exp2(torch.tensor(m - m_use))
                        p = torch.exp2(xt - m_use)
                        l = l * alpha + p.sum()
                        acc = acc * alpha + _bf16(p) @ _bf16(v[b, j0:j0 + keys, h])
                        m = m_new
                    out[b, i, h * G + gi] = _bf16(acc) / torch.clamp(l, min=1e-30)
    return out


@pytest.mark.parametrize("kw", [dict(causal=True, window=12, softcap=0.0),
                                dict(causal=False, window=0, softcap=3.0)])
def test_tile_mirror_is_the_walk_row_by_row(kw):
    """Blocks of 8 rows, tiles of 4 keys, G 2 (a block's rows span 4
    queries), a window that moves each block's first key."""
    q, k, v, _ = _attn_inputs(2, 19, 4, 2, 8, seed=7, Skv=23)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_attention_bf16_tiles_ref(q, k, v, block_rows=8, key_tile=4, **kw)
    want = _walk_one_row_at_a_time(q, k, v, kw, 8, 4)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


# -- (d) / (e) / (f) the models -------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    """The reference's smoke config and weights, and the port's model with
    those weights, with the knobs off and on."""
    ref_cfg, cfg = REF_ARCHS[arch].smoke(), ARCHS[arch].smoke()
    params = ref_api.init_model(jax.random.key(0), ref_cfg)
    p_np = jax.tree.map(np.asarray, params)
    return dict(ref_off=ref_cfg, ref_on=knobs_on(ref_cfg), params=params,
                off=params_from_reference(cfg, p_np, "cpu"),
                on=params_from_reference(knobs_on(cfg), p_np, "cpu"))


def _lm_batch(cfg, step: int) -> dict:
    b = batch(cfg, step=step)
    if cfg.vlm:
        rng = np.random.default_rng(step)
        b["patch_embeds"] = rng.normal(size=(4, cfg.n_patches, cfg.d_model)).astype(np.float32)
        b["labels"] = np.concatenate(
            [np.zeros((4, cfg.n_patches), b["labels"].dtype), b["labels"]], axis=1)
        b["mask"] = np.concatenate([np.zeros((4, cfg.n_patches), np.float32), b["mask"]], axis=1)
    return b


@pytest.mark.parametrize("arch", KNOB_ARCHS)
def test_lm_loss_and_train_step_with_the_knobs(arch):
    m = _models(arch)
    ref_loss = {n: jax.jit(lambda p, b, c=m[f"ref_{n}"]: ref_api.loss_fn(p, b, c)[0])
                for n in ("on", "off")}
    losses = {k: [] for k in ("on", "off", "port")}
    for step in range(3):
        b = _lm_batch(m["off"].cfg, step)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        for n, f in ref_loss.items():
            losses[n].append(float(f(m["params"], jb)))
        with torch.no_grad():
            losses["port"].append(float(loss_fn(m["on"], b)[0]))
    _assert_share_of_gap(losses["port"], losses["on"], losses["off"], MODEL_SHARE)
    # one float32 train step: its loss and gradient norm
    b = _lm_batch(m["off"].cfg, 0)
    rs = ref_state(m["ref_off"])
    _, want = ref_step(m["ref_on"], rs, b, compute_dtype=jnp.float32)
    _, plain = ref_step(m["ref_off"], rs, b, compute_dtype=jnp.float32)
    _, got = make_train_step(m["on"].cfg, lambda s: 1e-3, compute_dtype=torch.float32)(
        to_port(m["on"].cfg, rs), b)
    for key in ("loss", "grad_norm"):
        _assert_share_of_gap([float(got[key])], [want[key]], [plain[key]], MODEL_SHARE)


@pytest.mark.parametrize("arch", ("gemma-2b", "falcon-mamba-7b"))
def test_prefill_and_decode_with_the_knobs(arch):
    """Prefill rounds (the knob), decode does not: the port's logits after
    prefill and after 3 decode steps within MODEL_SHARE of the reference's
    knob gap at each."""
    m = _models(arch)
    cfg = m["on"].cfg
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (3, 24)).astype(np.int32)
    run = {name: jax.jit(lambda p, t, c=m[name]: ref_api.prefill(p, {"tokens": t}, c, 32))
           for name in ("ref_on", "ref_off")}
    dec = {name: jax.jit(lambda p, t, cc, c=m[name]: ref_api.decode_step(p, t, cc, c))
           for name in ("ref_on", "ref_off")}
    want = {n: run[n](m["params"], jnp.asarray(toks[:, :20])) for n in run}
    with torch.no_grad():
        got, caches = prefill(m["on"], {"tokens": toks[:, :20]}, 32)
    _assert_share_of_gap(got.numpy(), want["ref_on"][0], want["ref_off"][0], MODEL_SHARE)
    for i in range(20, 23):
        t = toks[:, i:i + 1]
        want = {n: dec[n](m["params"], jnp.asarray(t), want[n][1]) for n in dec}
        with torch.no_grad():
            got, caches = decode_step(m["on"], t, caches)
        _assert_share_of_gap(got.numpy(), want["ref_on"][0], want["ref_off"][0], MODEL_SHARE)


def test_whisper_ignores_the_knobs():
    """The reference's whisper calls its attention without the knob: its loss
    with the knobs on is its loss without them, bit for bit, and so is the
    port's, which matches it."""
    m = _models("whisper-tiny")
    b = batch(m["off"].cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    ref_on = float(ref_api.loss_fn(m["params"], jb, m["ref_on"])[0])
    ref_off = float(ref_api.loss_fn(m["params"], jb, m["ref_off"])[0])
    with torch.no_grad():
        on, off = float(loss_fn(m["on"], b)[0]), float(loss_fn(m["off"], b)[0])
    assert ref_on == ref_off and on == off
    assert on == pytest.approx(ref_on, rel=1e-4)
