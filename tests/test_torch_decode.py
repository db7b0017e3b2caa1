"""Port parity for the LM's loss, prefill and decode (`repro_torch.models`
`loss_fn`, `prefill`, `init_caches`, `decode_step`, `caches_from_reference`)
against the JAX package's (`repro.models.api`: plain jnp, no Pallas kernel
on this path), at `smoke()` size with the reference's weights carried
across by `params_from_reference` and inputs from a seeded numpy generator.

Tolerances:
  * TOL, rtol 1e-4 / atol 1e-5: float32 in another summation order -- the
    loss, prefill's logits (its attention reads the float32 keys and
    values), the Mamba-1 conv tail and scan state, the Mamba-2 conv tail
    and state (zamba2-7b's within ZAMBA_TOL, 4 x TOL: its 13-layer smoke
    model turns rounding into more than TOL, tests/test_torch_zamba.py).
  * K and V caches: within one bf16 step (`_bf16_step`) plus TOL of each
    other: both round float32 values that are within TOL, so an entry near
    a rounding boundary lands one step apart (and near 0, where TOL's atol
    exceeds a step, the float32 difference shows).
  * decode logits, and the caches after decode steps: within BF16_REL
    (2^-8, one bf16 step relative) of the largest reference value (plus one
    bf16 step of the entry for K and V): a cache entry one step apart moves
    what later layers and steps compute by a small share of one step of its
    scale (the largest such move of the logits seen at these sizes, 1.3e-4
    on logits of 0.47, is a seventh of the bound).
  * decode against the forward at full depth: chip_smoke.py's
    DECODE_VS_FORWARD_TOL, which must be at least eight times the
    reference's own gap (its bf16 KV cache; falcon-mamba-7b's float32 state
    only reorders sums) at full width, extrapolated here from three widths
    (GAP_WIDTHS).
"""
import dataclasses
import functools
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import api as ref_api
from repro.models import lm as ref_lm
from repro_torch.configs import ARCHS, ModelConfig
from repro_torch.kernels import common
from repro_torch.models import (
    caches_from_reference,
    decode_step,
    init_caches,
    init_model,
    loss_fn,
    param_count,
    params_from_reference,
    prefill,
)
from repro_torch.models.attention import KVCache
from repro_torch.models.lm import layer_kinds
from repro_torch.models.ssm import SSMCache
from test_torch_zamba import ZAMBA_TOL

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_REL = 2.0 ** -8
DECODE_ARCHS = ("qwen2-7b", "gemma3-1b", "gemma-2b", "gemma2-9b", "falcon-mamba-7b",
                "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "zamba2-7b")
# the MoE layers' load-balancing loss: float32 means over another order
AUX_TOL = 1e-6
# a prompt longer than the smoke window (16), then 8 steps: decode crosses it
B, PROMPT, STEPS, MAX_LEN = 3, 24, 8, 40


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().to(torch.float32))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _assert_within_a_bf16_step(a: torch.Tensor, b: torch.Tensor) -> None:
    a, b = a.to(torch.float32), b.to(torch.float32)
    mag = torch.maximum(a.abs(), b.abs())
    bound = _bf16_step(mag) + TOL["atol"] + TOL["rtol"] * mag
    assert bool(((a - b).abs() <= bound).all()), float(((a - b).abs() / bound).max())


def _assert_decoded(got: torch.Tensor, want) -> None:
    """Within BF16_REL of the largest reference value."""
    want = np.asarray(want, dtype=np.float32)
    atol = BF16_REL * float(np.abs(want).max())
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=0, atol=atol)


def _assert_caches(cfg, got: list, want_np, decoded_from: int | None) -> None:
    """The port's caches against the reference's, unstacked by the same
    layer map (`caches_from_reference`): after prefill within a bf16 step
    (K, V) or TOL (conv tail, state).  After decode steps from position
    `decoded_from` (None: no step), K and V at the prompt's positions
    before it still within a bf16 step; at the decode positions, and the
    conv tail and state, within BF16_REL of the largest reference value
    (and, for K and V, one bf16 step more)."""
    want = caches_from_reference(cfg, want_np, "cpu")
    decoded = decoded_from is not None
    p = decoded_from if decoded else None
    assert len(got) == len(want) == cfg.n_layers
    for g, w in zip(got, want):
        assert type(g) is type(w) and g.length == w.length
        if isinstance(g, KVCache):
            assert g.k.dtype == g.v.dtype == torch.bfloat16
        for a, b in zip(g[:2], w[:2]):
            a, b = a.to(torch.float32), b.to(torch.float32)
            if isinstance(g, KVCache):
                _assert_within_a_bf16_step(a[:, :p], b[:, :p])
                if decoded:  # the drift, and a bf16 entry one step apart on top
                    a, b = a[:, p:], b[:, p:]
                    bound = BF16_REL * float(b.abs().max()) + _bf16_step(
                        torch.maximum(a.abs(), b.abs()))
                    assert bool(((a - b).abs() <= bound).all())
            elif decoded:
                assert bool(((a - b).abs() <= BF16_REL * float(b.abs().max())).all())
            else:
                torch.testing.assert_close(a, b, **(ZAMBA_TOL if cfg.name == "zamba2-7b"
                                                    else TOL))


@functools.lru_cache(maxsize=None)
def _setup(arch: str):
    """The reference's smoke model and its jitted prefill and decode, the
    port's model with the same weights, and the token streams."""
    ref_cfg, cfg = REF_ARCHS[arch].smoke(), ARCHS[arch].smoke()
    params = ref_api.init_model(jax.random.key(0), ref_cfg)
    model = params_from_reference(cfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, PROMPT + STEPS)).astype(np.int32)
    ref_prefill = jax.jit(lambda p, t: ref_api.prefill(p, {"tokens": t}, ref_cfg, MAX_LEN))
    ref_decode = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, ref_cfg))
    return SimpleNamespace(ref_cfg=ref_cfg, cfg=cfg, params=params, model=model, toks=toks,
                           ref_prefill=ref_prefill, ref_decode=ref_decode)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_loss_matches_reference(arch, masked):
    s = _setup(arch)
    rng = np.random.default_rng(11)
    batch = {"tokens": s.toks[:, :PROMPT],
             "labels": rng.integers(0, s.cfg.vocab, (B, PROMPT)).astype(np.int32)}
    if masked:
        batch["mask"] = (rng.random((B, PROMPT)) < 0.6).astype(np.float32)
    want, want_aux = ref_api.loss_fn(s.params, {k: jnp.asarray(v) for k, v in batch.items()},
                                     s.ref_cfg)
    got, aux = loss_fn(s.model, batch)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(float(aux["ce"]), float(want_aux["ce"]), **TOL)
    if s.cfg.n_experts:
        assert float(want_aux["aux"]) > 0.0
        np.testing.assert_allclose(float(aux["aux"]), float(want_aux["aux"]), rtol=0,
                                   atol=AUX_TOL)
    else:
        assert float(aux["aux"]) == float(want_aux["aux"]) == 0.0


def test_loss_with_an_empty_mask_is_zero():
    s = _setup("gemma-2b")
    batch = {"tokens": s.toks[:, :PROMPT], "labels": s.toks[:, 1:PROMPT + 1],
             "mask": np.zeros((B, PROMPT), np.float32)}
    want, _ = ref_api.loss_fn(s.params, {k: jnp.asarray(v) for k, v in batch.items()},
                              s.ref_cfg)
    got, _ = loss_fn(s.model, batch)
    assert float(got) == float(want) == 0.0


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_matches_reference(arch):
    s = _setup(arch)
    want, want_caches = s.ref_prefill(s.params, jnp.asarray(s.toks[:, :PROMPT]))
    before = common.launch_counts()
    got, caches = prefill(s.model, {"tokens": s.toks[:, :PROMPT]}, MAX_LEN)
    assert common.launch_counts() == before  # CPU tensors: the plain versions
    assert got.shape == (B, s.cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches(s.cfg, caches, jax.tree.map(np.asarray, want_caches), None)
    assert all(c.length == PROMPT for c in caches)


@pytest.mark.parametrize("from_reference", [False, True])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_reference(arch, from_reference):
    """8 teacher-forced steps after a 24-token prompt (past the smoke window
    of 16 and across it), from the port's own prefill or from the
    reference's prefill caches carried across."""
    s = _setup(arch)
    _, ref_caches = s.ref_prefill(s.params, jnp.asarray(s.toks[:, :PROMPT]))
    if from_reference:
        caches = caches_from_reference(s.cfg, jax.tree.map(np.asarray, ref_caches), "cpu")
    else:
        _, caches = prefill(s.model, {"tokens": s.toks[:, :PROMPT]}, MAX_LEN)
    for i in range(PROMPT, PROMPT + STEPS):
        token = s.toks[:, i:i + 1]
        want, ref_caches = s.ref_decode(s.params, jnp.asarray(token), ref_caches)
        got, caches = decode_step(s.model, token, caches)
        assert got.shape == (B, s.cfg.vocab_padded)
        _assert_decoded(got, want)
    _assert_caches(s.cfg, caches, jax.tree.map(np.asarray, ref_caches), PROMPT)
    assert all(c.length == PROMPT + STEPS for c in caches)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_init_caches_shapes_and_dtypes(arch):
    s = _setup(arch)
    caches = init_caches(s.cfg, 2, 12, device="cpu")
    want = jax.tree.map(np.asarray, ref_api.init_caches(s.ref_cfg, 2, 12))
    assert len(caches) == s.cfg.n_layers
    for kind, got, ref in zip(layer_kinds(s.cfg), caches,
                              caches_from_reference(s.cfg, want, "cpu")):
        assert type(got) is type(ref) and got.length == ref.length == 0
        for a, b in zip(got[:2], ref[:2]):
            assert a.shape == b.shape and a.dtype == b.dtype and not bool(a.any())
        if isinstance(got, SSMCache):
            assert got.state.dtype == torch.float32
            assert got.state.shape == ((2, s.cfg.ssm_d_inner, s.cfg.ssm_state) if kind == "m1"
                                       else (2, s.cfg.ssm_d_inner // s.cfg.ssm_head_dim,
                                             s.cfg.ssm_state, s.cfg.ssm_head_dim))
        else:
            assert got.k.shape == (2, 12, s.cfg.n_kv, s.cfg.head_dim)
    # a first token decoded against the empty caches, as the reference does
    token = s.toks[:2, :1]
    got, caches = decode_step(s.model, token, caches)
    want, want_caches = ref_api.decode_step(s.params, jnp.asarray(token),
                                            ref_api.init_caches(s.ref_cfg, 2, 12), s.ref_cfg)
    _assert_decoded(got, want)
    _assert_caches(s.cfg, caches, jax.tree.map(np.asarray, want_caches), 0)


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-7b"])
def test_enc_dec_and_vlm_raise(arch):
    cfg = ModelConfig(**dataclasses.asdict(REF_ARCHS[arch]).copy())
    stub = SimpleNamespace(cfg=cfg)
    for call in (lambda: init_caches(cfg, 1, 8, device="cpu"),
                 lambda: init_model(cfg, device="cpu"),
                 lambda: loss_fn(stub, {}),
                 lambda: prefill(stub, {}, 8),
                 lambda: decode_step(stub, None, [])):
        with pytest.raises(NotImplementedError, match="ROADMAP A11"):
            call()


def test_decode_refuses_a_full_cache_and_a_long_prompt():
    s = _setup("gemma-2b")
    with pytest.raises(ValueError, match="does not fit"):
        prefill(s.model, {"tokens": s.toks[:, :PROMPT]}, PROMPT - 1)
    _, caches = prefill(s.model, {"tokens": s.toks[:, :PROMPT]}, PROMPT)
    with pytest.raises(ValueError, match="full"):
        decode_step(s.model, s.toks[:, PROMPT:PROMPT + 1], caches)
    with pytest.raises(ValueError, match="caches"):
        decode_step(s.model, s.toks[:, PROMPT:PROMPT + 1], caches[:-1])
    # caches of two lengths: one position a step, so a mix is refused
    _, short = prefill(s.model, {"tokens": s.toks[:, :PROMPT - 1]}, PROMPT)
    with pytest.raises(ValueError, match="lengths"):
        decode_step(s.model, s.toks[:, PROMPT:PROMPT + 1], short[:1] + caches[1:])


def test_loss_refuses_per_token_positions():
    """Tokens sit at 0 .. S - 1; the reference's per-token positions (its
    VLM's) are not ported, so a batch that carries them is refused rather
    than read at the default positions."""
    s = _setup("gemma-2b")
    batch = {"tokens": s.toks[:, :PROMPT], "labels": s.toks[:, 1:PROMPT + 1],
             "positions": np.broadcast_to(np.arange(PROMPT), (B, PROMPT))}
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        loss_fn(s.model, batch)


def test_param_count_matches_reference():
    for arch in ("qwen2-7b", "falcon-mamba-7b", "zamba2-7b"):
        s = _setup(arch)
        assert param_count(s.model) == ref_api.param_count(s.params)


# the reference's decode-vs-forward gap is measured at full depth over a
# few widths, fitted as a power of the width and extrapolated to the full
# width: (widths, full width).  The width w widens a smoke config: an SSM's
# d_inner w, d_model w / 2, dt_rank max(8, w / 32); an attention model's
# d_model w, d_ff 2 w, head_dim min(w / 4, 256); a hybrid's as an attention
# model's, with d_inner 2 w at the config's own SSM heads, state and chunk
# (64, 64, 64: the card's).  The first is smoke width.
GAP_WIDTHS = {"qwen2-7b": ((64, 256, 1024), 3584), "gemma3-1b": ((64, 256, 1024), 1152),
              "falcon-mamba-7b": ((128, 512, 2048), 8192), "zamba2-7b": ((64, 256, 512), 3584)}
GAP_MARGIN = 8


def _full_depth(cfg, width: int):
    """`cfg` at its full depth, a smoke config widened to `width`."""
    small = cfg.smoke()
    if small.family == "ssm":
        wide = dict(d_model=width // 2, ssm_d_inner=width, ssm_dt_rank=max(8, width // 32))
    else:
        wide = dict(d_model=width, d_ff=2 * width, head_dim=min(width // 4, 256))
    if small.family == "hybrid":
        wide.update(ssm_d_inner=2 * width, ssm_head_dim=cfg.ssm_head_dim,
                    ssm_state=cfg.ssm_state, ssm_chunk=cfg.ssm_chunk)
    return dataclasses.replace(small, repeats=cfg.repeats, tail=cfg.tail,
                               n_layers=cfg.n_layers, **wide)


def _relative_gap(decoded: np.ndarray, forward: np.ndarray) -> float:
    return float(np.abs(decoded - forward).max() / np.abs(forward).max())


def _reference_gap(ref_cfg, toks: np.ndarray, prompt: int):
    """The reference's teacher-forced decode logits after `prompt` tokens of
    `toks` against `unembed(forward(toks))`, relative to the largest, and
    its parameters."""
    params = ref_api.init_model(jax.random.key(0), ref_cfg)
    logits, caches = jax.jit(lambda p, t: ref_api.prefill(p, {"tokens": t}, ref_cfg,
                                                          toks.shape[1]))(
        params, jnp.asarray(toks[:, :prompt]))
    step = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, ref_cfg))
    ref_out = [np.asarray(logits)]
    for i in range(prompt, toks.shape[1] - 1):
        logits, caches = step(params, jnp.asarray(toks[:, i:i + 1]), caches)
        ref_out.append(np.asarray(logits))
    hidden, _ = jax.jit(lambda p, t: ref_lm.forward(p, t, ref_cfg))(params, jnp.asarray(toks))
    forward = np.asarray(ref_lm.unembed(ref_cfg, params, hidden))[:, prompt - 1:-1]
    return _relative_gap(np.stack(ref_out, 1), forward), params


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma3-1b", "falcon-mamba-7b", "zamba2-7b"])
def test_reference_decode_gap_is_under_the_card_tolerance(arch):
    """chip_smoke.py holds teacher-forced decode logits at full width (at
    full depth, qwen2-7b at 7 layers) to `unembed(forward(...))` within
    DECODE_VS_FORWARD_TOL[arch], relative to the largest forward logit.
    Here the reference's own gap
    at full depth and the widths of GAP_WIDTHS, fitted in log-log and
    extrapolated to the full width: GAP_MARGIN times the larger of the
    extrapolation and the largest measured gap is within the tolerance.
    (falcon-mamba-7b's float32 reordering grows with the width, about as
    w^0.7 over 128-2048; the attention models' gap, the bf16 cache's
    rounding, does not.)  And the port's gap at smoke width (plain
    versions, against its own forward) is within the tolerance too."""
    sys.path.insert(0, str(ROOT))
    try:
        from chip_smoke import DECODE_VS_FORWARD_TOL
    finally:
        sys.path.remove(str(ROOT))
    prompt, steps = 24, 16
    widths, full = GAP_WIDTHS[arch]
    toks = np.random.default_rng(0).integers(0, ARCHS[arch].smoke().vocab,
                                             (4, prompt + steps)).astype(np.int32)
    gaps = []
    for width in widths:
        gap, params = _reference_gap(_full_depth(REF_ARCHS[arch], width), toks, prompt)
        gaps.append(gap)
        if width == widths[0]:
            smoke_params = params
    slope, icpt = np.polyfit(np.log(widths), np.log(gaps), 1)
    predicted = max(max(gaps), float(np.exp(icpt + slope * np.log(full))))
    assert GAP_MARGIN * predicted <= DECODE_VS_FORWARD_TOL[arch], (gaps, slope, predicted)

    cfg = _full_depth(ARCHS[arch], widths[0])
    model = params_from_reference(cfg, jax.tree.map(np.asarray, smoke_params), "cpu")
    logits, caches = prefill(model, {"tokens": toks[:, :prompt]}, prompt + steps)
    out = [logits]
    for i in range(prompt, prompt + steps - 1):
        logits, caches = decode_step(model, toks[:, i:i + 1], caches)
        out.append(logits)
    with torch.no_grad():
        port_forward = model.unembed(model(torch.from_numpy(toks).long()))[:, prompt - 1:-1]
    port_gap = _relative_gap(torch.stack(out, 1).numpy(), port_forward.numpy())
    assert port_gap <= DECODE_VS_FORWARD_TOL[arch], port_gap
