"""Port parity for the encoder-decoder (whisper-tiny: `repro_torch.models
.whisper.Whisper` through `models.api`, and `models.common
.sinusoidal_positions`) against the JAX package's (`repro.models.whisper`,
`.common`, `.api`: plain jnp, no Pallas kernel on this path), at `smoke()`
size (2 encoder and 2 decoder layers, 16 frames) with the reference's
weights carried across by `params_from_reference` and inputs from a seeded
numpy generator (frame embeddings drawn N(0, 1)).

Tolerances (tests/test_torch_decode.py's):
  * TOL, rtol 1e-4 / atol 1e-5: float32 in another summation order -- the
    position table, the encoder's states, the decoder's logits, the loss,
    prefill's logits and its cross-attention K and V (float32, as the
    reference keeps them);
  * the self-attention K and V caches within one bf16 step plus TOL after
    prefill, and at the decode positions within BF16_REL (a bf16 step,
    relative) of the largest reference value plus a step; decode logits
    within BF16_REL of the largest reference logit;
  * decode against the forward at full depth: chip_smoke.py's
    DECODE_VS_FORWARD_TOL["whisper-tiny"], at least GAP_MARGIN times the
    reference's own gap at full depth over three widths up to the full one.
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
from repro.models import whisper as ref_whisper
from repro.models.common import sinusoidal_positions as ref_sinusoidal_positions
from repro.serve.engine import RetrievalEngine as RefRetrievalEngine
from repro_torch.configs import ARCHS
from repro_torch.kernels import common
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (
    Whisper,
    WhisperCache,
    caches_from_reference,
    decode_step,
    init_caches,
    init_model,
    loss_fn,
    param_count,
    params_from_reference,
    prefill,
)
from repro_torch.models.common import sinusoidal_positions
from repro_torch.serve import RetrievalEngine
from test_torch_decode import (BF16_REL, GAP_MARGIN, TOL, _assert_decoded,
                               _assert_within_a_bf16_step, _bf16_step, _relative_gap)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ARCH = "whisper-tiny"
B, PROMPT, STEPS, MAX_LEN = 3, 12, 3, 24
# the reference's decode-vs-forward gap at full depth (4 + 4 layers) and the
# config's 1,500 frames over these d_model, at whisper-tiny's shapes scaled
# (6 heads of w / 6, d_ff 4 w): the last is the full width
GAP_WIDTHS = (96, 192, 384)


@functools.lru_cache(maxsize=None)
def _setup():
    ref_cfg, cfg = REF_ARCHS[ARCH].smoke(), ARCHS[ARCH].smoke()
    params = ref_api.init_model(jax.random.key(0), ref_cfg)
    model = params_from_reference(cfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, PROMPT + STEPS)).astype(np.int32)
    frames = rng.normal(size=(B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    ref_prefill = jax.jit(lambda p, t, f: ref_api.prefill(
        p, {"tokens": t, "frames": f}, ref_cfg, MAX_LEN))
    ref_decode = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, ref_cfg))
    return SimpleNamespace(ref_cfg=ref_cfg, cfg=cfg, params=params, model=model, toks=toks,
                           frames=frames, ref_prefill=ref_prefill, ref_decode=ref_decode)


def _batch(s) -> dict:
    return {"tokens": s.toks[:, :PROMPT], "frames": s.frames}


def _assert_caches(got: WhisperCache, want_np, decoded_from: int | None) -> None:
    """Self-attention K and V within a bf16 step (+ TOL) at the positions
    prefill wrote; at those decode wrote (from `decoded_from`), within
    BF16_REL of the largest reference value plus a step.  Cross K and V
    float32 within TOL."""
    want = caches_from_reference(_setup().cfg, want_np, "cpu")
    assert isinstance(got, WhisperCache) and got.length == want.length
    assert len(got.self_kv) == len(want.self_kv) == len(got.ck) == len(got.cv) == 2
    p = decoded_from
    for g, w in zip(got.self_kv, want.self_kv):
        assert g.length == w.length == got.length
        assert g.k.dtype == g.v.dtype == torch.bfloat16
        for a, b in zip(g[:2], w[:2]):
            a, b = a.to(torch.float32), b.to(torch.float32)
            _assert_within_a_bf16_step(a[:, :p], b[:, :p])
            if p is not None:
                a, b = a[:, p:], b[:, p:]
                bound = BF16_REL * float(b.abs().max()) + _bf16_step(
                    torch.maximum(a.abs(), b.abs()))
                assert bool(((a - b).abs() <= bound).all())
    for a, b in zip(got.ck + got.cv, want.ck + want.cv):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("max_len,d_model", [(16, 64), (1500, 384), (7, 10)])
def test_sinusoidal_positions_match_reference(max_len, d_model):
    got = sinusoidal_positions(max_len, d_model)
    want = np.asarray(ref_sinusoidal_positions(max_len, d_model))
    assert got.shape == want.shape == (max_len, 2 * ((d_model + 1) // 2))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    half = got.shape[1] // 2  # [sin | cos] by halves: position 0 is [0 ... | 1 ...]
    assert not bool(got[0, :half].any()) and bool((got[0, half:] == 1).all())


def test_encode_and_decode_train_match_reference():
    s = _setup()
    enc = ref_whisper.encode(s.params, jnp.asarray(s.frames), s.ref_cfg)
    want = ref_whisper.decode_train(s.params, jnp.asarray(s.toks), enc, s.ref_cfg)
    before = common.launch_counts()
    with torch.no_grad():
        got_enc = s.model.encode(torch.from_numpy(s.frames))
        got = s.model.decode_train(torch.from_numpy(s.toks).long(), got_enc)
    assert common.launch_counts() == before  # CPU tensors: the plain versions
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(enc), **TOL)
    assert got.shape == (B, PROMPT + STEPS, s.cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_reference(masked):
    s = _setup()
    rng = np.random.default_rng(11)
    batch = dict(_batch(s), labels=rng.integers(0, s.cfg.vocab, (B, PROMPT)).astype(np.int32))
    if masked:
        batch["mask"] = (rng.random((B, PROMPT)) < 0.6).astype(np.float32)
    want, want_aux = ref_api.loss_fn(s.params, jax.tree.map(jnp.asarray, batch), s.ref_cfg)
    got, aux = loss_fn(s.model, batch)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(float(aux["ce"]), float(want_aux["ce"]), **TOL)
    assert float(aux["aux"]) == float(want_aux["aux"]) == 0.0


def test_prefill_matches_reference():
    s = _setup()
    want, want_caches = s.ref_prefill(s.params, jnp.asarray(s.toks[:, :PROMPT]),
                                      jnp.asarray(s.frames))
    got, caches = prefill(s.model, _batch(s), MAX_LEN)
    assert got.shape == (B, s.cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches(caches, jax.tree.map(np.asarray, want_caches), None)
    assert caches.length == PROMPT
    assert caches.ck[0].shape == (B, s.cfg.n_audio_frames, s.cfg.n_kv, s.cfg.head_dim)


@pytest.mark.parametrize("from_reference", [False, True])
def test_decode_matches_reference(from_reference):
    """3 greedy steps after the prompt, both sides fed the reference's
    greedy token (the port's own wherever the reference's top two are
    further apart than the logits' tolerance), from the port's prefill or
    from the reference's caches carried across; the cross K and V are
    left as prefill made them."""
    s = _setup()
    logits, ref_caches = s.ref_prefill(s.params, jnp.asarray(s.toks[:, :PROMPT]),
                                       jnp.asarray(s.frames))
    if from_reference:
        caches = caches_from_reference(s.cfg, jax.tree.map(np.asarray, ref_caches), "cpu")
    else:
        _, caches = prefill(s.model, _batch(s), MAX_LEN)
    ck = [t.clone() for t in caches.ck]
    got = None
    for _ in range(STEPS):
        want = np.asarray(logits)
        token = want.argmax(-1)[:, None]
        if got is not None:
            top2 = np.sort(want, -1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 2 * BF16_REL * np.abs(want).max()
            assert np.array_equal(got.numpy().argmax(-1)[clear], token[clear, 0])
        logits, ref_caches = s.ref_decode(s.params, jnp.asarray(token.astype(np.int32)),
                                          ref_caches)
        got, caches = decode_step(s.model, token, caches)
        _assert_decoded(got, logits)
    _assert_caches(caches, jax.tree.map(np.asarray, ref_caches), PROMPT)
    assert caches.length == PROMPT + STEPS
    assert all(torch.equal(a, b) for a, b in zip(caches.ck, ck))


def test_reference_trees_with_unread_keys_are_refused():
    s = _setup()
    params = jax.tree.map(np.asarray, s.params)
    with pytest.raises(KeyError, match="does not read"):
        params_from_reference(s.cfg, dict(params, head={}), "cpu")
    with pytest.raises(KeyError, match="missing"):
        params_from_reference(s.cfg, dict(params, dec_ln={"scale": params["dec_ln"]["scale"]}),
                              "cpu")
    _, caches = s.ref_prefill(s.params, jnp.asarray(s.toks[:, :PROMPT]), jnp.asarray(s.frames))
    with pytest.raises(KeyError, match="does not read"):
        caches_from_reference(s.cfg, dict(jax.tree.map(np.asarray, caches), pattern={}), "cpu")


def test_init_model_and_entry_points():
    """`api.init_model` builds a `Whisper` with the reference's
    distributions; `init_caches` refuses it with the reference's reason
    (the cross K and V depend on the audio); decode past the learned
    positions is refused."""
    cfg = ARCHS[ARCH].smoke()
    model = init_model(cfg, seed=3, device="cpu")
    assert isinstance(model, Whisper) and len(model.enc) == len(model.dec) == 2
    assert abs(float(model.embedding.std()) - 0.02) < 2e-3
    assert abs(float(model.pos_embedding.std()) - 0.01) < 1e-3
    assert bool((model.enc_ln.scale == 1).all()) and not bool(model.dec[0].self_attn.bq.any())
    with pytest.raises(NotImplementedError, match="whisper caches come from prefill"):
        init_caches(cfg, 1, 8, device="cpu")
    short = init_model(dataclasses.replace(cfg, max_pos=PROMPT + 1), seed=3, device="cpu")
    s = _setup()
    logits, caches = prefill(short, _batch(s), MAX_LEN)
    logits, caches = decode_step(short, logits.argmax(-1, keepdim=True), caches)
    with pytest.raises(ValueError, match="learned positions"):
        decode_step(short, logits.argmax(-1, keepdim=True), caches)


def test_param_count_at_full_width_equals_the_reference():
    """whisper-tiny at full width and depth, counted without storage (the
    port's model on the meta device, the reference's `jax.eval_shape`),
    inside the reference's range for it (2e7-6e7, tests/test_models.py)."""
    cfg, ref_cfg = ARCHS[ARCH], REF_ARCHS[ARCH]
    shapes = jax.eval_shape(lambda k: ref_api.init_model(k, ref_cfg), jax.random.key(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    n = param_count(Whisper(cfg, device="meta"))
    assert n == want == 52_230_144 and 2e7 <= n <= 6e7
    assert param_count(_setup().model) == ref_api.param_count(_setup().params)


def test_serving_front_refuses_whisper():
    """The engine embeds token ids through the decoder LM's forward, which
    the reference's engine runs on whisper's tree and fails inside the model
    (KeyError 'pattern'); the port's refuses it up front."""
    s = _setup()
    with pytest.raises(ValueError, match="whisper-tiny is an encoder-decoder"):
        RetrievalEngine(s.cfg, s.model, device="cpu")
    with pytest.raises(ValueError, match="whisper-tiny is an encoder-decoder"):
        serve_main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    engine = RefRetrievalEngine(s.ref_cfg, s.params)
    with pytest.raises(KeyError, match="pattern"):
        engine.embed(s.toks)


def _gap_config(width: int):
    """whisper-tiny at full depth and the config's 1,500 frames, a smoke
    config (vocab 512) widened to `width`: 6 heads of width / 6, d_ff 4
    width."""
    full = REF_ARCHS[ARCH]
    return dataclasses.replace(full.smoke(), n_layers=full.n_layers, repeats=full.repeats,
                               n_enc_layers=full.n_enc_layers, n_audio_frames=full.n_audio_frames,
                               d_model=width, n_heads=full.n_heads, n_kv=full.n_kv,
                               head_dim=width // full.n_heads, d_ff=4 * width)


def _reference_gap(ref_cfg, toks: np.ndarray, frames: np.ndarray, prompt: int):
    """The reference's teacher-forced decode logits after `prompt` tokens of
    `toks` against `decode_train(encode(frames))` over all of them,
    relative to the largest; and its parameters."""
    params = ref_api.init_model(jax.random.key(0), ref_cfg)
    logits, caches = jax.jit(lambda p, t, f: ref_api.prefill(
        p, {"tokens": t, "frames": f}, ref_cfg, toks.shape[1]))(
        params, jnp.asarray(toks[:, :prompt]), jnp.asarray(frames))
    step = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, ref_cfg))
    out = [np.asarray(logits)]
    for i in range(prompt, toks.shape[1] - 1):
        logits, caches = step(params, jnp.asarray(toks[:, i:i + 1]), caches)
        out.append(np.asarray(logits))
    forward = jax.jit(lambda p, t, f: ref_whisper.decode_train(
        p, t, ref_whisper.encode(p, f, ref_cfg), ref_cfg))
    full = np.asarray(forward(params, jnp.asarray(toks), jnp.asarray(frames)))
    return _relative_gap(np.stack(out, 1), full[:, prompt - 1:-1]), params


def test_reference_decode_gap_is_under_the_card_tolerance():
    """chip_smoke.py phase lm_multimodal holds whisper-tiny's greedy decode
    logits at full width and depth to `decode_train(encode(frames))` over
    the prompt and the decoded tokens within
    DECODE_VS_FORWARD_TOL["whisper-tiny"], relative to the largest forward
    logit.  Here the reference's own gap at full depth and 1,500 frames over
    GAP_WIDTHS (1.2e-3 / 7.3e-4 / 6.7e-4: the bf16 self-attention cache;
    the cross K and V stay float32), fitted in log-log and extrapolated to
    384, the last of them: GAP_MARGIN times the larger of the extrapolation
    and the largest measured gap is within the limit.  And the port's gap
    at the first width (plain versions, against its own forward) is within
    it too."""
    sys.path.insert(0, str(ROOT))
    try:
        from chip_smoke import DECODE_VS_FORWARD_TOL
    finally:
        sys.path.remove(str(ROOT))
    prompt, steps = 24, 16
    toks = np.random.default_rng(0).integers(0, ARCHS[ARCH].smoke().vocab,
                                             (4, prompt + steps)).astype(np.int32)
    gaps = []
    for width in GAP_WIDTHS:
        frames = np.random.default_rng(1).normal(
            size=(4, REF_ARCHS[ARCH].n_audio_frames, width)).astype(np.float32)
        gap, params = _reference_gap(_gap_config(width), toks, frames, prompt)
        gaps.append(gap)
        if width == GAP_WIDTHS[0]:
            first = params, frames
    slope, icpt = np.polyfit(np.log(GAP_WIDTHS), np.log(gaps), 1)
    full = REF_ARCHS[ARCH].d_model
    predicted = max(max(gaps), float(np.exp(icpt + slope * np.log(full))))
    assert GAP_MARGIN * predicted <= DECODE_VS_FORWARD_TOL[ARCH], (gaps, slope, predicted)

    params, frames = first
    model = params_from_reference(_gap_config(GAP_WIDTHS[0]), jax.tree.map(np.asarray, params),
                                  "cpu")
    logits, caches = prefill(model, {"tokens": toks[:, :prompt], "frames": frames},
                             prompt + steps)
    out = [logits]
    for i in range(prompt, prompt + steps - 1):
        logits, caches = decode_step(model, toks[:, i:i + 1], caches)
        out.append(logits)
    with torch.no_grad():
        forward = model.decode_train(torch.from_numpy(toks).long(),
                                     model.encode(torch.from_numpy(frames)))[:, prompt - 1:-1]
    port_gap = _relative_gap(torch.stack(out, 1).numpy(), forward.numpy())
    assert port_gap <= DECODE_VS_FORWARD_TOL[ARCH], port_gap
