"""Port parity for the VLM (qwen2-vl-7b: `repro_torch.models.vlm`, M-RoPE in
`models.common.apply_mrope`, and the LM over the spliced sequence through
`models.api`) against the JAX package's (`repro.models.vlm`, `.common`,
`.api`: plain jnp, no Pallas kernel on this path), at `smoke()` size with
the reference's weights carried across by `params_from_reference` and
inputs from a seeded numpy generator: 8 patch embeddings drawn N(0, 1),
then the text.

Tolerances (tests/test_torch_decode.py's, whose helpers hold them):
  * the position streams are integers: bit for bit;
  * TOL, rtol 1e-4 / atol 1e-5, for the rotation (float32 cos and sin of
    the same angles), the loss and prefill's logits; with equal streams
    (text) M-RoPE is RoPE bit for bit;
  * prefill's K and V caches within one bf16 step plus TOL; decode logits
    and the caches after decode within BF16_REL of the largest reference
    value (`_assert_decoded`, `_assert_caches`);
  * decode against the forward at full depth: chip_smoke.py's
    DECODE_VS_FORWARD_TOL["qwen2-vl-7b"], at least GAP_MARGIN times the
    reference's own gap at full depth over three widths, extrapolated.
"""
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
from repro.models import vlm as ref_vlm
from repro.models.common import apply_mrope as ref_apply_mrope
from repro_torch.configs import ARCHS
from repro_torch.kernels import common
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (
    LM,
    caches_from_reference,
    decode_step,
    init_caches,
    init_model,
    loss_fn,
    mrope_positions,
    param_count,
    params_from_reference,
    prefill,
    splice_patches,
)
from repro_torch.models.common import apply_mrope, apply_rope
from repro_torch.serve import RetrievalEngine
from test_torch_decode import (GAP_MARGIN, TOL, _assert_caches, _assert_decoded,
                               _full_depth, _relative_gap)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ARCH = "qwen2-vl-7b"
# a 16-token text prompt after the smoke config's 8 patches, then 3 steps
B, TEXT, STEPS, MAX_LEN = 3, 16, 3, 40
# the reference's decode-vs-forward gap at full depth (28 layers) over these
# d_model (`_full_depth`: d_ff 2 w, head_dim w / 4), fitted as a power of the
# width and extrapolated to the full 3584
GAP_WIDTHS, FULL_WIDTH = (64, 256, 1024), 3584


@functools.lru_cache(maxsize=None)
def _setup():
    ref_cfg, cfg = REF_ARCHS[ARCH].smoke(), ARCHS[ARCH].smoke()
    params = ref_api.init_model(jax.random.key(0), ref_cfg)
    model = params_from_reference(cfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, TEXT + STEPS)).astype(np.int32)
    patches = rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    ref_prefill = jax.jit(lambda p, t, x: ref_api.prefill(
        p, {"tokens": t, "patch_embeds": x}, ref_cfg, MAX_LEN))
    ref_decode = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, ref_cfg))
    return SimpleNamespace(ref_cfg=ref_cfg, cfg=cfg, params=params, model=model, toks=toks,
                           patches=patches, ref_prefill=ref_prefill, ref_decode=ref_decode)


def _batch(s, n_text: int = TEXT) -> dict:
    return {"tokens": s.toks[:, :n_text], "patch_embeds": s.patches}


@pytest.mark.parametrize("batch,n_patches,s_text,grid", [
    (2, 9, 5, None), (1, 256, 7, None), (3, 8, 4, None), (2, 8, 6, 4), (1, 1, 3, None)])
def test_mrope_positions_bit_for_bit(batch, n_patches, s_text, grid):
    got = mrope_positions(batch, n_patches, s_text, grid, device="cpu")
    want = np.asarray(ref_vlm.mrope_positions(batch, n_patches, s_text, grid))
    assert got.shape == want.shape == (batch, n_patches + s_text, 3)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dh,theta", [(128, 1e6), (16, 1e6), (64, 1e4)])
def test_apply_mrope_matches_reference(dh, theta):
    """Patch and text streams (qwen2-vl's dh 128: sections 16 / 24 / 24), and
    text alone, where the three streams are equal and M-RoPE is RoPE."""
    rng = np.random.default_rng(dh)
    x = rng.normal(size=(2, 40, 3, dh)).astype(np.float32)
    pos = np.array(ref_vlm.mrope_positions(2, 25, 15))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos).long(), theta)
    want = ref_apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    text = np.broadcast_to(np.arange(500, 540), (2, 40))
    streams = torch.from_numpy(np.repeat(text[..., None], 3, -1).copy())
    got = apply_mrope(torch.from_numpy(x), streams, theta)
    assert torch.equal(got, apply_rope(torch.from_numpy(x), torch.from_numpy(text.copy()), theta))
    want = ref_apply_mrope(jnp.asarray(x), jnp.asarray(streams.numpy()), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_splice_puts_the_patches_first():
    s = _setup()
    x, pos = splice_patches(s.model, _batch(s))
    P = s.cfg.n_patches
    assert x.shape == (B, P + TEXT, s.cfg.d_model) and pos.shape == (B, P + TEXT, 3)
    assert torch.equal(x[:, :P], torch.from_numpy(s.patches))
    assert torch.equal(x[:, P:], s.model.embedding[torch.from_numpy(s.toks[:, :TEXT]).long()])
    want_x, want_pos = ref_vlm.splice_patches(s.ref_cfg, s.params, jax.tree.map(
        jnp.asarray, _batch(s)))
    assert np.array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(x.numpy(), np.asarray(want_x))


@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_reference(masked):
    """Labels cover the patches and the text (B, P + S_text)."""
    s = _setup()
    rng = np.random.default_rng(11)
    L = s.cfg.n_patches + TEXT
    batch = dict(_batch(s), labels=rng.integers(0, s.cfg.vocab, (B, L)).astype(np.int32))
    if masked:
        batch["mask"] = (rng.random((B, L)) < 0.6).astype(np.float32)
    want, want_aux = ref_api.loss_fn(s.params, jax.tree.map(jnp.asarray, batch), s.ref_cfg)
    got, aux = loss_fn(s.model, batch)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(float(aux["ce"]), float(want_aux["ce"]), **TOL)
    assert float(aux["aux"]) == float(want_aux["aux"]) == 0.0


def test_prefill_matches_reference():
    s = _setup()
    want, want_caches = s.ref_prefill(s.params, jnp.asarray(s.toks[:, :TEXT]),
                                      jnp.asarray(s.patches))
    before = common.launch_counts()
    got, caches = prefill(s.model, _batch(s), MAX_LEN)
    assert common.launch_counts() == before  # CPU tensors: the plain versions
    assert got.shape == (B, s.cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches(s.cfg, caches, jax.tree.map(np.asarray, want_caches), None)
    assert all(c.length == s.cfg.n_patches + TEXT for c in caches)


@pytest.mark.parametrize("from_reference", [False, True])
def test_decode_matches_reference(from_reference):
    """3 greedy steps after the patches and the prompt, both sides fed the
    reference's greedy token (the port's own wherever the reference's top
    two are further apart than the logits' tolerance), at M-RoPE position
    (length, length, length); from the port's prefill or from the
    reference's caches carried across."""
    s = _setup()
    logits, ref_caches = s.ref_prefill(s.params, jnp.asarray(s.toks[:, :TEXT]),
                                       jnp.asarray(s.patches))
    if from_reference:
        caches = caches_from_reference(s.cfg, jax.tree.map(np.asarray, ref_caches), "cpu")
    else:
        _, caches = prefill(s.model, _batch(s), MAX_LEN)
    got = None
    start = caches[0].length
    for _ in range(STEPS):
        want = np.asarray(logits)
        token = want.argmax(-1)[:, None]
        if got is not None:
            top2 = np.sort(want, -1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 2 * 2.0 ** -8 * np.abs(want).max()
            assert np.array_equal(got.numpy().argmax(-1)[clear], token[clear, 0])
        logits, ref_caches = s.ref_decode(s.params, jnp.asarray(token.astype(np.int32)),
                                          ref_caches)
        got, caches = decode_step(s.model, token, caches)
        _assert_decoded(got, logits)
    _assert_caches(s.cfg, caches, jax.tree.map(np.asarray, ref_caches), start)
    assert all(c.length == start + STEPS for c in caches)


def test_decode_from_empty_caches_matches_reference():
    """A first token at position (0, 0, 0) against `init_caches`."""
    s = _setup()
    token = s.toks[:2, :1]
    got, caches = decode_step(s.model, token, init_caches(s.cfg, 2, 12, device="cpu"))
    want, want_caches = ref_api.decode_step(s.params, jnp.asarray(token),
                                            ref_api.init_caches(s.ref_cfg, 2, 12), s.ref_cfg)
    _assert_decoded(got, want)
    _assert_caches(s.cfg, caches, jax.tree.map(np.asarray, want_caches), 0)


def test_param_count_at_full_width_equals_the_reference():
    """qwen2-vl-7b at full width and depth, counted without storage (the
    port's LM on the meta device, the reference's `jax.eval_shape`)."""
    cfg, ref_cfg = ARCHS[ARCH], REF_ARCHS[ARCH]
    shapes = jax.eval_shape(lambda k: ref_api.init_model(k, ref_cfg), jax.random.key(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert param_count(LM(cfg, device="meta")) == want == 7_615_616_512
    assert param_count(_setup().model) == ref_api.param_count(_setup().params)


def test_serving_front_refuses_the_vlm():
    """The engine embeds token ids through the LM's forward, which the
    reference's engine runs on the VLM and fails inside the model (IndexError:
    its M-RoPE reads three position streams from (B, S) positions); the
    port's refuses it up front."""
    s = _setup()
    with pytest.raises(ValueError, match="qwen2-vl-7b is a VLM"):
        RetrievalEngine(s.cfg, s.model, device="cpu")
    with pytest.raises(ValueError, match="qwen2-vl-7b is a VLM"):  # the CLI, before a model
        serve_main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    with pytest.raises(IndexError):
        ref_lm.forward(s.params, jnp.asarray(s.toks), s.ref_cfg)


def _reference_gap(ref_cfg, toks: np.ndarray, patches: np.ndarray, prompt: int):
    """The reference's teacher-forced decode logits after the patches and
    `prompt` tokens of `toks` against `unembed(forward(splice))` over all of
    them, relative to the largest; and its parameters."""
    P = patches.shape[1]
    params = ref_api.init_model(jax.random.key(0), ref_cfg)
    logits, caches = jax.jit(lambda p, t, x: ref_api.prefill(
        p, {"tokens": t, "patch_embeds": x}, ref_cfg, P + toks.shape[1]))(
        params, jnp.asarray(toks[:, :prompt]), jnp.asarray(patches))
    step = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, ref_cfg))
    out = [np.asarray(logits)]
    for i in range(prompt, toks.shape[1] - 1):
        logits, caches = step(params, jnp.asarray(toks[:, i:i + 1]), caches)
        out.append(np.asarray(logits))

    def forward(p, t, x):
        embeds, pos = ref_vlm.splice_patches(ref_cfg, p, {"tokens": t, "patch_embeds": x})
        hidden, _ = ref_lm.forward(p, t, ref_cfg, positions=pos, inputs_embeds=embeds)
        return ref_lm.unembed(ref_cfg, p, hidden)

    full = np.asarray(jax.jit(forward)(params, jnp.asarray(toks), jnp.asarray(patches)))
    return _relative_gap(np.stack(out, 1), full[:, P + prompt - 1:-1]), params


def test_reference_decode_gap_is_under_the_card_tolerance():
    """chip_smoke.py phase lm_multimodal holds qwen2-vl-7b's greedy decode
    logits at full width and depth to `unembed(forward(splice))` over the
    patches, the prompt and the decoded tokens within
    DECODE_VS_FORWARD_TOL["qwen2-vl-7b"], relative to the largest forward
    logit.  Here the reference's own gap at full depth (28 layers) and the
    widths of GAP_WIDTHS (4.7e-3 / 4.3e-3 / 3.8e-3: it falls with the
    width), fitted in log-log and extrapolated to 3584: GAP_MARGIN times the
    larger of the extrapolation and the largest measured gap is within the
    limit.  And the port's gap at the first width (plain versions, against
    its own forward) is within it too."""
    sys.path.insert(0, str(ROOT))
    try:
        from chip_smoke import DECODE_VS_FORWARD_TOL
    finally:
        sys.path.remove(str(ROOT))
    prompt, steps = 24, 16
    rng = np.random.default_rng(0)
    toks = rng.integers(0, ARCHS[ARCH].smoke().vocab, (4, prompt + steps)).astype(np.int32)
    gaps = []
    for width in GAP_WIDTHS:
        patches = np.random.default_rng(1).normal(
            size=(4, ARCHS[ARCH].smoke().n_patches, width)).astype(np.float32)
        gap, params = _reference_gap(_full_depth(REF_ARCHS[ARCH], width), toks, patches, prompt)
        gaps.append(gap)
        if width == GAP_WIDTHS[0]:
            first = params, patches
    slope, icpt = np.polyfit(np.log(GAP_WIDTHS), np.log(gaps), 1)
    predicted = max(max(gaps), float(np.exp(icpt + slope * np.log(FULL_WIDTH))))
    assert GAP_MARGIN * predicted <= DECODE_VS_FORWARD_TOL[ARCH], (gaps, slope, predicted)

    params, patches = first
    cfg = _full_depth(ARCHS[ARCH], GAP_WIDTHS[0])
    model = params_from_reference(cfg, jax.tree.map(np.asarray, params), "cpu")
    batch = {"tokens": toks[:, :prompt], "patch_embeds": patches}
    logits, caches = prefill(model, batch, patches.shape[1] + prompt + steps)
    out = [logits]
    for i in range(prompt, prompt + steps - 1):
        logits, caches = decode_step(model, toks[:, i:i + 1], caches)
        out.append(logits)
    with torch.no_grad():
        embeds, pos = splice_patches(model, {"tokens": toks, "patch_embeds": patches})
        forward = model.unembed(model(None, pos, embeds))[:, patches.shape[1] + prompt - 1:-1]
    port_gap = _relative_gap(torch.stack(out, 1).numpy(), forward.numpy())
    assert port_gap <= DECODE_VS_FORWARD_TOL[ARCH], port_gap


def test_init_model_runs_the_vlm_on_the_cpu():
    """`api.init_model` builds the VLM (an LM with M-RoPE attention) and its
    loss, prefill and decode run from its own random weights."""
    cfg = ARCHS[ARCH].smoke()
    model = init_model(cfg, seed=3, device="cpu")
    assert isinstance(model, LM) and model.layers[0].attn.cfg.mrope
    s = _setup()
    loss, _ = loss_fn(model, dict(_batch(s), labels=np.zeros(
        (B, cfg.n_patches + TEXT), np.int32)))
    logits, caches = prefill(model, _batch(s), MAX_LEN)
    logits, caches = decode_step(model, logits.argmax(-1, keepdim=True), caches)
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(logits).all())
    assert caches[0].length == cfg.n_patches + TEXT + 1
