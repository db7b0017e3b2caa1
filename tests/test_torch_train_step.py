"""The port's train step (`repro_torch.train.step`) against the reference's
(`repro.train.step`), on the CPU at smoke size, the same weights carried
across (`models.convert.train_state_from_reference`) and the same batch:

  * one step in float32 compute of gemma-2b, gemma2-9b (softcaps, local
    windows) and qwen3-moe (the MoE's aux loss), here, and of zamba2-7b,
    falcon-mamba-7b (the plain Mamba-1 scan) and whisper-tiny (frames,
    cross attention) in tests/test_torch_train_models.py: loss, ce, aux and
    grad norm (rtol 1e-5), the updated parameters within PARAM_ATOL = 5e-4
    (the reference's own microbatch test's bound after one step at lr
    1e-3), the moments m and v within 1e-4 of the tree's largest (a leaf
    whose true gradient is 0, such as a key bias under softmax, holds
    float32 noise of ~1e-11 in both, which no per-leaf relative bound can
    compare), and the step;
  * the bf16 cast rule leaf by leaf against the reference's `_cast_params`
    (the reference leaf's rank decides, not the port's: a pattern slot's
    stacked vectors are cast, the tail's and the shared block's are not);
  * the bf16 loss: the port's bf16-vs-float32 gap, averaged over six
    batches, within the largest of the reference's own gaps on the same
    batches (each package rounds to bf16 at other places, so a single
    batch's gaps are two draws of the same noise);
  * microbatched gradient accumulation against the full batch, and
    against the reference's microbatched step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_train_cases import (PARAM_ATOL, TRAIN_ARCHS, batch, configs, leaves, ref_state,
                               ref_step, to_port)

from repro.models import api as ref_api
from repro.train.step import _cast_params
from repro_torch.models.convert import reference_path
from repro_torch.train import make_train_step
from repro_torch.train.step import _Loss, cast_names

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
MOMENT_TOL = 1e-4  # of the tree's largest moment


def check_step(arch: str, **kw) -> None:
    ref_cfg, cfg = configs(arch)
    rs = ref_state(ref_cfg)
    b = batch(cfg)
    ref_new, ref_m = ref_step(ref_cfg, rs, b, compute_dtype=jnp.float32, **kw)
    new, m = make_train_step(cfg, lambda s: 1e-3, compute_dtype=torch.float32, **kw)(
        to_port(cfg, rs), b)
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert float(m[key]) == pytest.approx(ref_m[key], rel=LOSS_RTOL, abs=1e-7), key
    mine, theirs = leaves(new), leaves(ref_new)
    assert len(mine) == len(theirs)
    n = (len(mine) - 1) // 3
    for a, b_ in zip(mine[:n], theirs[:n]):
        np.testing.assert_allclose(a, b_, rtol=0, atol=PARAM_ATOL)
    for lo in (n, 2 * n):
        big = max(float(np.abs(x).max()) for x in theirs[lo:lo + n])
        for a, b_ in zip(mine[lo:lo + n], theirs[lo:lo + n]):
            np.testing.assert_allclose(a, b_, rtol=1e-3, atol=MOMENT_TOL * big)
    assert mine[-1] == theirs[-1] == 1


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma2-9b", "qwen3-moe-235b-a22b"])
def test_one_fp32_step_matches_reference(arch):
    check_step(arch)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_bf16_cast_rule_matches_reference_leaf_by_leaf(arch):
    ref_cfg, cfg = configs(arch)
    shapes = jax.eval_shape(lambda: ref_api.init_model(jax.random.key(0), ref_cfg))
    cast = _cast_params(jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes),
                        jnp.bfloat16)
    model = to_port(cfg, ref_state(ref_cfg)).model
    mine = cast_names(cfg, model)
    n_vectors_cast = 0
    for name, p in model.named_parameters():
        node = cast
        path, r = reference_path(cfg, name)
        for key in path:
            node = node[key]
        assert (node.dtype == jnp.bfloat16) == (name in mine), name
        n_vectors_cast += p.dim() == 1 and name in mine
    if cfg.repeats > 0 and not cfg.enc_dec:  # a stacked slot's vectors are cast
        assert n_vectors_cast > 0


def _losses(ref_cfg, cfg, rs, st, b):
    f = jax.jit(lambda p, bb, dt: ref_api.loss_fn(_cast_params(p, dt), bb, ref_cfg)[0],
                static_argnums=2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    names = cast_names(cfg, st.model)
    params = dict(st.model.named_parameters())
    with torch.no_grad():
        p16 = torch.func.functional_call(
            _Loss(st.model), {f"model.{n}": p.to(torch.bfloat16) if n in names else p
                              for n, p in params.items()}, (b,))[0]
    return float(f(rs.params, jb, jnp.float32)), float(f(rs.params, jb, jnp.bfloat16)), float(p16)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_bf16_loss_within_the_reference_bf16_gap(arch):
    ref_cfg, cfg = configs(arch)
    rs = ref_state(ref_cfg)
    st = to_port(cfg, rs)
    ref_gaps, gaps, fp32 = [], [], []
    for step in range(6):
        r32, r16, p16 = _losses(ref_cfg, cfg, rs, st, batch(cfg, step=step))
        ref_gaps.append(abs(r16 - r32))
        gaps.append(abs(p16 - r32))
        fp32.append(r32)
    assert 0 < np.mean(gaps) <= max(ref_gaps), (gaps, ref_gaps)
    # and the bf16 train step reports the same bf16 loss, and stays finite
    new, m = make_train_step(cfg, lambda s: 1e-3)(st, batch(cfg, step=0))
    assert abs(float(m["loss"]) - fp32[0]) == pytest.approx(gaps[0], abs=1e-6)
    assert all(bool(torch.isfinite(p).all()) for p in new.model.parameters())


def test_microbatch_matches_full_batch_and_reference():
    ref_cfg, cfg = configs("gemma-2b")
    rs = ref_state(ref_cfg)
    b = batch(cfg, B=8, S=16)
    del b["mask"]  # a mask weighs microbatches unlike the whole batch's mean
    full, m_full = make_train_step(cfg, lambda s: 1e-3, compute_dtype=torch.float32)(
        to_port(cfg, rs), b)
    micro, m_micro = make_train_step(cfg, lambda s: 1e-3, compute_dtype=torch.float32,
                                     microbatch=2)(to_port(cfg, rs), b)
    ref_micro, ref_m = ref_step(ref_cfg, rs, b, compute_dtype=jnp.float32, microbatch=2)
    mine, whole, theirs = leaves(micro), leaves(full), leaves(ref_micro)
    n = (len(mine) - 1) // 3
    for a, c, r in zip(mine[:n], whole[:n], theirs[:n]):
        np.testing.assert_allclose(a, c, rtol=0, atol=PARAM_ATOL)
        np.testing.assert_allclose(a, r, rtol=0, atol=PARAM_ATOL)
    assert float(m_micro["loss"]) == pytest.approx(ref_m["loss"], rel=LOSS_RTOL)
    assert float(m_micro["grad_norm"]) == pytest.approx(ref_m["grad_norm"], rel=LOSS_RTOL)


@pytest.mark.parametrize("B, micro", [(8, 3), (2, 4)])
def test_microbatch_that_does_not_divide_the_batch_is_refused(B, micro):
    """A batch that `microbatch` does not divide (B 8 over 3, and B 2 under
    a microbatch of 4) is refused by both packages: the port raises
    ValueError naming both sizes before any forward, the reference's
    reshape to (n_micro, microbatch) fails."""
    ref_cfg, cfg = configs("gemma-2b")
    rs = ref_state(ref_cfg)
    b = batch(cfg, B=B, S=8)
    step = make_train_step(cfg, lambda s: 1e-3, compute_dtype=torch.float32, microbatch=micro)
    with pytest.raises(ValueError, match=rf"\b{B}\b.*\b{micro}\b"):
        step(to_port(cfg, rs), b)
    with pytest.raises((TypeError, ValueError)):
        ref_step(ref_cfg, rs, b, compute_dtype=jnp.float32, microbatch=micro)
