"""Activation recompute in the port's LM (`cfg.remat`, `cfg.remat_policy`;
the reference's `jax.checkpoint` around its scan body), on the CPU at smoke
size:

  * with the recompute on ("dots" and "nothing"), the loss and every
    gradient of a smoke attention LM (gemma-2b), Mamba-1 LM
    (falcon-mamba-7b) and Mamba-2 hybrid (zamba2-7b, its shared block at
    every repeat) equal, bit for bit, the run without it; so do a train
    step's updated parameters, where the step's bf16 copies are bound to
    the recompute;
  * one float32 train step with the recompute on, both sides, within the
    train tests' tolerance of the reference's (loss rtol 1e-5, parameters
    PARAM_ATOL);
  * under "dots" the recompute keeps only the outputs of the 2-D weight
    products (`aten.mm` / `aten.addmm`), one a product of the repeat;
    "nothing" keeps none; the saved-tensor hooks see only the checkpoint's
    inputs of a recomputed repeat;
  * without grad (serving) no repeat is checkpointed."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_train_cases import PARAM_ATOL, batch, configs, leaves, ref_state, ref_step, to_port

from repro_torch.configs import ARCHS
from repro_torch.models import init_model, loss_fn
from repro_torch.models import lm as lm_mod
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(2)

ARCHS_REMAT = ("gemma-2b", "falcon-mamba-7b", "zamba2-7b")
POLICIES = ("dots", "nothing")


def _cfg(arch: str, remat: bool, policy: str = "dots"):
    return dataclasses.replace(ARCHS[arch].smoke(), remat=remat, remat_policy=policy)


def _loss_and_grads(cfg, b):
    model = init_model(cfg, 0, "cpu").train().requires_grad_(True)
    loss, _ = loss_fn(model, b)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("arch", ARCHS_REMAT)
@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_loss_and_grads_bit_for_bit(arch, policy):
    b = batch(ARCHS[arch].smoke())
    loss0, g0 = _loss_and_grads(_cfg(arch, False), b)
    loss1, g1 = _loss_and_grads(_cfg(arch, True, policy), b)
    assert torch.equal(loss0, loss1)
    assert len(g0) == len(g1)
    for a, c in zip(g0, g1):
        assert torch.equal(a, c)


@pytest.mark.parametrize("arch", ARCHS_REMAT)
@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_train_step_bit_for_bit(arch, policy):
    """The bf16 step: the recompute runs after functional_call has restored
    the float32 masters, on the bf16 copies bound at the forward."""
    b = batch(ARCHS[arch].smoke())
    out = []
    for cfg in (_cfg(arch, False), _cfg(arch, True, policy)):
        state, m = make_train_step(cfg, lambda s: 1e-3)(init_train_state(cfg, 0, "cpu"), b)
        out.append((m["loss"], [p.detach().clone() for p in state.model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][1], out[1][1]):
        assert torch.equal(a, c)


@pytest.mark.parametrize("arch", ARCHS_REMAT)
def test_recompute_step_matches_reference(arch):
    ref_cfg, cfg = configs(arch)
    ref_cfg = dataclasses.replace(ref_cfg, remat=True, remat_policy="dots")
    cfg = dataclasses.replace(cfg, remat=True, remat_policy="dots")
    rs = ref_state(ref_cfg)
    b = batch(cfg)
    ref_new, ref_m = ref_step(ref_cfg, rs, b, compute_dtype=jnp.float32)
    new, m = make_train_step(cfg, lambda s: 1e-3, compute_dtype=torch.float32)(
        to_port(cfg, rs), b)
    assert float(m["loss"]) == pytest.approx(ref_m["loss"], rel=1e-5)
    mine, theirs = leaves(new), leaves(ref_new)
    n = (len(mine) - 1) // 3
    for a, c in zip(mine[:n], theirs[:n]):
        np.testing.assert_allclose(a, c, rtol=0, atol=PARAM_ATOL)


def _saved_products(monkeypatch, cfg, b) -> list:
    kept = []
    policy = lm_mod.dots_policy

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            kept.append((op, tuple(tuple(a.shape) for a in args
                                   if isinstance(a, torch.Tensor))))
        return decision

    monkeypatch.setattr(lm_mod, "dots_policy", spy)
    model = init_model(cfg, 0, "cpu").train().requires_grad_(True)
    loss, _ = loss_fn(model, b)
    loss.backward()
    return kept


def test_dots_keeps_only_the_weight_products(monkeypatch):
    cfg = _cfg("gemma-2b", True, "dots")
    kept = _saved_products(monkeypatch, cfg, batch(ARCHS["gemma-2b"].smoke()))
    assert kept and all(op in lm_mod.SAVED_PRODUCTS for op, _ in kept)
    assert all(len(shape) == 2 for _, shapes in kept for shape in shapes)
    # wq, wk, wv, wo, w_gate, w_up, w_down: seven a gemma layer
    assert len(kept) == 7 * cfg.repeats


def test_nothing_keeps_none(monkeypatch):
    cfg = _cfg("gemma-2b", True, "nothing")
    assert _saved_products(monkeypatch, cfg, batch(ARCHS["gemma-2b"].smoke())) == []


def test_saved_tensor_hooks_see_only_the_checkpoints_inputs():
    cfg0 = ARCHS["gemma-2b"].smoke()
    b = batch(cfg0)
    counts = {}
    for remat in (False, True):
        model = init_model(_cfg("gemma-2b", remat), 0, "cpu").train().requires_grad_(True)
        packed = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t,
                                                      lambda t: t):
            loss_fn(model, b)
        counts[remat] = len(packed)
    # a recomputed repeat's own saves go to its checkpoint, not to the hooks
    assert counts[True] < counts[False]


def test_no_checkpoint_without_grad(monkeypatch):
    cfg = _cfg("gemma-2b", True)
    calls = []
    monkeypatch.setattr(lm_mod.ckpt, "checkpoint", lambda *a, **k: calls.append(1))
    model = init_model(cfg, 0, "cpu")
    with torch.no_grad():
        loss_fn(model, batch(ARCHS["gemma-2b"].smoke()))
    assert calls == []


def test_unknown_policy_raises():
    cfg = _cfg("gemma-2b", True, "everything")
    model = init_model(cfg, 0, "cpu").train().requires_grad_(True)
    with pytest.raises(ValueError, match="remat_policy"):
        loss_fn(model, batch(ARCHS["gemma-2b"].smoke()))
