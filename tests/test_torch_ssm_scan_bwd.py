"""Port parity for the Mamba-1 scan's backward (`repro_torch.kernels.ssm_scan`):
the plain reverse scan `ssm_scan_bwd_ref` (the backward kernel is held
against it on the card) on every scan case (tests/torch_scan_cases.py), with
and without a gradient of the final state, against

  * torch autograd of the plain forward `ssm_scan_batched_ref`, at rtol =
    atol = 2e-5: both float32, the same recurrence, only the order of the
    sums over channels, states and steps differs;
  * `jax.vjp` of the reference's oracle `ssm_scan_ref` (vmapped over the
    batch) and of `_mamba1_fused`, the path through which the reference
    trains falcon-mamba-7b, at rtol = atol = 5e-5: XLA's exp and its
    fused, reassociated sums round otherwise than torch's;
  * and a plain mirror of the backward kernel's decomposition
    (`bwd_kernel_mirror`: 32-step tiles recomputed from the forward's
    checkpoints, exp2 of dt A log2 e with subnormals flushed, the fixed-order
    reduces over channel blocks and batch rows) against the plain backward,
    at 2e-5 as above."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_scan_cases import SCAN_CASES, bwd_kernel_mirror, make_case, make_grads

from repro.kernels.ssm_scan.ref import ssm_scan_ref as ref_scan_ref
from repro.models.ssm import _mamba1_fused
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_batched_ref, ssm_scan_bwd_ref

torch.set_num_threads(2)

TORCH_TOL = dict(rtol=2e-5, atol=2e-5)
JAX_TOL = dict(rtol=5e-5, atol=5e-5)
NAMES = ("ddt", "dx", "dB", "dC", "dA", "dh0")
FUSED_CHUNK = 64  # the reference's mamba1_block default


def _case(name: str, with_dh: bool):
    args = [torch.from_numpy(a) for a in make_case(name)]
    dy, dh = (torch.from_numpy(a) for a in make_grads(name))
    return args, dy, dh if with_dh else None


def _close(got, want, tol) -> None:
    for g, w, tag in zip(got, want, NAMES):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), err_msg=tag, **tol)


@pytest.mark.parametrize("with_dh", [True, False], ids=["dh_fin", "no dh_fin"])
@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_bwd_ref_matches_autograd(name, with_dh):
    args, dy, dh = _case(name, with_dh)
    ins = [a.clone().requires_grad_() for a in args]
    y, h = ssm_scan_batched_ref(*ins)
    loss = (y * dy).sum() + ((h * dh).sum() if dh is not None else 0.0)
    want = torch.autograd.grad(loss, ins)
    got = ssm_scan_bwd_ref(*args, dy, dh)
    assert [tuple(g.shape) for g in got] == [tuple(a.shape) for a in args]
    _close(got, want, TORCH_TOL)
    # the CPU wrapper (the plain version, chunked) differentiates to the same
    ins = [a.clone().requires_grad_() for a in args]
    y, h = ssm_scan(*ins, seq_chunk=33)
    loss = (y * dy).sum() + ((h * dh).sum() if dh is not None else 0.0)
    _close(torch.autograd.grad(loss, ins), got, TORCH_TOL)


def _jax_grads(fn, args, dy, dh):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a.numpy()) for a in args))
    dh = jnp.zeros(args[5].shape, jnp.float32) if dh is None else jnp.asarray(dh.numpy())
    return vjp((jnp.asarray(dy.numpy()), dh))


@pytest.mark.parametrize("with_dh", [True, False], ids=["dh_fin", "no dh_fin"])
@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_bwd_ref_matches_jax_vjp(name, with_dh):
    args, dy, dh = _case(name, with_dh)
    got = ssm_scan_bwd_ref(*args, dy, dh)
    oracle = jax.vmap(ref_scan_ref, in_axes=(0, 0, 0, 0, None, 0))
    _close(got, _jax_grads(oracle, args, dy, dh), JAX_TOL)
    fused = lambda *a: _mamba1_fused(*a, FUSED_CHUNK)  # noqa: E731
    _close(got, _jax_grads(fused, args, dy, dh), JAX_TOL)


@pytest.mark.parametrize("with_dh", [True, False], ids=["dh_fin", "no dh_fin"])
@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_bwd_kernel_mirror_matches_plain(name, with_dh):
    args, dy, dh = _case(name, with_dh)
    _close(bwd_kernel_mirror(*args, dy, dh), ssm_scan_bwd_ref(*args, dy, dh), TORCH_TOL)
