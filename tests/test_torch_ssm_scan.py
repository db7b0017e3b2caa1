"""Port parity for the Mamba-1 selective scan (`repro_torch.kernels.ssm_scan`):
the plain version (the CPU path; the CUDA kernel is held against it on the
card) against the reference's oracle `ssm_scan_ref` and its Pallas kernel
in interpret mode, and the batched, sequence-chunked wrapper against the
reference's `ops.ssm_scan`, at rtol = atol = 1e-5 (float32, the same
recurrence; only the order of the C contraction differs); also at the
kernel's edge cases (tests/torch_scan_cases.py), where a plain-torch mirror
of the card kernel's lanes and exp2 is held to the reference too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_scan_cases import SCAN_CASES, lanes_mirror, make_case

from repro.kernels.ssm_scan.ops import ssm_scan as ref_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as ref_scan_ref
from repro.kernels.ssm_scan.ssm_scan import ssm_scan_pallas
from repro_torch.kernels import common
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_batched_ref, ssm_scan_ref

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(lead, L, D, N, seed):
    rng = np.random.default_rng(seed)
    dt = np.abs(rng.normal(size=lead + (L, D))).astype(np.float32) * 0.1
    x = rng.normal(size=lead + (L, D)).astype(np.float32)
    Bc = rng.normal(size=lead + (L, N)).astype(np.float32)
    Cc = rng.normal(size=lead + (L, N)).astype(np.float32)
    A = -np.abs(rng.normal(size=(D, N))).astype(np.float32)
    h0 = rng.normal(size=lead + (D, N)).astype(np.float32)
    return dt, x, Bc, Cc, A, h0


@pytest.mark.parametrize("L,D,N", [(8, 16, 4), (64, 40, 16), (33, 7, 1)])
def test_single_sequence_matches_ref_and_pallas(L, D, N):
    args = _inputs((), L, D, N, L * D)
    y, h = ssm_scan_ref(*map(torch.from_numpy, args))
    y_r, h_r = ref_scan_ref(*map(jnp.asarray, args))
    bd = 8 if D % 8 == 0 else D
    y_p, h_p = ssm_scan_pallas(*map(jnp.asarray, args), block_d=bd, interpret=True)
    for got, want in ((y, y_r), (h, h_r), (y, y_p), (h, h_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,L,D,N,seq_chunk", [(2, 96, 24, 8, 32), (3, 50, 16, 16, 7),
                                               (1, 20, 8, 4, 2048)])
def test_batched_chunked_wrapper_matches_reference(B, L, D, N, seq_chunk):
    args = _inputs((B,), L, D, N, B * L)
    dt, x, Bc, Cc, A, h0 = args
    before = common.launch_counts()["ssm_scan"]
    y, h = ssm_scan(*map(torch.from_numpy, args), seq_chunk=seq_chunk)
    assert common.launch_counts()["ssm_scan"] == before  # CPU: the plain version
    assert y.shape == (B, L, D) and h.shape == (B, D, N)
    bd = 8 if D % 8 == 0 else D
    y_r, h_r = ref_ssm_scan(*map(jnp.asarray, args), seq_chunk=seq_chunk, block_d=bd)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), **TOL)
    # chunking carries h exactly: one pass over the whole sequence agrees
    y1, h1 = ssm_scan(*map(torch.from_numpy, args), seq_chunk=L)
    np.testing.assert_allclose(y.numpy(), y1.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h1.numpy(), **TOL)


def test_wrapper_rejects_a_bad_chunk():
    args = map(torch.from_numpy, _inputs((1,), 4, 8, 2, 0))
    with pytest.raises(ValueError, match="seq_chunk"):
        ssm_scan(*args, seq_chunk=0)


def test_cpu_wrapper_stays_differentiable():
    """On CPU tensors the wrapper runs the plain version, which autograd
    differentiates: gradients reach every input (the card's path goes
    through `SSMScan` and the backward kernel)."""
    g = torch.Generator().manual_seed(0)
    B, L, D, N = 2, 6, 3, 4
    dt = torch.nn.functional.softplus(torch.randn((B, L, D), generator=g))
    ins = [dt, torch.randn((B, L, D), generator=g), torch.randn((B, L, N), generator=g),
           torch.randn((B, L, N), generator=g), -torch.rand((D, N), generator=g),
           torch.randn((B, D, N), generator=g)]
    for t in ins:
        t.requires_grad_()
    y, h = ssm_scan(*ins, seq_chunk=4)
    (y.sum() + h.sum()).backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in ins)


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_edge_cases_match_reference(name):
    """The plain version and the wrapper (chunks of 33 steps and of the
    default 2048) against the reference's oracle and Pallas kernel
    (interpret mode) on each sequence, and against its wrapper."""
    args = make_case(name)
    B, L, D = args[0].shape
    bd = 8 if D % 8 == 0 else D
    y_r, h_r = ref_ssm_scan(*map(jnp.asarray, args), seq_chunk=33, block_d=bd)
    got = [ssm_scan_batched_ref(*map(torch.from_numpy, args))]
    for chunk in (33, 2048):
        got.append(ssm_scan(*map(torch.from_numpy, args), seq_chunk=chunk))
    for y, h in got:
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_r), **TOL)
    for b in range(B):
        one = [a[b] for a in args[:4]] + [args[4], args[5][b]]
        y1, h1 = ref_scan_ref(*map(jnp.asarray, one))
        y_p, h_p = ssm_scan_pallas(*map(jnp.asarray, one), block_d=bd, interpret=True)
        for want_y, want_h in ((y1, h1), (y_p, h_p)):
            np.testing.assert_allclose(got[0][0][b].numpy(), np.asarray(want_y), **TOL)
            np.testing.assert_allclose(got[0][1][b].numpy(), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_lane_mirror_matches_reference(name):
    """The card kernel's decomposition (states padded to 4 a lane, exp2 of
    dt * A log2 e with subnormals flushed, each lane's dot, the lanes summed
    in the kernel's order), in plain torch, against the reference."""
    args = make_case(name)
    y, h = lanes_mirror(*map(torch.from_numpy, args))
    y_r, h_r = ref_ssm_scan(*map(jnp.asarray, args), use_pallas=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), **TOL)


@pytest.mark.parametrize("which", range(6))
def test_cpu_wrapper_refuses_a_bf16_input(which):
    """The CPU path takes float32 only, with the card's check: a bf16 input
    (any of dt, x, B, C, A, h0) raises TypeError naming it, where the plain
    version would promote it silently."""
    args = [torch.from_numpy(a) for a in _inputs((2,), 5, 8, 4, 0)]
    args[which] = args[which].to(torch.bfloat16)
    name = ("dt", "x", "Bc", "Cc", "A", "h0")[which]
    with pytest.raises(TypeError, match=rf"^{name}: dtype torch.bfloat16"):
        ssm_scan(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_empty_sequence_returns_float32(dtype):
    """L = 0: y is float32 zeros of shape (B, 0, D) whether dt, x, B, C come
    in float32 or all in bf16 (the bf16 form), and h_fin is h0."""
    args = [torch.from_numpy(a) for a in _inputs((2,), 0, 8, 4, 0)]
    args[:4] = [a.to(dtype) for a in args[:4]]
    y, h = ssm_scan(*args)
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, 0, 8)
    assert torch.equal(h, args[5])
