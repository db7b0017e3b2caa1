"""Port parity for the Mamba-1 selective scan (`repro_torch.kernels.ssm_scan`):
the plain version (the CPU path; the CUDA kernel is held against it on the
card) against the reference's oracle `ssm_scan_ref` and its Pallas kernel
in interpret mode, and the batched, sequence-chunked wrapper against the
reference's `ops.ssm_scan`, at rtol = atol = 1e-5 (float32, the same
recurrence; only the order of the C contraction differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import ssm_scan as ref_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as ref_scan_ref
from repro.kernels.ssm_scan.ssm_scan import ssm_scan_pallas
from repro_torch.kernels import common
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref

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
