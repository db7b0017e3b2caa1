"""Port parity: the plain versions of the gather kernels equal the reference
Pallas kernels run in interpret mode (rtol 1e-5, atol 1e-6: fp32 summation
order), both metrics, zero rows (NaN from the unclamped angular norms) and
negative ids (row 0) included; the wrappers mask id < 0 to +inf."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_l2.gather_l2 import gather_dist_pallas
from repro.kernels.gather_q.gather_q import gather_dist_q_pallas
from repro.store.stores import _quantize_rows as ref_quantize
from repro_torch.kernels.common import launch_counts, reset_launch_counts
from repro_torch.kernels.gather_l2 import gather_dist, gather_dist_kernel
from repro_torch.kernels.gather_q import gather_dist_q, gather_dist_q_kernel
from repro_torch.store.stores import _fix_kernel_dist, _quantize_rows

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(n, d, B, L, seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, d)).astype(np.float32)
    data[3] = 0.0  # zero row
    ids = rng.integers(-1, n, size=(B, L)).astype(np.int32)
    ids[0, 0] = 3
    ids[0, 1] = -1
    queries = rng.normal(size=(B, d)).astype(np.float32)
    return data, ids, queries


def _close_with_nan(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), **TOL)


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("n,d", [(50, 16), (40, 13)])
def test_gather_l2_plain_equals_pallas(metric, n, d):
    data, ids, queries = _inputs(n, d, 3, 8, seed=d)
    ref = gather_dist_pallas(jnp.asarray(data), jnp.asarray(ids), jnp.asarray(queries),
                             metric=metric, interpret=True)
    reset_launch_counts()
    ours = gather_dist_kernel(torch.from_numpy(data), torch.from_numpy(ids),
                              torch.from_numpy(queries), metric=metric)
    assert launch_counts()["gather_l2"] == 0
    _close_with_nan(ref, ours.numpy())
    masked = gather_dist(torch.from_numpy(data), torch.from_numpy(ids),
                         torch.from_numpy(queries), metric=metric).numpy()
    assert np.isinf(masked[ids < 0]).all()
    fixed = _fix_kernel_dist(torch.from_numpy(masked), metric).numpy()
    assert not np.isnan(fixed).any()


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("n,d", [(50, 32), (40, 13)])
def test_gather_q_plain_equals_pallas(metric, n, d):
    data, ids, queries = _inputs(n, d, 3, 8, seed=d + 1)
    codes_r, scale_r = ref_quantize(jnp.asarray(data))
    codes, scale = _quantize_rows(torch.from_numpy(data))
    assert np.array_equal(codes.numpy(), np.asarray(codes_r))  # round half to even
    assert np.array_equal(scale.numpy(), np.asarray(scale_r))
    ref = gather_dist_q_pallas(codes_r, scale_r, jnp.asarray(ids), jnp.asarray(queries),
                               metric=metric, interpret=True)
    ours = gather_dist_q_kernel(codes, scale, torch.from_numpy(ids),
                                torch.from_numpy(queries), metric=metric)
    _close_with_nan(ref, ours.numpy())
    masked = gather_dist_q(codes, scale, torch.from_numpy(ids), torch.from_numpy(queries),
                           metric=metric).numpy()
    assert np.isinf(masked[ids < 0]).all()


def test_quantize_half_to_even():
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32)
    q_r, _ = ref_quantize(jnp.asarray(x))
    q, _ = _quantize_rows(torch.from_numpy(x))
    assert np.array_equal(q.numpy(), np.asarray(q_r))
    assert q.numpy().tolist() == [[127, 0, 2, 2, 0, -2]]
