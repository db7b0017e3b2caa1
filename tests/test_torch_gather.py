"""Port parity: the plain versions of the gather kernels equal the reference
Pallas kernels run in interpret mode (rtol 1e-5, atol 1e-6: fp32 summation
order), both metrics, zero rows (NaN from the unclamped angular norms) and
negative ids (row 0) included; the wrappers mask id < 0 to +inf.  On the
verify cases of tests/torch_verify_cases.py the port's `exact_topk` and
`survivors`, which take the fused verify (`store.gather_topk`) with the
kernels on, give the reference's ids (distances within the same
tolerance), and the fused plain versions equal the unfused route bit for
bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_verify_cases import VERIFY_CASES, make_case

import repro.core as ref_core
import repro.exec.stages as ref_stages
import repro.store.stores as ref_stores
from repro.kernels.gather_l2.gather_l2 import gather_dist_pallas
from repro.kernels.gather_q.gather_q import gather_dist_q_pallas
from repro.store.stores import _quantize_rows as ref_quantize
from repro_torch.core.params import SearchParams
from repro_torch.exec import stages
from repro_torch.kernels.common import launch_counts, reset_launch_counts
from repro_torch.kernels.gather_l2 import gather_dist, gather_dist_kernel
from repro_torch.kernels.gather_q import gather_dist_q, gather_dist_q_kernel
from repro_torch.store import stores
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


STORE_KINDS = {"fp32": ("Fp32Store", "gather_l2_topk"), "int8": ("Int8Store", "gather_q_topk")}


def _verify_inputs(case, kind):
    """The case's inputs for the port (torch) and the reference (jnp), each
    with its own store of `kind` built from the same rows."""
    data, ids, report, queries, k = make_case(case)
    cls = STORE_KINDS[kind][0]
    ours = (getattr(stores, cls).from_dense(torch.from_numpy(data)), torch.from_numpy(ids),
            torch.from_numpy(report), torch.from_numpy(queries))
    ref = (getattr(ref_stores, cls).from_dense(jnp.asarray(data)), jnp.asarray(ids),
           jnp.asarray(report), jnp.asarray(queries))
    return ours, ref, k


def _params(cls, case, k):
    L = VERIFY_CASES[case][3]
    return cls(k=k, lam=L, width=L, rerank_mult=4, use_gather_kernel=True)


@pytest.mark.parametrize("kind", list(STORE_KINDS))
@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("case", list(VERIFY_CASES))
def test_verify_stages_match_reference(case, metric, kind):
    """exact_topk (k of the report ids) and survivors (min(4k, L) of the
    candidates) with the gather kernels on: the port's fused route against
    the reference's Pallas scans in interpret mode + `lax.top_k`."""
    (st, ids, report, q), (rst, rids, rreport, rq), k = _verify_inputs(case, kind)
    reset_launch_counts()
    got = stages.exact_topk(st, q, ids, report, k, metric, True)
    want = ref_stages.exact_topk(rst, rq, rids, rreport, k, metric, True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    got = stages.survivors(st, q, ids, _params(SearchParams, case, k), metric)
    want = ref_stages.survivors(rst, rq, rids, _params(ref_core.SearchParams, case, k), metric)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    assert launch_counts()[STORE_KINDS[kind][1]] == 0  # CPU: the plain version


@pytest.mark.parametrize("kind", list(STORE_KINDS))
@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("case", list(VERIFY_CASES))
def test_fused_plain_equals_unfused_route(case, metric, kind):
    """The fused plain version (`store.gather_topk` on CPU tensors) equals
    the unfused route, `store.gather_dist` + `topk_ids` / `_smallest`, bit
    for bit."""
    (st, ids, report, q), _, k = _verify_inputs(case, kind)
    dist = st.gather_dist(ids, q, metric=metric, use_kernel=True)
    want = stages.topk_ids(dist, report, k)
    got = st.gather_topk(ids, q, k, metric=metric, report_ids=report)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    r = stages.survivor_budget(_params(SearchParams, case, k), ids.shape[1])
    vals, idx = stages._smallest(dist, r)
    got = st.gather_topk(ids, q, r, metric=metric, survivors=True)
    assert torch.equal(got[0], torch.gather(ids, 1, idx)) and torch.equal(got[1], vals)
    if ids.shape[0] > 1:  # the all -1 row: padding only
        assert bool((got[0][-1] == -1).all()) and bool(torch.isinf(got[1][-1]).all())
