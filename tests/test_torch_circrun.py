"""Port parity for the circular-run scorer (`circrun`, kernel B6 on the card)
and the brute-force source built on it.

  * the port's `circrun` (its plain version on the CPU) equals the
    reference's `circrun_pallas` (interpret mode) and `circrun_ref` bit for
    bit: m in {5, 16, 64, 100}, negative symbols, all-match rows (length m),
    int32-max sentinel rows and batched queries;
  * `bruteforce_topk` equals the reference's in ids, values and tie order,
    -1 padded past n.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bruteforce import bruteforce_topk as ref_bruteforce_topk
from repro.kernels.circrun.circrun import circrun_pallas
from repro.kernels.circrun.ref import circrun_ref as ref_circrun_ref
from repro_torch.core.bruteforce import bruteforce_topk, circ_topk
from repro_torch.kernels.circrun import circrun, circrun_ref

torch.set_num_threads(2)

INT32_MAX = np.iinfo(np.int32).max


def _strings(n, m, B, alpha, seed):
    rng = np.random.default_rng(seed)
    h = rng.integers(-alpha, alpha, size=(n, m)).astype(np.int32)  # negative RP hashes
    q = rng.integers(-alpha, alpha, size=(B, m)).astype(np.int32)
    h[0] = q[0]  # all match: m
    h[1] = INT32_MAX  # a segment's sentinel row
    q[1] = INT32_MAX  # ... which a sentinel query matches everywhere
    h[2] = q[2]
    h[2, m // 2] = q[2, m // 2] + 1  # one mismatch: m - 1 (a run that wraps)
    return h, q


@pytest.mark.parametrize("alpha", [2, 50])
@pytest.mark.parametrize("m", [5, 16, 64, 100])
def test_circrun_equals_pallas_and_reference(m, alpha):
    h, q = _strings(300, m, 6, alpha, seed=m + alpha)
    ours = circrun(torch.from_numpy(h), torch.from_numpy(q)).numpy()
    assert ours.dtype == np.int32 and ours.shape == (6, 300)
    assert ours[0, 0] == m and ours[1, 1] == m and ours[2, 2] == m - 1
    for b in range(q.shape[0]):
        pallas = circrun_pallas(jnp.asarray(h), jnp.asarray(q[b]), block_n=128, interpret=True)
        ref = ref_circrun_ref(jnp.asarray(h), jnp.asarray(q[b]))
        np.testing.assert_array_equal(ours[b], np.asarray(pallas))
        np.testing.assert_array_equal(ours[b], np.asarray(ref))
    # a single query gives (n,), the same row
    single = circrun(torch.from_numpy(h), torch.from_numpy(q[3])).numpy()
    np.testing.assert_array_equal(single, ours[3])


def test_circrun_plain_chunks_queries(monkeypatch):
    from repro_torch.kernels.circrun import ref

    h, q = _strings(40, 8, 9, 3, seed=1)
    whole = circrun_ref(torch.from_numpy(h), torch.from_numpy(q))
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 2 * 40 * 16)  # 2 queries a chunk
    assert torch.equal(circrun_ref(torch.from_numpy(h), torch.from_numpy(q)), whole)


@pytest.mark.parametrize("n,lam", [(500, 40), (30, 64)])
def test_bruteforce_topk_matches_reference(n, lam):
    h, q = _strings(n, 16, 7, 2, seed=n)  # a small alphabet: many tied lengths
    r_ids, r_vals = ref_bruteforce_topk(jnp.asarray(h), jnp.asarray(q), lam)
    ids, vals = bruteforce_topk(torch.from_numpy(h), torch.from_numpy(q), lam)
    assert ids.dtype == torch.int32 and ids.shape == (7, lam)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))
    if n < lam:
        assert (ids.numpy()[:, n:] == -1).all() and (vals.numpy()[:, n:] == -1).all()


def test_circ_topk_chunks_and_masks(monkeypatch):
    from repro_torch.core import bruteforce

    h, q = _strings(64, 8, 5, 2, seed=3)
    h, q = torch.from_numpy(h), torch.from_numpy(q)
    ok = torch.ones(64, dtype=torch.bool)
    ok[0] = False  # the all-match row of query 0 drops out
    vals, rows = circ_topk(h, q, 10, ok)
    assert int(rows[0, 0]) != 0 and int(vals[0, 0]) < 8
    monkeypatch.setattr(bruteforce, "_LENS_ELEMS", 64 * 2)  # 2 queries a chunk
    v2, r2 = circ_topk(h, q, 10, ok)
    assert torch.equal(vals, v2) and torch.equal(rows, r2)
    # every row masked: all -1
    v3, _ = circ_topk(h, q, 3, torch.zeros(64, dtype=torch.bool))
    assert bool((v3 == -1).all())


@pytest.mark.parametrize("n,k,top", [(1000, 50, 3), (37, 37, 40), (200, 1, 0)])
def test_topk_largest_lcp_equals_stable_sort(n, k, top):
    """The unique-key top-k that the dedupe and circ_topk share equals the
    stable-sort `topk_largest` in values, ids and tie order, -1 scores
    included."""
    from repro_torch.core.lsh import topk_largest, topk_largest_lcp

    rng = np.random.default_rng(n)
    lcp = torch.from_numpy(rng.integers(-1, top + 1, size=(6, n)).astype(np.int32))
    vals, idx = topk_largest_lcp(lcp, k)
    s_vals, s_idx = topk_largest(lcp, k)
    assert vals.dtype == torch.int32 and idx.dtype == torch.int32
    assert torch.equal(vals, s_vals) and torch.equal(idx, s_idx.to(torch.int32))
