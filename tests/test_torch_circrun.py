"""Port parity for the circular-run scorer (`circrun`, kernel B6 on the card)
and the brute-force source built on it.

  * the port's `circrun` (its plain version on the CPU) equals the
    reference's `circrun_pallas` (interpret mode) and `circrun_ref` bit for
    bit: m in {5, 16, 64, 100}, negative symbols, all-match rows (length m),
    int32-max sentinel rows and batched queries;
  * `bruteforce_topk` and `circ_topk` (the plain route of the card's
    `circrun_topk`) equal the reference's `bruteforce_topk`, and the delta
    buffer's `_buffer_topk` the reference's, in ids, values and tie order
    (alphabet 2, dead and free slots, -1 padded past the live rows);
  * the card route's stored-length layout keeps a chunk within 256 MB.
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


def _binary(n, m, B, seed):
    """Alphabet 2: ties at every length."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, size=(n, m)).astype(np.int32),
            rng.integers(0, 2, size=(B, m)).astype(np.int32))


@pytest.mark.parametrize("n,B,lam", [(97, 13, 1), (97, 13, 97), (1037, 45, 100),
                                     (5003, 7, 4096)])
def test_circ_topk_matches_reference_bruteforce(n, B, lam):
    """The plain route of circ_topk / bruteforce_topk against the reference's
    bruteforce_topk in ids, values and tie order: k = 1, k = n, n and B off
    every tile, k at the card kernel's limit."""
    h, q = _binary(n, 16, B, seed=n + lam)
    r_ids, r_vals = ref_bruteforce_topk(jnp.asarray(h), jnp.asarray(q), lam)
    ids, vals = bruteforce_topk(torch.from_numpy(h), torch.from_numpy(q), lam)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))
    v, r = circ_topk(torch.from_numpy(h), torch.from_numpy(q), min(lam, n))
    assert torch.equal(r, ids[:, :n]) and torch.equal(v, vals[:, :n])


@pytest.mark.parametrize("cap,fill,dead,lam", [(64, 50, 0.2, 16), (64, 10, 0.3, 40),
                                               (128, 128, 0.1, 128), (64, 37, 0.5, 1),
                                               (8, 3, 0.0, 64)])
def test_buffer_topk_matches_reference(cap, fill, dead, lam):
    """The port's delta-buffer scorer against the reference's `_buffer_topk`
    on the same buffer: dead and free slots (sentinel strings, gid -1), fewer
    live rows than k (-1 values), k = the buffer's capacity and k = 1, in
    ids, values and tie order."""
    from repro.core import SegmentedLCCSIndex as RefSegmented
    from repro.core.segments import _buffer_topk as ref_buffer_topk
    from repro_torch.core import SegmentedLCCSIndex
    from repro_torch.core.segments import _buffer_topk

    m = 12
    rng = np.random.default_rng(cap + fill + lam)
    h, q = _binary(cap, m, 9, seed=fill)
    h[fill:] = INT32_MAX  # free slots
    gid = np.full(cap, -1, np.int32)
    gid[:fill] = rng.permutation(3 * cap)[:fill]
    alive = rng.random(3 * cap) >= dead
    ref = RefSegmented.create(4, m=m, w=4.0)
    ref.buf_h, ref.buf_gid, ref.alive = jnp.asarray(h), jnp.asarray(gid), jnp.asarray(alive)
    port = SegmentedLCCSIndex.create(4, m=m, w=4.0, device="cpu")
    port.buf_h, port.buf_gid = torch.from_numpy(h), torch.from_numpy(gid)
    port.alive = torch.from_numpy(alive)
    r_ids, r_vals = ref_buffer_topk(ref, jnp.asarray(q), lam)
    ids, vals = _buffer_topk(port, torch.from_numpy(q), lam)
    assert ids.shape == (9, lam) and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))
    live = int((alive[gid[gid >= 0]]).sum())
    if live < lam:
        assert (vals.numpy()[:, live:] == -1).all() and (ids.numpy()[:, live:] == -1).all()


@pytest.mark.parametrize("k", [1, 30, 200])
def test_circrun_topk_plain_equals_stable_sort(k):
    """circrun_topk_plain -- the card kernels' plain version -- equals a
    stable descending sort of the masked lengths (ties to the lower row),
    masked rows at -1 and sentinel rows included."""
    from repro_torch.core.lsh import topk_largest
    from repro_torch.kernels.circrun import circrun_topk_plain

    h, q = _strings(200, 10, 6, 2, seed=k)
    h, q = torch.from_numpy(h), torch.from_numpy(q)
    ok = torch.from_numpy(np.random.default_rng(k).random(200) < 0.6)
    vals, rows = circrun_topk_plain(h, q, k, ok)
    lens = torch.where(ok, circrun_ref(h, q), torch.full((6, 200), -1, dtype=torch.int32))
    s_vals, s_rows = topk_largest(lens, k)
    assert torch.equal(vals, s_vals) and torch.equal(rows, s_rows.to(torch.int32))


@pytest.mark.parametrize("n,m", [(1_000_000, 64), (65_536, 64), (1000, 300), (3, 8),
                                 (2**27, 300)])
def test_stored_layout_bounds_a_chunk(n, m):
    """The card route's stored lengths: a byte a row up to m = 254 (two
    above), rows padded to a multiple of 32, at most NARROW_BYTES a chunk of
    queries, in whole groups of 32 queries where more than 32 fit."""
    from repro_torch.kernels.circrun import ops

    dtype, ld, step = ops.stored_layout(n, m)
    assert dtype == (torch.uint8 if m <= 254 else torch.int16)
    assert ld % 32 == 0 and n <= ld < n + 32
    assert step >= 1 and (step == 1 or step * ld * dtype.itemsize <= ops.NARROW_BYTES)
    assert step % 32 == 0 or step < 32
    if (n, m) == (1_000_000, 64):  # the bruteforce source: 4 chunks of a 1,000-query batch
        assert step == 256


def test_circrun_topk_rejects_another_device():
    from repro_torch.kernels.circrun import circrun_topk

    h = torch.zeros((10, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        circrun_topk(h, h[:2], 3)
