"""Port parity for the dynamic index (`repro_torch.core.segments`).

  1. The reference's own invariant, on the port: after any interleaving of
     insert/delete/compact, the port's segmented search returns the same
     (ids, dists) as the port's monolithic `LCCSIndex.build` over the live
     rows with the same family seed (lam and width cover the live corpus,
     so the candidate stage is exact and per-segment sets merge exactly).
  2. The same ops against the reference's `SegmentedLCCSIndex`, with the
     reference's family carried across: equal buffer hash strings, segment
     tables `I/P/Hd/L`, gids and alive mask; equal search ids, distances
     within rtol/atol 1e-5 (fp32 summation order).
  3. The reference's unit semantics that are not about jit or pytrees.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SearchParams as RefParams
from repro.core import SegmentedLCCSIndex as RefSegmented
from repro_torch.core import LCCSIndex, SearchParams, SegmentedLCCSIndex, family_from_arrays
from repro_torch.core.index import search as mono_search
from repro_torch.exec import stages
from repro_torch.store import make_store

torch.set_num_threads(2)

D, M, K, LAM = 6, 8, 5, 64
FAMILY_KW = dict(m=M, family="euclidean", w=4.0, seed=11)
SOURCES = ("bruteforce", "lccs", "multiprobe-full", "multiprobe-skip")

# the three deterministic interleavings of the reference's tests/test_segments.py
INTERLEAVINGS = {
    "buffer-only": [("insert", 1, 7), ("insert", 2, 5), ("delete", 3)],
    "segment+buffer+tombstones": [
        ("insert", 4, 9), ("compact", False), ("insert", 5, 6),
        ("delete", 6), ("insert", 7, 3),
    ],
    "tiered-merges": [
        ("insert", 8, 8), ("compact", False), ("insert", 9, 8),
        ("compact", False), ("delete", 10), ("compact", True),
        ("insert", 11, 4), ("delete", 12), ("compact", False),
    ],
}


def _random_ops(seed):
    rng = np.random.default_rng(seed * 7919 + 13)
    ops = [("insert", int(rng.integers(0, 2**20)), int(rng.integers(1, 9)))]
    for _ in range(int(rng.integers(1, 6))):
        kind = rng.choice(["insert", "delete", "compact"])
        if kind == "insert":
            ops.append(("insert", int(rng.integers(0, 2**20)), int(rng.integers(1, 9))))
        elif kind == "delete":
            ops.append(("delete", int(rng.integers(0, 2**20))))
        else:
            ops.append(("compact", bool(rng.integers(0, 2))))
    return ops


OPS = {**INTERLEAVINGS, **{f"random-{s}": _random_ops(s) for s in range(3)}}


def _params(source, cls=SearchParams):
    probes = 5 if source.startswith("multiprobe") else 1
    return cls(k=K, lam=LAM, source=source, probes=probes)


def _apply_ops(idx, ops):
    """Replay ops on `idx` (either package's index) and a plain corpus
    model.  Returns (live gids, live vectors)."""
    vecs, alive = [], []
    for op in ops:
        if op[0] == "insert":
            _, seed, count = op
            X = np.random.default_rng(seed).normal(size=(count, D)).astype(np.float32) * 3.0
            gids = idx.insert(X)
            assert list(gids) == list(range(len(vecs), len(vecs) + count))
            vecs.extend(X)
            alive.extend([True] * count)
        elif op[0] == "delete":
            live_ids = [g for g, a in enumerate(alive) if a]
            if len(live_ids) <= 1:
                continue  # keep the corpus non-empty
            rng = np.random.default_rng(op[1])
            dels = rng.choice(live_ids, size=rng.integers(1, len(live_ids)), replace=False)
            idx.delete(dels)
            for g in dels:
                alive[g] = False
        else:
            idx.compact(full=op[1])
    live = np.asarray([g for g, a in enumerate(alive) if a], dtype=np.int64)
    live_vecs = np.stack([vecs[g] for g in live]) if live.size else np.zeros((0, D), np.float32)
    return live, live_vecs


def _queries(seed=0):
    return np.random.default_rng(seed).normal(size=(4, D)).astype(np.float32) * 3.0


def _port_index(store="fp32"):
    return SegmentedLCCSIndex.create(D, store=store, device="cpu", **FAMILY_KW)


# -- 1. segmented == monolithic rebuild, on the port -------------------------


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("name", sorted(OPS))
def test_equivalent_to_monolithic_rebuild(name, source):
    idx = _port_index()
    live, live_vecs = _apply_ops(idx, OPS[name])
    Q = _queries(len(name))
    ids_s, d_s = idx.search(Q, _params(source))
    assert idx.n_live == live.size
    if live.size == 0:
        assert bool((ids_s == -1).all()) and bool(torch.isinf(d_s).all())
        return
    mono = LCCSIndex.build(live_vecs, device="cpu", **FAMILY_KW)
    ids_m, d_m = mono.search(Q, _params(source))
    ids_m = ids_m.numpy()
    mapped = np.where(ids_m >= 0, live[np.maximum(ids_m, 0)], -1)
    np.testing.assert_array_equal(ids_s.numpy(), mapped)
    np.testing.assert_allclose(d_s.numpy(), d_m.numpy(), rtol=1e-6, atol=1e-6)


# -- 2. the port against the reference's SegmentedLCCSIndex ------------------


def _carried(ref_family):
    fields = {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
              for f in dataclasses.fields(ref_family) for v in [getattr(ref_family, f.name)]}
    return family_from_arrays(type(ref_family).__name__, fields, "cpu")


def _assert_same_state(ref, ours):
    # buffer hash strings first: everything downstream follows from them
    np.testing.assert_array_equal(ours.buf_h.numpy(), np.asarray(ref.buf_h))
    np.testing.assert_array_equal(ours.buf_gid.numpy(), np.asarray(ref.buf_gid))
    assert ours.buffer_count == ref.buffer_count and ours.n_ids == ref.n_ids
    assert len(ours.segments) == len(ref.segments)
    for s_ref, s in zip(ref.segments, ours.segments):
        np.testing.assert_array_equal(s.h.numpy(), np.asarray(s_ref.h))
        for name in ("I", "P", "Hd", "L"):
            np.testing.assert_array_equal(getattr(s.csa, name).numpy(),
                                          np.asarray(getattr(s_ref.csa, name)))
        np.testing.assert_array_equal(s.gid.numpy(), np.asarray(s_ref.gid))
    np.testing.assert_array_equal(ours.alive.numpy(), np.asarray(ref.alive))
    assert ours.segment_sizes() == ref.segment_sizes()
    assert ours.index_bytes() == ref.index_bytes()
    assert ours.store_bytes() == ref.store_bytes()


@pytest.mark.parametrize("name,store", [(n, "fp32") for n in sorted(OPS)]
                         + [(n, "int8") for n in sorted(INTERLEAVINGS)])
def test_matches_reference_segmented_index(name, store):
    ref = RefSegmented.create(D, store=store, **FAMILY_KW)
    ours = _port_index(store)
    ours.family = _carried(ref.family)  # before the first insert
    _apply_ops(ref, OPS[name])
    _apply_ops(ours, OPS[name])
    _assert_same_state(ref, ours)
    Q = _queries(len(name))
    for source in SOURCES:
        r_ids, r_d = ref.search(jnp.asarray(Q), _params(source, RefParams))
        o_ids, o_d = ours.search(Q, _params(source))
        np.testing.assert_array_equal(o_ids.numpy(), np.asarray(r_ids))
        np.testing.assert_allclose(o_d.numpy(), np.asarray(r_d), rtol=1e-5, atol=1e-5)


# -- 3. dynamic-index unit semantics -----------------------------------------


def _fresh(n=12, seed=0):
    X = np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)
    idx = _port_index()
    return idx, X, idx.insert(X)


def test_insert_assigns_sequential_gids_and_grows():
    idx, _, gids = _fresh(12)
    assert gids.tolist() == list(range(12))
    assert idx.n_ids == 12 and idx.n_live == 12 and idx.buffer_count == 12
    more = idx.insert(torch.ones((3, D)))
    assert more.tolist() == [12, 13, 14]
    assert idx.store.shape[0] >= 15 and idx.buf_h.shape[0] >= 15
    assert idx.store.shape[0] == 16 and idx.alive.shape[0] == 16  # power-of-two capacity
    assert idx.insert(np.zeros((0, D), np.float32)).size == 0
    assert idx.insert(np.ones(D, np.float32)).tolist() == [15]  # one row


def test_delete_is_tombstone_and_idempotent():
    idx, _, gids = _fresh(10)
    assert idx.delete(gids[:4]) == 4
    assert idx.n_live == 6
    assert idx.delete(torch.from_numpy(gids[:4])) == 0  # already dead: no-op
    with pytest.raises(IndexError):
        idx.delete([99])
    with pytest.raises(IndexError):
        idx.delete([-1])
    ids, _ = idx.search(np.zeros((1, D), np.float32), SearchParams(k=10, lam=LAM))
    returned = set(ids[0].tolist()) - {-1}
    assert returned.isdisjoint(set(gids[:4].tolist()))


def test_delete_counts_duplicates_once():
    idx, _, gids = _fresh(10)
    assert idx.delete([gids[0], gids[0], gids[1]]) == 2
    assert idx.n_live == 8


def test_compact_drops_dead_rows_and_tiers_segments():
    idx, _, gids = _fresh(10)
    idx.delete(gids[:5])
    assert idx.compact() == 5  # only live rows merged
    assert idx.buffer_count == 0
    assert idx.segment_sizes() == [5]
    # a second small batch tiers into the existing segment (5 <= merge total)
    idx.insert(np.random.default_rng(1).normal(size=(6, D)).astype(np.float32))
    idx.compact()
    assert idx.segment_sizes() == [11]
    # a big segment is NOT rewritten by a small merge
    idx.insert(np.random.default_rng(2).normal(size=(2, D)).astype(np.float32))
    idx.compact()
    assert sorted(idx.segment_sizes()) == [2, 11]
    assert [s.cap for s in idx.segments] == [16, 8]  # largest first
    # full=True merges everything into one segment
    assert idx.compact(full=True) == 13 and idx.segment_sizes() == [13]


def test_compact_empty_and_dead_only_states():
    idx = _port_index()
    assert idx.compact() == 0 and idx.segments == ()
    gids = idx.insert(np.ones((4, D), np.float32))
    idx.delete(gids)
    assert idx.compact() == 0  # everything dead: nothing to merge
    assert idx.segments == () and idx.n_live == 0
    ids, dists = idx.search(np.zeros((2, D), np.float32), SearchParams(k=3))
    assert bool((ids == -1).all()) and bool(torch.isinf(dists).all())


def test_vacuum_reclaims_store_and_remaps_ids():
    idx, X, gids = _fresh(12)
    idx.compact()
    idx.delete(gids[2:10])
    grown_cap = idx.store.shape[0]
    remap = idx.vacuum()
    assert remap.tolist() == [0, 1] + [-1] * 8 + [2, 3]
    assert idx.n_ids == 4 and idx.n_live == 4
    assert idx.store.shape[0] < grown_cap or grown_cap == 8
    # search equals a monolithic index over the surviving rows, in the new ids
    Q = _queries(3)
    ids, d = idx.search(Q, _params("lccs"))
    mono = LCCSIndex.build(X[[0, 1, 10, 11]], device="cpu", **FAMILY_KW)
    ids_m, d_m = mono.search(Q, _params("lccs"))
    assert torch.equal(ids, ids_m)
    torch.testing.assert_close(d, d_m, rtol=1e-6, atol=1e-6)
    # vacuum of an all-dead index empties cleanly
    idx.delete(np.arange(4))
    assert idx.vacuum().tolist() == [-1] * 4
    assert idx.n_ids == 0 and idx.segments == ()


def test_build_bulk_loads_one_segment():
    X = np.random.default_rng(4).normal(size=(20, D)).astype(np.float32)
    idx = SegmentedLCCSIndex.build(X, device="cpu", **FAMILY_KW)
    assert idx.buffer_count == 0 and idx.segment_sizes() == [20]
    assert idx.segments[0].cap == 32 and int(idx.segments[0].gid[20]) == -1
    assert int(idx.segments[0].h[31, 0]) == torch.iinfo(torch.int32).max  # sentinel rows
    assert idx.total_bytes() == idx.index_bytes() + idx.store_bytes()
    lazy = SegmentedLCCSIndex.build(torch.from_numpy(X), compact=False, device="cpu",
                                    **FAMILY_KW)
    assert lazy.buffer_count == 20 and lazy.segments == ()
    assert torch.equal(idx.data[:20], lazy.data[:20])


def test_quantized_store_keeps_exact_tail():
    X = np.random.default_rng(5).normal(size=(9, D)).astype(np.float32)
    idx = _port_index("int8")
    idx.insert(X)
    assert idx.tail is not None and torch.equal(idx.data[:9], torch.from_numpy(X))
    want = make_store("int8", torch.from_numpy(X))
    assert torch.equal(idx.store.q[:9], want.q) and torch.equal(idx.store.scale[:9], want.scale)
    assert idx.store_bytes() == idx.store.nbytes() + idx.tail.numel() * 4


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_store_set_rows_padded_to_shape(kind):
    X = torch.from_numpy(np.random.default_rng(6).normal(size=(5, D)).astype(np.float32))
    s = make_store(kind, torch.zeros((4, D)))
    grown = s.padded_to(8)
    assert grown.shape == (8, D) and s.shape == (4, D) and s.padded_to(2) is s
    out = grown.set_rows(torch.tensor([1, 2, 3, 5, 7], dtype=torch.int32), X)
    assert out is grown  # in place
    want = make_store(kind, X).dense()
    torch.testing.assert_close(grown.dense()[[1, 2, 3, 5, 7]], want, rtol=0, atol=0)
    assert bool((grown.dense()[[0, 4, 6]] == 0).all())


def test_search_rewrites_source_and_rejects_recursion():
    idx, _, _ = _fresh(8)
    ids_a, _ = idx.search(np.zeros((1, D)), SearchParams(k=3, source="bruteforce"))
    ids_b, _ = idx.search(np.zeros((1, D)),
                          SearchParams(k=3, source="segmented", inner="bruteforce"))
    assert torch.equal(ids_a, ids_b)
    with pytest.raises(ValueError, match="recurse"):
        SearchParams(inner="segmented")
    with pytest.raises(ValueError, match="recurse"):
        idx.search(np.zeros((1, D)), SearchParams(k=3, source="sharded"))


def test_segmented_source_rejects_monolithic_index():
    X = np.random.default_rng(0).normal(size=(8, D)).astype(np.float32)
    mono = LCCSIndex.build(X, device="cpu", **FAMILY_KW)
    with pytest.raises(TypeError, match="SegmentedLCCSIndex"):
        mono_search(mono, torch.zeros((1, D)), SearchParams(source="segmented"))


def test_merge_stages_id_algebra():
    gid = torch.tensor([7, 3, -1, 9], dtype=torch.int32)
    local = torch.tensor([[0, 2, -1, 3]], dtype=torch.int32)
    g = stages.local_to_global(local, gid)
    assert g.tolist() == [[7, -1, -1, 9]]
    alive = torch.zeros(10, dtype=torch.bool)
    alive[[7, 3]] = True
    g2, v2 = stages.mask_dead(g, torch.tensor([[4, 5, 6, 7]], dtype=torch.int32), alive)
    assert g2.tolist() == [[7, -1, -1, -1]] and v2.tolist() == [[4, -1, -1, -1]]
    ids, vals = stages.pad_candidates(g2, v2, 6)
    assert ids.shape == (1, 6) and ids[0, 4:].tolist() == [-1, -1]
    m_ids, m_vals = stages.merge_candidates(
        torch.tensor([[5, 3, 5, -1]], dtype=torch.int32),
        torch.tensor([[1, 2, 4, -1]], dtype=torch.int32), 3)
    assert m_ids.tolist() == [[5, 3, -1]] and m_vals.tolist() == [[4, 2, -1]]
