"""Port parity of the pool top-lam (the CSA probe's dedupe): its plain
version `pool_topk_plain`, tile by tile as the CUDA kernel, is bit-identical
(ids, values and order) to the reference's `dedupe_topk_scatter` and to
`jax.vmap` of its `core.search.dedupe_topk`, at pools of one, two and many
tiles; the probe sources that dedupe through it equal the reference's
candidates at a tile small enough to split their pools."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_pool_cases import POOL_CASES, bands_mirror, make_pool

from repro.core import LCCSIndex as RefIndex
from repro.core import SearchParams as RefParams
from repro.core import SegmentedLCCSIndex as RefSegmented
from repro.core.search import dedupe_topk as ref_dedupe
from repro.exec import stages as ref_stages
from repro.kernels.csa_probe.ref import dedupe_topk_scatter as ref_scatter
from repro_torch.core import LCCSIndex, SearchParams, SegmentedLCCSIndex, family_from_arrays
from repro_torch.core.search import dedupe_topk
from repro_torch.exec import stages
from repro_torch.kernels.common import launch_counts, reset_launch_counts
from repro_torch.kernels.csa_probe import (
    dedupe_topk_scatter,
    pool_topk,
    pool_topk_plain,
    ref as probe_ref,
)

torch.set_num_threads(2)


def _eq(a, b):
    return np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", list(POOL_CASES))
def test_pool_topk_plain_equals_reference(monkeypatch, name):
    _, _, n, lam, tile, _, _ = POOL_CASES[name]
    if tile is not None:  # the wrapper's tiles
        monkeypatch.setattr(probe_ref, "POOL_TILE", tile)
    ids, lcps = make_pool(name)
    ti, tv = torch.from_numpy(ids), torch.from_numpy(lcps)
    pi, pv = pool_topk_plain(ti, tv, n, lam, tile=tile)
    assert pi.dtype == torch.int32 and pi.shape == (ids.shape[0], lam)
    ri, rv = ref_scatter(jnp.asarray(ids), jnp.asarray(lcps), n, lam)
    assert _eq(ri, pi) and _eq(rv, pv)  # ids, values and order
    if ids.shape[0]:
        li, lv = jax.vmap(lambda i, v: ref_dedupe(i, v, lam))(jnp.asarray(ids), jnp.asarray(lcps))
        assert _eq(li, pi) and _eq(lv, pv)
    for port_fn in (lambda: dedupe_topk_scatter(ti, tv, n, lam), lambda: dedupe_topk(ti, tv, lam)):
        oi, ov = port_fn()
        assert torch.equal(oi, pi) and torch.equal(ov, pv)
    # the wrapper on CPU tensors runs the plain version and launches nothing
    reset_launch_counts()
    wi, wv = pool_topk(ti, tv, n, lam)
    assert launch_counts()["pool_topk"] == 0
    assert torch.equal(wi, pi) and torch.equal(wv, pv)


@pytest.mark.parametrize("seed", range(6))
def test_pool_topk_plain_random_tiles(seed):
    """Random shapes and tiles, from tiles of one entry up to one tile."""
    rng = np.random.default_rng(seed)
    B, pool = int(rng.integers(1, 4)), int(rng.integers(1, 900))
    n, lam, tile = int(rng.integers(1, 3000)), int(rng.integers(1, 200)), int(rng.integers(1, 300))
    ids = rng.integers(-1, n, size=(B, pool)).astype(np.int32)
    lcps = rng.integers(-1, 257, size=(B, pool)).astype(np.int32)
    pi, pv = pool_topk_plain(torch.from_numpy(ids), torch.from_numpy(lcps), n, lam, tile=tile)
    ri, rv = ref_scatter(jnp.asarray(ids), jnp.asarray(lcps), n, lam)
    assert _eq(ri, pi) and _eq(rv, pv)


@pytest.mark.parametrize("name", list(POOL_CASES))
def test_pool_bands_mirror_equals_reference(name):
    """The kernel's band passes (tests/torch_pool_cases.py's mirror): over
    each tile the wrapper cuts, deduping only the entries at or above the
    last pass's floor gives the reference's deduped top k of the tile."""
    _, _, n, lam, tile, _, _ = POOL_CASES[name]
    ids, lcps = make_pool(name)
    k = min(lam, n)
    chunk = probe_ref.pool_chunk(k, n, tile)
    for lo in range(0, ids.shape[1], chunk):
        t_ids, t_lcps = ids[:, lo:lo + chunk], lcps[:, lo:lo + chunk]
        ri, rv = jax.vmap(lambda i, v: ref_dedupe(i, v, k))(jnp.asarray(t_ids),
                                                            jnp.asarray(t_lcps))
        for r in range(ids.shape[0]):
            mi, mv, floors = bands_mirror(t_ids[r], t_lcps[r], k)
            assert np.array_equal(np.asarray(ri[r]), mi) and np.array_equal(np.asarray(rv[r]), mv)
            assert floors == sorted(floors, reverse=True)


@pytest.mark.parametrize("name", list(POOL_CASES))
def test_pool_cut_stats(name):
    """`pool_cut_stats` (chip_smoke.py's pool_stats lines) against a plain
    count over each row's deduped ids."""
    _, _, n, lam, _, _, _ = POOL_CASES[name]
    ids, lcps = make_pool(name)
    k = min(lam, n)
    cut, above, entries, distinct = probe_ref.pool_cut_stats(
        torch.from_numpy(ids), torch.from_numpy(lcps), n, lam)
    for r in range(ids.shape[0]):
        live = (ids[r] >= 0) & (lcps[r] >= 0)
        best = {}
        for i, v in zip(ids[r][live].tolist(), np.minimum(lcps[r][live], 256).tolist()):
            best[i] = max(best.get(i, -1), v)
        ranked = sorted(best.values(), reverse=True)
        c = ranked[min(k, len(ranked)) - 1] if ranked and k >= 1 else -1
        assert int(cut[r]) == c and int(distinct[r]) == len(best)
        assert int(above[r]) == sum(v >= c for v in best.values())
        assert int(entries[r]) == int((live & (np.minimum(lcps[r], 256) >= c)).sum())


def test_pool_levels_promise_the_launches():
    """A pool of up to one tile (16,384 entries) takes one pass: the lccs
    pool and the serving pool; the multiprobe pools two; every pass at least
    halves a pool larger than a tile; ids past 2^23 take tiles of half the
    length."""
    levels = probe_ref.pool_levels
    assert levels(8_192, 100, 10**6) == [8_192]
    assert levels(12_800, 100, 10**6) == [12_800]  # the lccs pool at m 64, W 100
    assert levels(4_096, 64, 4_096) == [4_096]  # the serving pool at m 32, W 64
    assert levels(16_384, 100, 10**6) == [16_384]
    assert levels(106_496, 200, 10**6) == [106_496, 1_400]  # multiprobe-skip, 17 probes
    assert levels(139_264, 200, 10**6) == [139_264, 1_800]
    assert levels(139_264, 1024, 10**6) == [139_264, 9_216]
    assert levels(139_264, 4096, 10**6) == [139_264, 36_864, 12_288]
    assert levels(12_800, 100, 2**23 + 1) == [12_800, 200]
    assert probe_ref.pool_chunk(40, 10**6, 16) == 80  # a tile holds at least 2k entries
    rng = np.random.default_rng(0)
    for _ in range(200):
        pool, k, tile = (int(x) for x in rng.integers(1, 5000, 3))
        n = int(rng.choice([1000, 2**30]))
        chunk = probe_ref.pool_chunk(k, n, tile)
        lv = levels(pool, k, n, tile)
        assert lv[-1] <= chunk or len(lv) == 1
        for a, b in zip(lv, lv[1:]):
            assert a > chunk and b <= (a + chunk) // 2


def test_pool_topk_rejects_other_devices():
    meta = torch.empty((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pool_topk(meta, meta, 10, 4)


N, D, M = 1500, 16, 12


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """An index built and saved by the reference, loaded by the port."""
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(20, D)) * 3.0
    X = (centers[rng.integers(0, 20, N)] + rng.normal(size=(N, D))).astype(np.float32)
    Q = (X[rng.choice(N, 10, replace=False)] + 0.05 * rng.normal(size=(10, D))).astype(np.float32)
    ref = RefIndex.build(X, m=M, family="euclidean", w=4.0, seed=2)
    path = tmp_path_factory.mktemp("idx") / "index.pkl"
    ref.save(path)
    return ref, LCCSIndex.load(path, device="cpu"), Q


@pytest.mark.parametrize("tile", [None, 64, 7])
@pytest.mark.parametrize("source", ["lccs", "multiprobe-full", "multiprobe-skip"])
def test_sources_equal_reference_at_small_tiles(pair, monkeypatch, source, tile):
    """The fused probe sources through `pool_topk` on CPU, with the pool
    split into tiles of `tile` entries (widened to 2 lam), give the
    reference's candidates for the same query hash strings."""
    ref, ours, Q = pair
    if tile is not None:
        monkeypatch.setattr(probe_ref, "POOL_TILE", tile)
    kw = dict(k=5, lam=40, width=16, source=source, probes=7, use_probe_kernel=True)
    qh = ref_stages.hash_queries(ref.family, Q)
    r_ids, r_lcps = ref_stages.probe(ref, Q, qh, RefParams(**kw))
    reset_launch_counts()
    o_ids, o_lcps = stages.probe(ours, torch.from_numpy(Q), torch.from_numpy(np.array(qh)),
                                 SearchParams(**kw))
    assert launch_counts()["pool_topk"] == 0
    assert np.array_equal(o_ids.numpy(), np.asarray(r_ids))
    assert np.array_equal(o_lcps.numpy(), np.asarray(r_lcps))


@pytest.mark.parametrize("inner", ["lccs", "multiprobe-skip"])
def test_segmented_equals_reference_at_small_tiles(monkeypatch, inner):
    """The dynamic index reaches `pool_topk` through each segment's inner
    source: the same candidates as the reference's segmented index."""
    monkeypatch.setattr(probe_ref, "POOL_TILE", 32)
    rng = np.random.default_rng(11)
    X = (rng.normal(size=(900, D)) * 2).astype(np.float32)
    idx = {}
    for name, cls, kw in (("ref", RefSegmented, {}), ("ours", SegmentedLCCSIndex,
                                                     dict(device="cpu"))):
        ix = cls.create(D, m=M, family="euclidean", w=4.0, seed=1, **kw)
        if name == "ours":  # the reference's family, carried across
            fam = idx["ref"].family
            ix.family = family_from_arrays(type(fam).__name__, {
                f.name: np.asarray(v) if isinstance(v, jax.Array) else v
                for f in dataclasses.fields(fam) for v in [getattr(fam, f.name)]}, "cpu")
        ix.insert(X[:600])
        ix.compact()
        ix.insert(X[600:])
        ix.delete(np.arange(0, 900, 11))
        idx[name] = ix
    Q = X[:8] + 0.1
    p = dict(k=5, lam=30, width=12, source="segmented", inner=inner, probes=5,
             use_probe_kernel=True)
    qh = ref_stages.hash_queries(idx["ref"].family, Q)
    r_ids, r_lcps = ref_stages.probe(idx["ref"], Q, qh, RefParams(**p))
    o_ids, o_lcps = stages.probe(idx["ours"], torch.from_numpy(Q),
                                 torch.from_numpy(np.array(qh)), SearchParams(**p))
    assert np.array_equal(o_ids.numpy(), np.asarray(r_ids))
    assert np.array_equal(o_lcps.numpy(), np.asarray(r_lcps))
