"""Port parity for the out-of-core build (`repro_torch.core.csa`
`build_csa_chunked` / `csa_from_chunk_ranks`, `LCCSIndex.build_streaming`,
`SegmentedLCCSIndex.ingest_chunks`, `store.concat_stores`,
`store.TailWriter`, the chunk generators), on the CPU:

  1. Bit-identical to the port's own monolithic build for every chunking of
     the same rows: CSA tables (pad-sentinel rows included), hash strings,
     stores, tails, search results.
  2. Bit-identical to the reference's chunked build (`repro.core.csa`
     `build_csa_chunked`, `build_streaming` and `ingest_chunks` with the
     reference's family carried across): the same tables, stores and
     gids, the same search ids, distances within rtol/atol 1e-5 (fp32
     summation order), a byte-equal `.npy` tail, the same generated rows.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

try:  # a dev dependency: without it the property sweep is not defined, and
    # the seeded cases below still hold the same tables
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover
    st = None

from repro.core import LCCSIndex as RefIndex
from repro.core import SearchParams as RefParams
from repro.core import SegmentedLCCSIndex as RefSegmented
from repro.core.csa import build_csa_chunked as ref_build_csa_chunked
from repro.core.index import _reblock as ref_reblock
from repro.data import synthetic as ref_synth
from repro.store import TailWriter as RefTailWriter
from repro_torch.core import LCCSIndex, SearchParams, Segment, SegmentedLCCSIndex
from repro_torch.core import family_from_arrays
from repro_torch.core import lsh as lsh_mod
from repro_torch.core.csa import build_csa, build_csa_chunked, csa_from_chunk_ranks
from repro_torch.core.index import _reblock, iter_row_blocks
from repro_torch.data import synthetic
from repro_torch.store import TailWriter, concat_stores, make_store

torch.set_num_threads(2)

PAD = np.iinfo(np.int32).max
TOL = dict(rtol=1e-5, atol=1e-5)
STORES = ("fp32", "bf16", "int8")


def _data(n=120, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(7, d)) * 4.0
    return (centers[rng.integers(0, 7, n)] + rng.normal(size=(n, d))).astype(np.float32)


def _chunk_sizes(n):
    return (1, 7, max(n - 1, 1), n, n + 5)


def _tables(csa):
    return [t.numpy() for t in csa.tables()]


def _store_fields(store):
    return {f.name: getattr(store, f.name) for f in dataclasses.fields(store)}


def _assert_index_equal(a: LCCSIndex, b: LCCSIndex):
    assert torch.equal(a.h, b.h)
    for name, x, y in zip("I P Hd L".split(), a.csa.tables(), b.csa.tables()):
        assert torch.equal(x, y), name
    fa, fb = _store_fields(a.store), _store_fields(b.store)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    assert (a.tail is None) == (b.tail is None)
    if a.tail is not None:
        assert torch.equal(a.tail, b.tail)


def _assert_same_as_reference(ours: LCCSIndex, ref):
    """Port tables / hash / store / tail equal to a reference index's."""
    assert np.array_equal(ours.h.numpy(), np.asarray(ref.h))
    for name, x, y in zip("I P Hd L".split(), ours.csa.tables(), ref.csa):
        assert np.array_equal(x.numpy(), np.asarray(y)), name
    for k, v in _store_fields(ours.store).items():
        want = np.asarray(getattr(ref.store, k))
        got = v.view(torch.int16).numpy().view(want.dtype) if v.dtype == torch.bfloat16 \
            else v.numpy()
        assert np.array_equal(got, want), k
    assert (ours.tail is None) == (ref.tail is None)
    if ours.tail is not None:
        assert np.array_equal(ours.tail.numpy(), np.asarray(ref.tail))


def _carried(ref_family):
    """The reference's family as a port family on the CPU."""
    fields = {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
              for f in dataclasses.fields(ref_family) for v in [getattr(ref_family, f.name)]}
    return family_from_arrays(type(ref_family).__name__, fields, "cpu")


def _use_family(monkeypatch, ref_family):
    """Make the port's builds draw the reference's family."""
    fam = _carried(ref_family)
    monkeypatch.setattr(lsh_mod, "make_family", lambda *a, **k: fam)
    return fam


# ---------------------------------------------------------------------------
# 1. the chunked CSA tables
# ---------------------------------------------------------------------------


if st is not None:
    @st.composite
    def hash_matrices(draw):
        """Small (n, m) int32 hash matrices: a narrow or a mixed value range,
        and a run of pad-sentinel rows (int32 max) that tie across chunks down
        to depth m."""
        n = draw(st.integers(2, 40))
        m = draw(st.integers(1, 9))
        lo = draw(st.integers(-20, 0))
        hi = lo + draw(st.integers(0, 6))
        seed = draw(st.integers(0, 2**31 - 1))
        h = np.random.default_rng(seed).integers(lo, hi + 1, size=(n, m)).astype(np.int32)
        pads = draw(st.integers(0, n // 2))
        if pads:
            h[n - pads:] = PAD
        return h

    @settings(max_examples=15, deadline=None)
    @given(hash_matrices())
    def test_chunked_tables_bit_identical_property(h):
        """At chunk sizes 1, 7, n-1, n and > n the chunked tables equal the
        port's monolithic `build_csa`; at chunk size 7 also the reference's
        `build_csa_chunked`."""
        n = h.shape[0]
        mono = _tables(build_csa(torch.from_numpy(h)))
        for cr in _chunk_sizes(n):
            got = _tables(build_csa_chunked(h, chunk_rows=cr, device="cpu"))
            for name, a, b in zip("I P Hd L".split(), got, mono):
                assert a.dtype == np.int32 and np.array_equal(a, b), (name, cr)
        ref = ref_build_csa_chunked(h, chunk_rows=7)
        for name, a, b in zip("I P Hd L".split(), got, ref):
            assert np.array_equal(a, np.asarray(b)), name


@pytest.mark.parametrize("n,m,lo,hi,pads", [
    (200, 8, -3, 3, 0),        # narrow range: 3 bits a symbol, pack 21
    (301, 7, 0, 1, 40),        # heavy ties + pad rows: bits 31, pack 2
    (96, 16, -40, 40, 33),     # mixed range and pads: bits 32, pack 2
    (64, 1, 0, 4, 10),         # m == 1
    (50, 5, 0, 0, 0),          # every string equal: ids break every tie
])
def test_chunked_tables_match_reference(n, m, lo, hi, pads):
    h = np.random.default_rng(n * m).integers(lo, hi + 1, size=(n, m)).astype(np.int32)
    if pads:
        h[n - pads:] = PAD
    mono = _tables(build_csa(torch.from_numpy(h)))
    for cr in _chunk_sizes(n):
        got = _tables(build_csa_chunked(h, chunk_rows=cr, device="cpu"))
        ref = ref_build_csa_chunked(h, chunk_rows=cr)
        for name, a, b, c in zip("I P Hd L".split(), got, ref, mono):
            assert np.array_equal(a, np.asarray(b)), (name, cr)
            assert np.array_equal(a, c), (name, cr)


def test_chunked_build_refuses_bad_chunking():
    h = np.zeros((10, 4), np.int32)
    with pytest.raises(ValueError, match="chunk_rows"):
        build_csa_chunked(h, chunk_rows=0, device="cpu")
    with pytest.raises(ValueError, match="do not cover"):
        csa_from_chunk_ranks(h, [3, 3], [np.zeros((3, 4))] * 2, device="cpu")


# ---------------------------------------------------------------------------
# 2. build_streaming / build(chunk_rows=)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("chunk_rows", [1, 7, 60, 120, 200])
def test_build_streaming_matches_monolithic(store, chunk_rows):
    X = _data()
    mono = LCCSIndex.build(X, m=8, store=store, seed=3, device="cpu")
    stream = LCCSIndex.build_streaming(iter_row_blocks(X, chunk_rows), m=8, store=store,
                                       seed=3, device="cpu")
    _assert_index_equal(mono, stream)


@pytest.mark.parametrize("store", STORES)
def test_build_streaming_matches_reference(store, monkeypatch):
    X = _data(n=150)
    ref = RefIndex.build_streaming(iter_row_blocks(X, 40), m=8, store=store, seed=3)
    _use_family(monkeypatch, ref.family)
    ours = LCCSIndex.build_streaming(iter_row_blocks(X, 40), m=8, store=store, seed=3,
                                     device="cpu")
    _assert_same_as_reference(ours, ref)
    Q = X[:9] + 0.01
    for source in ("lccs", "multiprobe-skip"):
        kw = dict(k=5, lam=24, width=8, source=source, probes=5 if "multi" in source else 1)
        r_ids, r_d = ref.search(Q, RefParams(**kw))
        o_ids, o_d = ours.search(Q, SearchParams(**kw))
        assert np.array_equal(o_ids.numpy(), np.asarray(r_ids)), source
        np.testing.assert_allclose(o_d.numpy(), np.asarray(r_d), **TOL)


@pytest.mark.parametrize("use_probe_kernel", [False, True])
def test_streaming_search_results_identical(use_probe_kernel):
    X = _data(n=200)
    params = SearchParams(k=5, lam=20, source="lccs", width=8, store="int8",
                          use_probe_kernel=use_probe_kernel)
    mono = LCCSIndex.build(X, m=8, store="int8", seed=1, device="cpu")
    stream = LCCSIndex.build_streaming(iter_row_blocks(X, 33), m=8, store="int8", seed=1,
                                       device="cpu")
    Q = X[:9] + 0.01
    mi, md = mono.search(Q, params)
    si, sd = stream.search(Q, params)
    assert torch.equal(mi, si) and torch.equal(md, sd)


def test_build_chunk_rows_routes_to_streaming(monkeypatch):
    X = _data(n=40)
    seen = []
    real = LCCSIndex.build_streaming

    def spy(chunks, **kw):
        chunks = list(chunks)
        seen.append([c.shape[0] for c in chunks])
        return real(iter(chunks), **kw)

    monkeypatch.setattr(LCCSIndex, "build_streaming", staticmethod(spy))
    routed = LCCSIndex.build(X, m=8, seed=2, chunk_rows=16, device="cpu")
    assert seen == [[16, 16, 8]]
    _assert_index_equal(routed, LCCSIndex.build(X, m=8, seed=2, device="cpu"))


def test_streaming_disk_tail(tmp_path):
    """A streamed disk tail: the file is byte-equal to the reference's
    `TailWriter` file of the same rows and to `np.save`'s, and searching it
    (the plan's host gather) gives the monolithic disk-tail index's ids."""
    X = _data(n=90)
    ours = LCCSIndex.build(X, m=8, store="int8", seed=4, device="cpu", chunk_rows=25,
                           tail_path=tmp_path / "ours")
    assert ours.tail is None and ours.tail_path.endswith("ours.npy")
    ref_w = RefTailWriter(tmp_path / "ref", X.shape[1])
    for block in iter_row_blocks(X, 25):
        ref_w.append(block)
    ref_path = ref_w.finalize()
    np.save(tmp_path / "plain.npy", X)
    data = open(ours.tail_path, "rb").read()
    assert data == open(ref_path, "rb").read()
    assert np.array_equal(np.load(ours.tail_path), X)
    assert np.array_equal(np.load(tmp_path / "plain.npy"), np.load(ours.tail_path))
    mono = LCCSIndex.build(X, m=8, store="int8", seed=4, device="cpu",
                           tail_path=tmp_path / "mono")
    p = SearchParams(k=5, lam=30, width=8, store="int8")
    mi, md = mono.search(X[:7] + 0.01, p)
    si, sd = ours.search(X[:7] + 0.01, p)
    assert torch.equal(mi, si) and torch.equal(md, sd)


@pytest.mark.parametrize("blocks", [[5], [1, 1, 1], [40, 3, 17], [64, 64]])
def test_tail_writer_bytes_equal_reference(tmp_path, blocks):
    rng = np.random.default_rng(len(blocks))
    ours, ref = TailWriter(tmp_path / "o.npy", 6), RefTailWriter(tmp_path / "r.npy", 6)
    for b in blocks:
        rows = rng.normal(size=(b, 6)).astype(np.float32)
        ours.append(rows)
        ref.append(rows)
    assert ours.finalize() == str(tmp_path / "o.npy")
    assert ours.finalize() == str(tmp_path / "o.npy")  # idempotent
    assert open(tmp_path / "o.npy", "rb").read() == open(ref.finalize(), "rb").read()
    with pytest.raises(ValueError, match="finalized"):
        ours.append(np.zeros((1, 6), np.float32))
    with pytest.raises(ValueError, match="expected"):
        TailWriter(tmp_path / "x", 6).append(np.zeros((2, 5), np.float32))


def test_streaming_reblocks_producer_chunking():
    """`chunk_rows` re-blocks a ragged producer: the CSA chunks are the
    re-blocked ones, and the index is the monolithic one."""
    X = _data(n=100)
    ragged = [X[:13], X[13:14], X[14:77], X[77:]]
    stream = LCCSIndex.build_streaming(iter(ragged), m=8, seed=5, chunk_rows=30,
                                       device="cpu")
    _assert_index_equal(stream, LCCSIndex.build(X, m=8, seed=5, device="cpu"))


@pytest.mark.parametrize("sizes,chunk_rows", [([13, 1, 63, 23], 30), ([5, 5, 5], 5),
                                              ([7], 3), ([2, 2, 2, 2], 100)])
def test_reblock_block_sizes(sizes, chunk_rows):
    rows = np.arange(sum(sizes) * 2, dtype=np.float32).reshape(-1, 2)
    parts = np.split(rows, np.cumsum(sizes)[:-1])
    ours = list(_reblock(iter(parts), chunk_rows))
    ref = list(ref_reblock(iter(parts), chunk_rows))
    assert [b.shape[0] for b in ours] == [b.shape[0] for b in ref]
    assert all(b.shape[0] == chunk_rows for b in ours[:-1])
    assert np.array_equal(np.concatenate(ours), rows)
    # tensor blocks (the engine's embeddings) re-block alike, as tensors
    as_t = list(_reblock(iter([torch.from_numpy(b) for b in parts]), chunk_rows))
    assert all(isinstance(b, torch.Tensor) for b in as_t)
    assert [b.numpy().tolist() for b in as_t] == [b.tolist() for b in ours]
    with pytest.raises(ValueError, match="chunk_rows"):
        list(_reblock(iter(parts), 0))


def test_iter_row_blocks_reads_a_memmap_block_by_block(tmp_path):
    X = _data(n=70)
    np.save(tmp_path / "x.npy", X)
    mm = np.load(tmp_path / "x.npy", mmap_mode="r")
    blocks = list(iter_row_blocks(mm, 32))
    assert [b.shape[0] for b in blocks] == [32, 32, 6]
    assert all(isinstance(b, np.memmap) for b in blocks)  # views, never read whole
    with pytest.raises(ValueError, match="chunk_rows"):
        list(iter_row_blocks(mm, 0))
    _assert_index_equal(LCCSIndex.build(mm, m=8, seed=6, chunk_rows=32, device="cpu"),
                        LCCSIndex.build(X, m=8, seed=6, device="cpu"))


def test_build_streaming_rejects_empty_stream():
    with pytest.raises(ValueError, match="at least one chunk"):
        LCCSIndex.build_streaming(iter(()), m=8, device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        LCCSIndex.build_streaming(iter([np.zeros((0, 4), np.float32)]), m=8, device="cpu")


@pytest.mark.parametrize("store", STORES)
def test_concat_stores_matches_one_shot_quantize(store):
    X = torch.from_numpy(_data(n=50))
    whole = make_store(store, X)
    parts = concat_stores([make_store(store, X[:11]), make_store(store, X[11:12]),
                           make_store(store, X[12:])])
    fw, fp = _store_fields(whole), _store_fields(parts)
    for k in fw:
        assert torch.equal(fw[k], fp[k]), k
    single = make_store(store, X)
    assert concat_stores([single]) is single
    with pytest.raises(ValueError, match="at least one"):
        concat_stores([])


def test_concat_stores_refuses_mixed_kinds():
    X = torch.from_numpy(_data(n=10))
    with pytest.raises(ValueError, match="mixed store kinds"):
        concat_stores([make_store("fp32", X), make_store("int8", X)])


# ---------------------------------------------------------------------------
# 3. the chunk generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("clustered_vector_chunks", dict(n=1000, d=12, chunk_rows=300, seed=4)),
    ("clustered_vector_chunks", dict(n=77, d=5, chunk_rows=77, seed=1, normalize=True,
                                     n_clusters=7)),
    ("embedding_vector_chunks", dict(n=500, d=16, chunk_rows=128, seed=2, decay=1.5)),
])
def test_chunk_generators_match_reference(name, kw):
    ours = list(getattr(synthetic, name)(**kw))
    ref = list(getattr(ref_synth, name)(**kw))
    assert len(ours) == len(ref) == -(-kw["n"] // kw["chunk_rows"])
    for a, b in zip(ours, ref):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_embedding_vectors_match_reference():
    for d, decay, seed in ((16, 1.0, 0), (9, 2.0, 5)):
        basis, mean = synthetic._embedding_basis(d, decay, seed)
        r_basis, r_mean = ref_synth._embedding_basis(d, decay, seed)
        assert np.array_equal(basis, r_basis) and np.array_equal(mean, r_mean)
        X = synthetic.embedding_vectors(300, d, decay=decay, seed=seed)
        assert np.array_equal(X, ref_synth.embedding_vectors(300, d, decay=decay, seed=seed))
        np.testing.assert_allclose(np.linalg.norm(X, axis=1), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# 4. the segmented side
# ---------------------------------------------------------------------------


def test_segment_build_chunked_parity():
    rng = np.random.default_rng(7)
    h = rng.integers(-2, 3, size=(37, 6)).astype(np.int32)
    gids = np.arange(100, 137, dtype=np.int32)
    mono = Segment.build(torch.from_numpy(h), torch.from_numpy(gids))
    for cr in (1, 9, 64):
        seg = Segment.build(torch.from_numpy(h), torch.from_numpy(gids), chunk_rows=cr)
        assert seg.cap == mono.cap == 64
        assert torch.equal(seg.h, mono.h) and torch.equal(seg.gid, mono.gid)
        for a, b in zip(seg.csa.tables(), mono.csa.tables()):
            assert torch.equal(a, b)


def _assert_segmented_equal(a: SegmentedLCCSIndex, b: SegmentedLCCSIndex):
    assert a.n_alloc == b.n_alloc and torch.equal(a.alive, b.alive)
    assert [s.cap for s in a.segments] == [s.cap for s in b.segments]
    for sa, sb in zip(a.segments, b.segments):
        assert torch.equal(sa.h, sb.h) and torch.equal(sa.gid, sb.gid)
        for x, y in zip(sa.csa.tables(), sb.csa.tables()):
            assert torch.equal(x, y)
    fa, fb = _store_fields(a.store), _store_fields(b.store)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("store", STORES)
def test_ingest_chunks_matches_insert_then_compact(store):
    X = _data(n=150)
    A = SegmentedLCCSIndex.create(8, m=8, seed=2, store=store, device="cpu")
    gids = A.ingest_chunks(iter_row_blocks(X, 45))
    B = SegmentedLCCSIndex.create(8, m=8, seed=2, store=store, device="cpu")
    for block in iter_row_blocks(X, 45):
        B.insert(block)
    B.compact()
    assert np.array_equal(gids, np.arange(150))
    assert A.buffer_count == 0
    _assert_segmented_equal(A, B)
    p = SearchParams(k=5, lam=40, width=16)
    ai, ad = A.search(X[:8] + 0.01, p)
    bi, bd = B.search(X[:8] + 0.01, p)
    assert torch.equal(ai, bi) and torch.equal(ad, bd)


@pytest.mark.parametrize("store", ["fp32", "int8"])
def test_ingest_chunks_matches_reference(store):
    X = _data(n=130)
    ref = RefSegmented.create(8, m=8, family="euclidean", w=4.0, seed=11, store=store)
    r_gids = ref.ingest_chunks(iter_row_blocks(X, 50))
    ours = SegmentedLCCSIndex.create(8, m=8, family="euclidean", w=4.0, seed=11, store=store,
                                     device="cpu")
    ours.family = _carried(ref.family)
    o_gids = ours.ingest_chunks(iter_row_blocks(X, 50))
    assert np.array_equal(o_gids, r_gids)
    assert [s.cap for s in ours.segments] == [int(s.cap) for s in ref.segments]
    for so, sr in zip(ours.segments, ref.segments):
        assert np.array_equal(so.h.numpy(), np.asarray(sr.h))
        assert np.array_equal(so.gid.numpy(), np.asarray(sr.gid))
        for name, a, b in zip("I P Hd L".split(), so.csa.tables(), sr.csa):
            assert np.array_equal(a.numpy(), np.asarray(b)), name
    for k, v in _store_fields(ours.store).items():
        assert np.array_equal(v.numpy(), np.asarray(getattr(ref.store, k))), k
    Q = X[:9] + 0.01
    kw = dict(k=5, lam=40, width=16)
    r_ids, r_d = ref.search(Q, RefParams(**kw))
    o_ids, o_d = ours.search(Q, SearchParams(**kw))
    assert np.array_equal(o_ids.numpy(), np.asarray(r_ids))
    np.testing.assert_allclose(o_d.numpy(), np.asarray(r_d), **TOL)


def test_ingest_chunks_without_compact_lands_in_buffer():
    X = _data(n=60)
    A = SegmentedLCCSIndex.create(8, m=8, seed=3, device="cpu")
    gids = A.ingest_chunks(iter_row_blocks(X, 25), compact=False)
    B = SegmentedLCCSIndex.create(8, m=8, seed=3, device="cpu")
    for block in iter_row_blocks(X, 25):
        B.insert(block)
    assert np.array_equal(gids, np.arange(60))
    assert A.segments == () and A.buffer_count == 60
    assert torch.equal(A.buf_h, B.buf_h) and torch.equal(A.buf_gid, B.buf_gid)
    assert A.ingest_chunks(iter(()), compact=False).shape == (0,)
    assert A.ingest_chunks(iter(())).shape == (0,)
    assert A.ingest_chunks(iter([np.zeros((0, 8), np.float32)])).shape == (0,)


def test_ingest_chunks_reblocks():
    """`chunk_rows` re-blocks the stream and sizes the merge chunks; the
    segment is the insert + compact one all the same."""
    X = _data(n=70)
    A = SegmentedLCCSIndex.create(8, m=8, seed=4, device="cpu")
    A.ingest_chunks(iter([X[:3], X[3:50], X[50:]]), chunk_rows=16)
    B = SegmentedLCCSIndex.create(8, m=8, seed=4, device="cpu")
    B.insert(X)
    B.compact()
    _assert_segmented_equal(A, B)


# ---------------------------------------------------------------------------
# 5. the engine
# ---------------------------------------------------------------------------


def test_engine_chunk_rows_equals_static_build():
    from repro_torch.configs import ARCHS
    from repro_torch.data import lm_token_batches
    from repro_torch.models import init_model
    from repro_torch.serve import RetrievalEngine

    cfg = ARCHS["gemma-2b"].smoke()
    eng = RetrievalEngine(cfg, init_model(cfg, device="cpu"), m=8, max_batch=16, device="cpu")
    corpus, _ = lm_token_batches(cfg.vocab, seed=0)(0, 40, 8)
    static = eng.build_index(corpus)
    chunked = eng.build_index(corpus, chunk_rows=16)
    _assert_index_equal(static, chunked)
    ids, _ = eng.serve_batch(corpus[:8])
    assert (ids[:, 0] == np.arange(8)).mean() >= 0.75
