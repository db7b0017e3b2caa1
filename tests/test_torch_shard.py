"""Port parity for the sharded topology (`repro_torch.shard`), on the CPU:

  1. Sharded == monolithic under complete coverage (lam and the window
     width cover every row, rerank_mult every survivor) for every source x
     store x S in {1, 2, 3, 4}: the same ids, distances within rtol 1e-6.
  2. The uneven split (n 1,001, S 4): global ids, padding never returned.
  3. Against the reference's `repro.shard`: `_local_params` over a grid, and
     the sharded search at S = 4 under an apportioned, incomplete budget
     (the reference on 4 fake devices in one subprocess, the index carried
     across by its pickle): the same ids, distances within 1e-5; at S = 1
     in this process.
  4. The "sharded" source's guards, the `SearchParams(shards=)` pin, the
     disk-tail refusal, instrumented == plain plans, the plan key's S.
  5. The engine's `shards` and the CLI's `--shards` / `--build-chunk-rows`.
"""
import json
import warnings

import numpy as np
import pytest
import torch

from conftest import run_multidevice
from repro.core import LCCSIndex as RefIndex
from repro.core import SearchParams as RefParams
from repro.shard import make_shard_mesh
from repro.shard.search import _local_params as ref_local_params
from repro_torch.core import LCCSIndex, SearchParams, available_sources
from repro_torch.core.index import candidates
from repro_torch.core.index import search as pure_search
from repro_torch.exec import available_topologies, compile_plan, execute
from repro_torch.obs.registry import registry
from repro_torch.shard import ShardedLCCSIndex, shard_index
from repro_torch.shard.search import _local_params

torch.set_num_threads(2)

SOURCES = ("bruteforce", "lccs", "multiprobe-full", "multiprobe-skip")
STORES = ("fp32", "bf16", "int8")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def complete():
    """n 96, d 16: one monolithic index a store, and its shardings."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(96, 16)).astype(np.float32)
    Q = rng.normal(size=(4, 16)).astype(np.float32)
    out = {}
    for store in STORES:
        mono = LCCSIndex.build(X, m=16, family="euclidean", w=4.0, seed=0, store=store,
                               device="cpu")
        out[store] = (mono, {S: mono.shard(S) for S in (1, 2, 3, 4)})
    return X, Q, out


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("store", STORES)
def test_sharded_matches_monolithic_under_complete_coverage(complete, store, source, S):
    _, Q, out = complete
    mono, sharded = out[store]
    p = SearchParams(k=8, lam=128, width=128, rerank_mult=16, source=source,
                     probes=3 if "multiprobe" in source else 1)
    ids_m, d_m = mono.search(Q, p)
    ids_s, d_s = sharded[S].search(Q, p)
    assert torch.equal(ids_s, ids_m), (store, source, S)
    torch.testing.assert_close(d_s, d_m, rtol=1e-6, atol=0.0)


def test_layout(complete):
    X, _, out = complete
    mono, sharded = out["int8"]
    sidx = sharded[3]
    assert (sidx.shards, sidx.rows_per_shard, sidx.n, sidx.m) == (3, 32, 96, 16)
    assert sidx.h.shape == (3, 32, 16) and sidx.csa.I.shape == (3, 16, 32)
    assert sidx.store.q.shape == (3, 32, 16) and sidx.tail.shape == (3, 32, 16)
    assert torch.equal(sidx.gid.reshape(-1), torch.arange(96, dtype=torch.int32))
    view, gid = sidx.local_view(1)
    assert isinstance(view, LCCSIndex) and torch.equal(gid, torch.arange(32, 64,
                                                                         dtype=torch.int32))
    assert torch.equal(view.tail, mono.tail[32:64]) and view.store.q.is_contiguous()
    assert sidx.index_bytes() > mono.index_bytes() - mono.csa.I.numel() * 16
    assert sidx.total_bytes() == sidx.index_bytes() + sidx.store_bytes() > 0


def test_uneven_split_global_ids():
    """n = 1,001 over 4 shards: the last shard padded with sentinel strings
    and gid -1, which no search returns."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(1001, 16)).astype(np.float32)
    Q = rng.normal(size=(6, 16)).astype(np.float32)
    mono = LCCSIndex.build(X, m=16, family="euclidean", w=4.0, seed=0, device="cpu")
    sidx = mono.shard(4)
    assert (sidx.shards, sidx.rows_per_shard, sidx.n) == (4, 251, 1001)
    assert int((sidx.gid < 0).sum()) == 3 and bool((sidx.h[3, -3:] == 2**31 - 1).all())
    for source in ("bruteforce", "lccs", "multiprobe-skip"):
        p = SearchParams(k=10, lam=1024, width=1024, source=source,
                         probes=3 if "multi" in source else 1)
        ids_m, d_m = mono.search(Q, p)
        ids_s, d_s = sidx.search(Q, p)
        assert bool(((ids_s >= 0) & (ids_s < 1001)).all()), source
        assert torch.equal(ids_s, ids_m), source
        torch.testing.assert_close(d_s, d_m, rtol=1e-6, atol=0.0)
    cand, _ = candidates(sidx, Q, SearchParams(k=5, lam=1024, width=1024, source="sharded"))
    assert int(cand.max()) < 1001 and int((cand >= 0).sum()) == 6 * 1001


def test_local_params_match_reference():
    seen = 0
    for k in (1, 5, 10):
        for lam in (1, 10, 33, 64, 100, 257):
            if lam < k:
                continue
            for width in (None, 3, 50, 128):
                for S in (1, 2, 3, 4, 7):
                    kw = dict(k=k, lam=lam, width=width)
                    with warnings.catch_warnings():  # width < lam: documented
                        warnings.simplefilter("ignore")
                        ours = _local_params(SearchParams(**kw), S)
                        ref = ref_local_params(RefParams(**kw), S)
                    assert (ours.k, ours.lam, ours.width) == (ref.k, ref.lam, ref.width), (kw, S)
                    assert ours.resolved_width() == ref.resolved_width()
                    seen += 1
    assert seen > 200


# the reference at S = 4 under an apportioned, incomplete budget: each shard
# cuts to ceil(lam / 4) and a derived window of ceil(W / 4)
BUDGET = dict(k=5, lam=40, rerank_mult=2)
REF_CASES = [(store, source) for store in ("fp32", "int8")
             for source in ("lccs", "multiprobe-skip", "bruteforce")]


@pytest.fixture(scope="module")
def reference_s4(tmp_path_factory):
    """The reference's sharded ids and distances at S = 4 (four fake CPU
    devices in a subprocess), with its monolithic indexes pickled for the
    port."""
    tmp = tmp_path_factory.mktemp("ref_shard")
    out = run_multidevice(
        f"""
        import json
        import numpy as np
        from repro.core import LCCSIndex, SearchParams
        from repro.shard import make_shard_mesh

        rng = np.random.default_rng(5)
        X = rng.normal(size=(400, 8)).astype(np.float32)
        Q = X[:7] + rng.normal(size=(7, 8)).astype(np.float32) * 0.05
        np.save({str(tmp / "q.npy")!r}, Q)
        mesh = make_shard_mesh(4)
        res = {{}}
        for store in ("fp32", "int8"):
            mono = LCCSIndex.build(X, m=8, family="euclidean", w=4.0, seed=0, store=store)
            mono.save({str(tmp)!r} + f"/{{store}}.pkl")
            sidx = mono.shard(mesh)
            for source in ("lccs", "multiprobe-skip", "bruteforce"):
                p = SearchParams(**{BUDGET!r}, source=source,
                                 probes=5 if "multi" in source else 1,
                                 use_gather_kernel=False)
                ids, d = sidx.search(Q, p)
                res[f"{{store}}/{{source}}"] = [np.asarray(ids).tolist(),
                                                np.asarray(d).tolist()]
        print("REF", json.dumps(res))
        """,
        4,
    )
    line = next(ln for ln in out.splitlines() if ln.startswith("REF "))
    return tmp, json.loads(line[4:])


@pytest.mark.parametrize("store,source", REF_CASES)
def test_sharded_matches_reference_at_four_shards(reference_s4, store, source):
    tmp, res = reference_s4
    Q = np.load(tmp / "q.npy")
    sidx = LCCSIndex.load(tmp / f"{store}.pkl", device="cpu").shard(4)
    p = SearchParams(**BUDGET, source=source, probes=5 if "multi" in source else 1)
    ids, d = sidx.search(Q, p)
    r_ids, r_d = (np.asarray(x) for x in res[f"{store}/{source}"])
    assert np.array_equal(ids.numpy(), r_ids), (store, source)
    np.testing.assert_allclose(d.numpy(), r_d, **TOL)
    # the budget is apportioned and incomplete: 10 candidates and a window of
    # 10 a shard, of 100 rows
    local = _local_params(p, 4)
    assert (local.lam, local.width, sidx.rows_per_shard) == (10, 10, 100)


def test_reference_single_shard_in_process(tmp_path):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(50, 8)).astype(np.float32)
    Q = rng.normal(size=(3, 8)).astype(np.float32)
    ref = RefIndex.build(X, m=8, family="euclidean", w=4.0, seed=0, store="int8")
    ref.save(tmp_path / "ref.pkl")
    ref_s = ref.shard(make_shard_mesh(1))
    ours = LCCSIndex.load(tmp_path / "ref.pkl", device="cpu").shard(1)
    for source in ("lccs", "multiprobe-skip"):
        kw = dict(k=5, lam=16, width=16, source=source, probes=3 if "multi" in source else 1)
        r_ids, r_d = ref_s.search(Q, RefParams(**kw, use_gather_kernel=False))
        o_ids, o_d = ours.search(Q, SearchParams(**kw))
        assert np.array_equal(o_ids.numpy(), np.asarray(r_ids)), source
        np.testing.assert_allclose(o_d.numpy(), np.asarray(r_d), **TOL)
    assert ours.shards == 1 and ours.n == 50 and ours.m == 8


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(50, 8)).astype(np.float32)
    Q = rng.normal(size=(3, 8)).astype(np.float32)
    return X, Q, LCCSIndex.build(X, m=8, family="euclidean", w=4.0, seed=0, device="cpu")


def test_sharded_source_registered_and_guards(small):
    X, Q, mono = small
    assert "sharded" in available_sources() and "sharded" in available_topologies()
    sidx = mono.shard(2)
    p = SearchParams(lam=64, width=64, source="sharded", inner="lccs")
    ids, lcps = candidates(sidx, Q, p)
    assert ids.shape == (3, 64) and int(ids.max()) < 50
    assert bool((ids[ids >= 0] >= 0).all()) and lcps.shape == (3, 64)
    # the monolithic pipeline body refuses a sharded index; execute routes it
    with pytest.raises(TypeError, match="ShardedLCCSIndex"):
        pure_search(sidx, Q, SearchParams(k=3, lam=16))
    with pytest.raises(TypeError, match="source='sharded'"):
        candidates(sidx, Q, SearchParams(lam=16, source="lccs"))
    assert execute(sidx, Q, SearchParams(k=3, lam=16))[0].shape == (3, 3)
    # the "sharded" source refuses a monolithic index
    with pytest.raises(TypeError, match="ShardedLCCSIndex"):
        candidates(mono, Q, p)
    with pytest.raises(ValueError, match="segmented"):
        sidx.search(Q, SearchParams(k=3, lam=16, source="segmented"))
    from repro_torch.shard import search as shard_search

    with pytest.raises(TypeError, match="ShardedLCCSIndex"):
        shard_search(mono, Q, SearchParams(k=3, lam=16))
    ids_f, _ = shard_search(sidx, Q, SearchParams(k=3, lam=16, source="sharded"))
    assert torch.equal(ids_f, sidx.search(Q, SearchParams(k=3, lam=16))[0])


def test_params_shards_validation(small):
    _, Q, mono = small
    sidx = mono.shard(1)
    with pytest.raises(ValueError, match="shards"):
        sidx.search(Q, SearchParams(k=3, lam=16, shards=4))
    assert sidx.search(Q, SearchParams(k=3, lam=16, shards=1))[0].shape == (3, 3)
    with pytest.raises(ValueError, match="recurse"):
        SearchParams(inner="sharded")
    with pytest.raises(ValueError, match="shards must be"):
        SearchParams(shards=0)
    with pytest.raises(ValueError, match="shards must be"):
        mono.shard(0)


def test_disk_tail_rejected(small, tmp_path):
    X, _, _ = small
    idx = LCCSIndex.build(X, m=8, family="euclidean", w=4.0, seed=0, store="int8",
                          tail_path=tmp_path / "tail.npy", device="cpu")
    with pytest.raises(ValueError, match="disk-lazy"):
        idx.shard(2)


@pytest.mark.parametrize("store", ["fp32", "int8"])
def test_build_equals_shard_of_build(store):
    X = np.random.default_rng(4).normal(size=(70, 8)).astype(np.float32)
    kw = dict(m=8, family="euclidean", w=4.0, seed=1, store=store, device="cpu")
    a = ShardedLCCSIndex.build(X, shards=3, **kw)
    b = LCCSIndex.build(X, **kw).shard(3)
    c = ShardedLCCSIndex.build(X, shards=3, chunk_rows=16, **kw)
    for other in (b, c):
        assert torch.equal(a.h, other.h) and torch.equal(a.gid, other.gid)
        for x, y in zip(a.csa.tables(), other.csa.tables()):
            assert torch.equal(x, y)
    assert shard_index(LCCSIndex.build(X, build_csa_structure=False, **kw), 2).csa is None


@pytest.mark.parametrize("store", ["fp32", "int8"])
@pytest.mark.parametrize("S", [1, 3])
def test_instrumented_plan_equals_plain(small, store, S):
    X, Q, _ = small
    sidx = LCCSIndex.build(X, m=8, family="euclidean", w=4.0, seed=0, store=store,
                           device="cpu").shard(S)
    p = SearchParams(k=5, lam=24, width=8, rerank_mult=2)
    ids_f, d_f = execute(sidx, Q, p)
    snap = registry().snapshot()
    ids_i, d_i = execute(sidx, Q, p, instrument=True)
    assert torch.equal(ids_f, ids_i) and torch.equal(d_f, d_i)
    hist = "repro_exec_stage_seconds"
    window = registry().since(snap)
    seen = {ls["stage"] for ls in registry().get(hist).labelsets()
            if ls["topology"] == "sharded" and window.count(hist, **ls)}
    assert seen == {"hash_queries", "probe", "verify", "merge"}


def test_plan_key_sees_the_shard_count(small):
    X, Q, mono = small
    p = SearchParams(k=3, lam=16)
    keys = {S: compile_plan(mono.shard(S), Q, p).key for S in (1, 2, 3)}
    assert len(set(keys.values())) == 3
    assert compile_plan(mono.shard(2), Q, p).key == keys[2]
    plan = compile_plan(mono.shard(2), Q, p)
    assert plan.topology == "sharded" and plan.params.source == "sharded"
    assert plan.params.inner == "lccs" and plan.params.use_gather_kernel is False


# ---------------------------------------------------------------------------
# the engine and the CLI
# ---------------------------------------------------------------------------


def test_engine_shards():
    from repro_torch.configs import ARCHS
    from repro_torch.data import lm_token_batches
    from repro_torch.models import init_model
    from repro_torch.serve import RetrievalEngine

    cfg = ARCHS["gemma-2b"].smoke()
    model = init_model(cfg, device="cpu")
    corpus, _ = lm_token_batches(cfg.vocab, seed=0)(0, 48, 8)
    static = RetrievalEngine(cfg, model, m=8, max_batch=16, device="cpu")
    static.build_index(corpus)
    eng = RetrievalEngine(cfg, model, m=8, max_batch=16, shards=2, device="cpu")
    sidx = eng.build_index(corpus)
    assert isinstance(sidx, ShardedLCCSIndex) and sidx.shards == 2
    chunked = eng.build_index(corpus, chunk_rows=16)
    for x, y in zip(sidx.csa.tables(), chunked.csa.tables()):
        assert torch.equal(x, y)
    ids, dists = eng.serve_batch(corpus[:16])
    want, _ = static.index.shard(2).search(eng.embed(corpus[:16]), eng.search_params)
    assert np.array_equal(ids, want.numpy())
    assert (ids == np.arange(16)[:, None]).any(axis=1).mean() >= 0.9
    with pytest.raises(ValueError, match="mutually exclusive"):
        eng.build_index(corpus, dynamic=True)


def test_cli_shards_and_build_chunk_rows(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--corpus", "64",
          "--requests", "32", "--m", "16", "--shards", "2", "--build-chunk-rows", "64"])
    out = capsys.readouterr().out
    assert "2 shards" in out
    hits = int(out.split("self-retrieval ")[1].split("/")[0])
    assert hits >= 29, out
    for bad in (["--shards", "2", "--dynamic"], ["--build-chunk-rows", "8", "--dynamic"]):
        with pytest.raises(SystemExit) as e:
            main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", *bad])
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert "mutually exclusive" in err and "ingest_chunks" in err
