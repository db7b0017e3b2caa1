"""Port parity for the plan cache and the instrumented plans
(`repro_torch.exec.plan`, `repro_torch.exec.topology`):

  1. over the same calls, the port's plan cache hits, misses and evicts
     exactly where the reference's does (`tests/test_exec.py:136-228`,
     `tests/test_obs.py:188-345`): compile once per (params, shape), static-
     only fields, a float64 batch, insert/delete within capacity against
     compaction, buffer and store growth and `vacuum`, the int8 store with
     its tail resident or on disk, LRU evictions, and the engine's plan
     counters;
  2. instrumented plans give the fused plans' ids and distances bit for bit,
     for every source x store (fp32, int8 with a resident tail, the disk
     tail) x topology x gather-kernel toggle, and are keyed apart;
  3. the stage names of `repro_exec_stage_seconds` per topology and store
     are those the `exec.topology` docstring states, one observation a
     stage a call, and the reference's where the port has not fused two
     stages.

Each test swaps both packages' process-global plan cache for a fresh one,
so cached plans of other tests cannot turn a miss into a hit.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.exec.plan as ref_plan
import repro_torch.exec.plan as port_plan
import repro_torch.exec.topology as port_topology
from repro.core import LCCSIndex as RefIndex
from repro.core import SearchParams as RefParams
from repro.core import SegmentedLCCSIndex as RefSegmented
from repro.exec import compile_plan as ref_compile
from repro.exec import execute as ref_execute
from repro_torch.core import LCCSIndex, SearchParams, SegmentedLCCSIndex
from repro_torch.exec import compile_plan, execute, plan_cache
from repro_torch.obs.registry import registry

# the trace modules (each package's `obs.trace` attribute is the trace()
# context manager it re-exports)
ref_trace = importlib.import_module("repro.obs.trace")
port_trace = importlib.import_module("repro_torch.obs.trace")

torch.set_num_threads(2)

N, D, B = 160, 16, 4
SOURCES = ("bruteforce", "lccs", "multiprobe-full", "multiprobe-skip")
FAMILY = dict(m=16, family="euclidean", w=4.0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(N, D)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32))


@pytest.fixture
def caches(monkeypatch):
    """Fresh plan caches in both packages (the registry counters they carry
    are process-wide, so every tally below is a difference)."""
    def swap(maxsize=256):
        ref, ours = ref_plan.PlanCache(maxsize), port_plan.PlanCache(maxsize)
        monkeypatch.setattr(ref_plan, "_CACHE", ref)
        monkeypatch.setattr(port_plan, "_CACHE", ours)
        return ref, ours
    return swap


def _tally(cache, calls):
    """(hits, misses, evictions) since the first call, after each call."""
    h0, m0, e0 = cache.hits, cache.misses, cache.evictions
    out = []
    for call in calls:
        call()
        out.append((cache.hits - h0, cache.misses - m0, cache.evictions - e0))
    return out


def _both(caches, make_calls, maxsize=256):
    """Run the same calls against each package; returns the port's tally
    after asserting it equals the reference's, call for call."""
    ref_cache, port_cache = caches(maxsize)
    want = _tally(ref_cache, make_calls("ref"))
    got = _tally(port_cache, make_calls("port"))
    assert got == want
    return got


def _pkg(side):
    if side == "ref":
        return RefIndex, RefSegmented, RefParams, ref_execute, ref_compile, {}
    return LCCSIndex, SegmentedLCCSIndex, SearchParams, execute, compile_plan, {"device": "cpu"}


# -- 1. the hit / miss / eviction sequence, call for call ----------------------


def test_compiles_once_per_params_and_shape(data, caches):
    X, Q = data
    same = []

    def calls(side):
        Index, _, Params, run, compile_, dev = _pkg(side)
        idx = Index.build(X, seed=3, **FAMILY, **dev)
        p = Params(k=3, lam=32, use_gather_kernel=False)
        return [lambda: run(idx, Q, p),
                *[lambda off=off: run(idx, Q + off, p) for off in (1.0, 2.0, 3.0)],
                lambda: same.append(compile_(idx, Q, p) is compile_(idx, Q + 9.0, p)),
                lambda: run(idx, Q.astype(np.float64), p),  # cast before the key
                lambda: compile_(idx, (B, D), p),           # a plain shape
                lambda: run(idx, Q[:2], p)]                 # a new shape: a new plan

    got = _both(caches, calls)
    assert got[0] == (0, 1, 0) and got[3] == (3, 1, 0) and got[-1] == (7, 2, 0)
    assert same == [True, True]


def test_static_only_fields_are_distinct_plans(data, caches):
    X, Q = data
    outs = {"ref": [], "port": []}

    def calls(side):
        Index, _, Params, run, _, dev = _pkg(side)
        idx = Index.build(X[: N - 7], seed=4, **FAMILY, **dev)
        p = Params(k=3, lam=32, use_gather_kernel=False)
        keep = lambda params: outs[side].append(np.asarray(run(idx, Q, params)[0]))
        return [lambda: keep(p), lambda: keep(p.replace(rerank_mult=9)),
                lambda: keep(p.replace())]

    assert _both(caches, calls) == [(0, 1, 0), (0, 2, 0), (1, 2, 0)]
    for ids in outs["port"][1:]:
        np.testing.assert_array_equal(ids, outs["port"][0])


def test_mutation_vs_growth_semantics(caches):
    rng = np.random.default_rng(5)
    rows = [rng.normal(size=(n, D)).astype(np.float32) for n in (4, 2, 1, 9)]
    Qz = np.zeros((2, D), np.float32)

    def calls(side):
        _, Seg, Params, _, _, dev = _pkg(side)
        idx = Seg.create(D, **FAMILY, **dev)
        p = Params(k=3, lam=8, use_gather_kernel=False)
        search = lambda: idx.search(Qz, p)
        return [lambda: idx.insert(rows[0]), search,           # first plan
                lambda: idx.delete([0]), lambda: idx.insert(rows[1]),
                search,                                         # within capacity: hit
                lambda: idx.compact(), search,                  # a segment: miss
                lambda: idx.insert(rows[2]), search,            # within capacity: hit
                lambda: idx.insert(rows[3]), search,            # store + buffer grow
                lambda: idx.delete([3, 4]), search,             # hit
                lambda: idx.vacuum(), search, search]           # one segment, renumbered

    got = _both(caches, calls)
    misses = [m for _, m, _ in got]
    assert misses[1] == 1 and misses[4] == 1 and misses[6] == 2 and misses[8] == 2
    assert misses[10] == 3 and misses[12] == 3 and misses[-1] == misses[-2] == 4


def test_int8_tail_resident_or_on_disk(data, caches, tmp_path):
    X, Q = data

    def calls(side):
        Index, _, Params, run, _, dev = _pkg(side)
        build = lambda **kw: Index.build(X, seed=2, store="int8", **FAMILY, **dev, **kw)
        resident, fp32 = build(), Index.build(X, seed=2, **FAMILY, **dev)
        disk_a = build(tail_path=tmp_path / f"{side}_a.npy")
        disk_b = build(tail_path=tmp_path / f"{side}_b.npy")
        p = Params(k=3, lam=32, use_gather_kernel=False, source="lccs")
        return [lambda: run(resident, Q, p), lambda: run(disk_a, Q, p),
                lambda: run(disk_a, Q + 1, p), lambda: run(disk_b, Q, p),
                lambda: run(resident, Q + 1, p), lambda: run(fp32, Q, p)]

    assert _both(caches, calls) == [(0, 1, 0), (0, 2, 0), (1, 2, 0), (1, 3, 0),
                                     (2, 3, 0), (2, 4, 0)]


def test_lru_evictions(data, caches):
    X, Q = data

    def calls(side):
        Index, _, Params, run, _, dev = _pkg(side)
        idx = Index.build(X, seed=6, **FAMILY, **dev)
        p = Params(k=3, lam=32, use_gather_kernel=False)
        return [lambda b=b: run(idx, Q[:b], p) for b in (1, 2, 1, 3, 2, 1)]

    assert _both(caches, calls, maxsize=2) == [(0, 1, 0), (0, 2, 0), (1, 2, 0), (1, 3, 1),
                                               (1, 4, 2), (1, 5, 3)]


def _stub_embed(tokens):
    """A fixed token -> unit-vector map, so both engines index and query the
    same vectors without a model forward (the plan counters depend on the
    search alone)."""
    t = np.asarray(tokens, np.float32)[:, :D]
    e = np.sin(0.37 * t + np.arange(D, dtype=np.float32))
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def test_engine_plan_counters_equal_reference(caches):
    from repro.serve import RetrievalEngine as RefEngine
    from repro_torch.configs import ARCHS
    from repro_torch.data import lm_token_batches
    from repro_torch.serve import RetrievalEngine

    cfg = ARCHS["gemma-2b"].smoke()
    corpus, _ = lm_token_batches(vocab=cfg.vocab, seed=3)(0, 40, 16)
    stats = {}

    def calls(side):
        if side == "ref":
            eng = RefEngine(cfg, None, m=16, max_batch=8, name=f"tplan-{side}")
            eng.embed = lambda toks: jnp.asarray(_stub_embed(toks))
            p = RefParams(k=3, lam=16, use_gather_kernel=False)
        else:
            eng = RetrievalEngine(cfg, torch.nn.Linear(1, 1), m=16, max_batch=8,
                                  device="cpu", name=f"tplan-{side}")
            eng.embed = lambda toks: torch.from_numpy(_stub_embed(toks))
            p = SearchParams(k=3, lam=16, use_gather_kernel=False)
        rec = stats.setdefault(side, [])
        served = lambda lo, b=8, params=p: (
            eng.serve_batch(corpus[lo:lo + b], params),
            rec.append((eng.stats.plan_hits, eng.stats.plan_misses, eng.stats.plan_evictions)))
        return [lambda: eng.build_index(corpus), lambda: served(0),
                *[lambda lo=lo: served(lo) for lo in (8, 16, 24)],
                lambda: served(0, params=p.replace(rerank_mult=2)),  # static field: miss
                lambda: served(0, b=3),                              # evicts this engine's
                lambda: served(8)]                                   # rebuilt

    got = _both(caches, calls, maxsize=2)
    assert stats["port"] == stats["ref"]
    assert stats["port"][:5] == [(0, 1, 0), (1, 1, 0), (2, 1, 0), (3, 1, 0), (3, 2, 0)]
    assert stats["port"][-1][2] > 0 and got[-1][2] == stats["port"][-1][2]


# -- 2. instrumented plans == fused plans, keyed apart ---------------------------

CASES = ([("monolithic", s) for s in ("fp32", "int8", "disk")]
         + [("segmented", s) for s in ("fp32", "int8")])


def _index(X, topology, store, tmp_path):
    kw = dict(seed=1, store="int8" if store == "disk" else store, device="cpu", **FAMILY)
    if topology == "segmented":
        return SegmentedLCCSIndex.build(X, **kw)
    if store == "disk":
        return LCCSIndex.build(X, tail_path=tmp_path / "tail.npy", **kw)
    return LCCSIndex.build(X, **kw)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain-verify", "fused-verify"])
@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("topology,store", CASES)
def test_instrumented_equals_fused(data, tmp_path, topology, store, source, kernel):
    X, Q = data
    idx = _index(X, topology, store, tmp_path)
    p = SearchParams(k=6, lam=40, width=40, rerank_mult=4, source=source,
                     probes=3 if "multiprobe" in source else 1,
                     use_gather_kernel=kernel, use_probe_kernel=kernel)
    ids_f, d_f = execute(idx, Q, p)
    ids_i, d_i = execute(idx, Q, p, instrument=True)
    assert torch.equal(ids_f, ids_i) and torch.equal(d_f, d_i)
    assert ids_f.shape == (B, 6) and bool((ids_f[:, 0] >= 0).all())


def test_instrumented_plans_key_separately(data, caches):
    X, Q = data
    plans = {}

    def calls(side):
        Index, _, Params, run, compile_, dev = _pkg(side)
        idx = Index.build(X[: N - 3], seed=2, **FAMILY, **dev)
        p = Params(k=3, lam=32, use_gather_kernel=False)
        keep = lambda: plans.setdefault(side, (compile_(idx, Q, p),
                                               compile_(idx, Q, p, instrument=True)))
        return [lambda: run(idx, Q, p), lambda: run(idx, Q, p, instrument=True),
                lambda: run(idx, Q + 1.0, p), lambda: run(idx, Q + 2.0, p, instrument=True),
                keep]

    assert _both(caches, calls) == [(0, 1, 0), (0, 2, 0), (1, 2, 0), (2, 2, 0), (4, 2, 0)]
    plan_f, plan_i = plans["port"]
    assert plan_f is not plan_i and not plan_f.instrumented and plan_i.instrumented


# -- 3. the stage names ---------------------------------------------------------

STAGES = {
    ("fp32", True): ["hash_queries", "probe", "gather"],
    ("fp32", False): ["hash_queries", "probe", "gather", "merge"],
    ("int8", True): ["hash_queries", "probe", "survivors", "gather", "rerank"],
    ("int8", False): ["hash_queries", "probe", "survivors", "gather", "rerank"],
    ("disk", True): ["hash_queries", "probe", "survivors", "gather", "rerank"],
    ("disk", False): ["hash_queries", "probe", "survivors", "gather", "rerank"],
}


def _exec_spans(mod, run):
    mod.enable_tracing()
    try:
        run()
    finally:
        mod.disable_tracing()
    names = [e["name"].removeprefix("exec.") for e in mod.events()
             if e["name"].startswith("exec.")]
    mod.clear_trace()
    return names


@pytest.mark.parametrize("kernel", [False, True], ids=["plain-verify", "fused-verify"])
@pytest.mark.parametrize("topology,store", CASES)
def test_stage_names_per_topology_and_store(data, tmp_path, topology, store, kernel):
    X, Q = data
    idx = _index(X, topology, store, tmp_path)
    p = SearchParams(k=6, lam=40, width=40, source="lccs", use_gather_kernel=kernel)
    hist = registry().histogram("repro_exec_stage_seconds", labelnames=("topology", "stage"))
    snap = registry().snapshot()
    names = _exec_spans(port_trace, lambda: execute(idx, Q, p, instrument=True))
    want = STAGES[(store, kernel)]
    assert names == want
    doc = " ".join(port_topology.__doc__.split())
    assert ", ".join(want) in doc
    d = registry().since(snap)
    assert {s: d.count(hist.name, topology=topology, stage=s) for s in want} == dict.fromkeys(
        want, 1)
    # where the port fused no two stages, the reference's names (its
    # segmented topology runs the monolithic staged builder too)
    if topology == "monolithic" and not (store == "fp32" and kernel):
        kw = dict(seed=1, store="int8" if store == "disk" else store, **FAMILY)
        if store == "disk":
            ref = RefIndex.build(X, tail_path=tmp_path / "ref_tail.npy", **kw)
        else:
            ref = RefIndex.build(X, **kw)
        rp = RefParams(k=6, lam=40, width=40, source="lccs", use_gather_kernel=False)
        assert _exec_spans(ref_trace, lambda: ref_execute(ref, Q, rp, instrument=True)) == want


def test_plan_cache_is_exported():
    import repro_torch.exec as ex

    assert {"compile_plan", "plan_cache", "PlanCache", "SearchPlan"} <= set(ex.__all__)
    assert plan_cache() is port_plan._CACHE
