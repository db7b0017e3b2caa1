"""Port parity for `repro_torch.obs` (the port's copy of `repro.obs`):

  1. the registry: labels, gauges, histograms, get-or-create and the
     kind-mismatch error, snapshot/delta windows (`tests/test_obs.py`'s
     cases), and one sequence of operations applied to a fresh registry of
     each package renders the same Prometheus text, line for line;
  2. `LatencyWindow` under concurrent record/read, and the plan cache's
     eviction attribution to the building scope;
  3. tracing: spans are no-ops when off, export as Chrome-trace JSON, the
     `stage` timer feeds `repro_exec_stage_seconds` without tracing, the
     package does not shadow its submodules;
  4. exposition: the /metrics endpoint scrapes and parses; the stats line;
  5. the recall-drift probe gauges recall, and on the same index and
     queries reads the reference's recall.
"""
import json
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.core import LCCSIndex as RefIndex
from repro.core import SearchParams as RefParams
from repro.obs import RecallDriftProbe as RefProbe
from repro.obs.prom import render_text as ref_render_text
from repro.obs.registry import Registry as RefRegistry
from repro_torch.core import LCCSIndex, SearchParams
from repro_torch.obs.prom import render_text
from repro_torch.obs.registry import Registry, registry
from repro_torch.obs.trace import (
    add_span,
    clear_trace,
    disable_tracing,
    enable_tracing,
    events,
    export_chrome_trace,
    fence,
    span,
    stage,
    tracing_enabled,
)

torch.set_num_threads(2)

N, D, B = 160, 16, 4
# complete coverage: the serving route provably equals brute force
BASE = dict(k=6, lam=N + 12, width=N + 12, rerank_mult=64, use_gather_kernel=False)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(N, D)).astype(np.float32)
    Q = rng.normal(size=(B, D)).astype(np.float32)
    return X, Q


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    disable_tracing()
    clear_trace()


# -- 1. registry ---------------------------------------------------------------


def test_counter_labels_and_partial_sum():
    c = registry().counter("tobs_counter_total", "t", labelnames=("a",))
    c.inc(a="x")
    c.inc(2.0, a="y")
    assert c.value(a="x") == 1.0
    assert c.value() == 3.0  # no filter: sum across series
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1.0, a="x")
    with pytest.raises(ValueError, match="takes labels"):
        c.inc(b="nope")
    with pytest.raises(ValueError, match="no labels"):
        c.value(b="nope")


def test_gauge_last_write_wins():
    g = registry().gauge("tobs_gauge", "t", labelnames=("a",))
    g.set(5.0, a="x")
    g.set(2.0, a="x")
    g.inc(1.0, a="x")
    assert g.value(a="x") == 3.0


def test_histogram_buckets_sum_count_and_reservoir():
    h = registry().histogram("tobs_hist_seconds", "t", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    assert h.count() == 4
    assert h.sum_value() == pytest.approx(55.55)
    assert sorted(h.samples()) == [0.05, 0.5, 5.0, 50.0]
    (_, rec), = h.collect().items()
    assert rec["buckets"] == [1, 1, 1, 1]  # one obs per bucket incl +Inf


def test_registry_get_or_create_and_kind_mismatch():
    a = registry().counter("tobs_redeclare_total", "t", labelnames=("a",))
    assert registry().counter("tobs_redeclare_total", labelnames=("a",)) is a
    with pytest.raises(ValueError, match="already registered"):
        registry().gauge("tobs_redeclare_total", labelnames=("a",))
    with pytest.raises(ValueError, match="already registered"):
        registry().counter("tobs_redeclare_total", labelnames=("b",))
    with pytest.raises(KeyError, match="no metric"):
        registry().get("tobs_never_declared")


def test_snapshot_delta_window():
    c = registry().counter("tobs_window_total", "t", labelnames=("a",))
    h = registry().histogram("tobs_window_seconds", "t")
    c.inc(10.0, a="x")
    h.observe(1.0)
    snap = registry().snapshot()
    c.inc(2.0, a="x")
    c.inc(1.0, a="z")  # a series born inside the window counts from 0
    h.observe(2.0)
    h.observe(3.0)
    d = registry().since(snap)
    assert d.value("tobs_window_total") == 3.0
    assert d.value("tobs_window_total", a="x") == 2.0
    assert sorted(d.samples("tobs_window_seconds")) == [2.0, 3.0]
    assert d.count("tobs_window_seconds") == 2
    with pytest.raises(TypeError, match="not a histogram"):
        d.samples("tobs_window_total")


def _operations(reg) -> str:
    """One sequence of registry operations; returns the rendered text."""
    c = reg.counter("repro_plan_cache_hits_total", "reused plans", labelnames=("scope",))
    c.inc(scope="replica-0")
    c.inc(3.0, scope="replica-1")
    c.inc(2.5, scope='qu"oted\nname\\x')
    g = reg.gauge("repro_router_queue_depth", "depth", labelnames=("replica",))
    g.set(4.0, replica="replica-0")
    g.dec(1.5, replica="replica-0")
    g.inc(7.0, replica="replica-1")
    h = reg.histogram("repro_exec_stage_seconds", "stages", labelnames=("topology", "stage"))
    for i, v in enumerate((0.0001, 0.0007, 0.003, 0.04, 0.2, 3.0, 42.0)):
        h.observe(v, topology="monolithic", stage=("probe", "gather")[i % 2])
    b = reg.histogram("repro_router_batch_size", "sizes", labelnames=("replica",),
                      buckets=(1.0, 2.0, 4.0, 8.0))
    for v in (1, 3, 8, 9):
        b.observe(v, replica="replica-0")
    reg.counter("repro_router_rejected_total", "").inc(0.0)
    snap = reg.snapshot()
    c.inc(scope="replica-0")
    d = reg.since(snap)
    assert d.value("repro_plan_cache_hits_total", scope="replica-0") == 1.0
    return render_text(reg) if isinstance(reg, Registry) else ref_render_text(reg)


def test_render_text_equals_reference_line_for_line():
    ours = _operations(Registry()).splitlines()
    ref = _operations(RefRegistry()).splitlines()
    assert len(ours) == len(ref) > 40
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a == b, (i, a, b)


# -- 2. LatencyWindow and the plan cache's eviction attribution ----------------


def test_latency_window_concurrent_record_and_percentiles():
    from repro_torch.router.metrics import LatencyWindow

    win = LatencyWindow(maxlen=100_000, label="tobs-window")
    n_writers, per_writer = 8, 2000
    stop = threading.Event()
    errors: list[BaseException] = []

    def write():
        try:
            for i in range(per_writer):
                win.record(i * 1e-6)
        except BaseException as e:  # pragma: no cover -- the regression
            errors.append(e)

    def read():
        try:
            while not stop.is_set():
                win.percentiles()
                win.values()
        except BaseException as e:  # pragma: no cover -- the regression
            errors.append(e)

    readers = [threading.Thread(target=read) for _ in range(2)]
    writers = [threading.Thread(target=write) for _ in range(n_writers)]
    for t in readers + writers:
        t.start()
    for t in writers:
        t.join(timeout=60)
    stop.set()
    for t in readers:
        t.join(timeout=60)
    assert not errors, errors
    assert len(win.values()) == n_writers * per_writer
    hist = registry().get("repro_router_latency_seconds")
    assert hist.count(replica="tobs-window") == n_writers * per_writer


def test_plan_cache_attributes_evictions_to_builder_scope():
    from repro_torch.exec.plan import PlanCache

    cache = PlanCache(maxsize=2)  # shares the registry counters; unique
    # scope labels keep this test's tallies apart
    build = lambda: object()  # the cache never introspects the plan
    cache.get_or_build(("k1",), build, scope="tobs-evict-a")
    cache.get_or_build(("k2",), build, scope="tobs-evict-b")
    assert cache.scope_evictions("tobs-evict-a") == 0
    # k1 is LRU; inserting k3 under scope b must charge the eviction to a
    cache.get_or_build(("k3",), build, scope="tobs-evict-b")
    assert len(cache) == 2
    assert cache.scope_evictions("tobs-evict-a") == 1
    assert cache.scope_evictions("tobs-evict-b") == 0
    assert cache.scope_evictions(None) == 0
    scopes = cache.stats()["scopes"]
    assert scopes["tobs-evict-a"] == {"hits": 0, "misses": 1, "evictions": 1}
    assert scopes["tobs-evict-b"]["misses"] == 2
    # a hit refreshes recency: touching k2 then inserting k4 evicts k3 (b)
    cache.get_or_build(("k2",), build, scope="tobs-evict-a")
    cache.get_or_build(("k4",), build, scope="tobs-evict-a")
    assert cache.scope_evictions("tobs-evict-b") == 1
    assert cache.stats()["scopes"]["tobs-evict-a"]["hits"] == 1


def test_serve_stats_carries_plan_evictions_field():
    from repro_torch.serve.engine import ServeStats

    s = ServeStats()
    assert s.plan_evictions == 0
    assert "plan_evictions" in vars(s)


# -- 3. tracing -----------------------------------------------------------------


def test_span_noop_when_disabled():
    clear_trace()
    assert not tracing_enabled()
    with span("invisible"):
        pass
    add_span("also-invisible", 0.0, 1.0)
    assert events() == []


def test_span_tree_exports_valid_chrome_trace(tmp_path):
    enable_tracing()
    with span("outer", layer="test"):
        with span("inner"):
            pass
    disable_tracing()
    evs = events()
    assert [e["name"] for e in evs] == ["inner", "outer"]  # completion order
    inner, outer = evs
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert outer["args"] == {"layer": "test"}
    assert inner["tid"] == outer["tid"]

    path = tmp_path / "trace.json"
    doc = export_chrome_trace(path)
    loaded = json.loads(path.read_text())
    assert loaded == json.loads(json.dumps(doc))
    assert loaded["displayTimeUnit"] == "ms"
    for e in loaded["traceEvents"]:
        assert e["ph"] == "X"
        assert {"name", "ts", "dur", "pid", "tid"} <= set(e)


def test_stage_times_histogram_even_without_tracing():
    assert not tracing_enabled()
    with stage("tobs-test", "probe"):  # declares the histogram on first use
        pass
    hist = registry().get("repro_exec_stage_seconds")
    before = hist.count(topology="tobs-test", stage="probe")
    with stage("tobs-test", "probe"):
        t = fence(torch.ones(3) * 2)  # a CPU tensor: nothing to wait for
    assert torch.equal(t, torch.full((3,), 2.0))
    assert hist.count(topology="tobs-test", stage="probe") == before + 1
    assert events() == []  # ...but no trace event while disabled


def test_trace_context_manager_exports_and_restores(tmp_path):
    from repro_torch.obs.trace import trace

    path = tmp_path / "ctx_trace.json"
    assert not tracing_enabled()
    with trace(path):
        with span("inside"):
            pass
    assert not tracing_enabled()
    evs = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in evs] == ["inside"]


def test_obs_package_does_not_shadow_submodules():
    import importlib

    import repro_torch.obs as obs

    assert callable(obs.trace)  # the contextmanager re-export wins on attr
    mod = importlib.import_module("repro_torch.obs.trace")
    assert hasattr(mod, "span") and hasattr(mod, "add_span")
    import repro.obs as ref_obs

    assert set(ref_obs.__all__) <= set(obs.__all__)


def test_device_profile_writes_a_trace(tmp_path):
    from repro_torch.obs import device_profile

    with device_profile(tmp_path / "prof"):
        torch.ones(64) @ torch.ones(64)
    assert list((tmp_path / "prof").glob("*.json"))


# -- 4. exposition --------------------------------------------------------------

_SAMPLE_RE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+$')


def test_metrics_endpoint_scrapes_and_parses():
    from repro_torch.obs import MetricsServer

    c = registry().counter("tobs_scrape_total", "scrape me", labelnames=("who",))
    c.inc(3.0, who='qu"oted\nname')  # exercises label escaping
    registry().histogram("tobs_scrape_seconds", "h").observe(0.3)
    with MetricsServer(port=0, host="127.0.0.1") as srv:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/plain")
            body = resp.read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope", timeout=10)
    lines = [ln for ln in body.splitlines() if ln]
    assert "# TYPE tobs_scrape_total counter" in lines
    assert any(ln.startswith("# HELP tobs_scrape_total") for ln in lines)
    for ln in lines:
        if not ln.startswith("#"):
            assert _SAMPLE_RE.match(ln), ln
    sample = next(ln for ln in lines if ln.startswith("tobs_scrape_total{"))
    assert sample.endswith(" 3.0") and r'qu\"oted\nname' in sample
    assert any(ln.startswith('tobs_scrape_seconds_bucket{le="+Inf"} 1') for ln in lines)
    assert any(ln.startswith("tobs_scrape_seconds_count 1") for ln in lines)


def test_stats_logger_line_shapes():
    from repro_torch.obs import StatsLogger

    reg = registry()
    snap = reg.snapshot()
    line = StatsLogger().line(reg.since(snap), 2.0)
    assert line.startswith("[obs] 0 req in 2.0s")
    assert "QPS" in line and "plan compiles" in line


# -- 5. the recall-drift probe ---------------------------------------------------


def test_recall_drift_probe_gauges_recall(data):
    from repro_torch.obs import RecallDriftProbe

    X, Q = data
    idx = LCCSIndex.build(X, m=16, family="euclidean", w=4.0, seed=5, device="cpu")
    probe = RecallDriftProbe(idx, Q, SearchParams(**BASE, source="lccs"),
                             label="tobs-drift")
    assert probe.measure() == 1.0
    assert probe.last() == 1.0
    assert len(probe.history) == 1
    assert registry().get("repro_recall_drift").value(probe="tobs-drift") == 1.0
    assert registry().get("repro_recall_drift_measurements_total").value(
        probe="tobs-drift") == 1.0
    with pytest.raises(ValueError, match="interval_s"):
        probe.start()
    lean = SearchParams(k=6, lam=8, width=8, rerank_mult=1, use_gather_kernel=False,
                        source="lccs")
    starved = RecallDriftProbe(lambda: idx, torch.from_numpy(Q), lean, label="tobs-lean")
    assert 0.0 <= starved.measure() <= 1.0


@pytest.mark.parametrize("store", ["fp32", "int8"])
def test_drift_recall_equals_reference(data, store, tmp_path):
    X, Q = data
    # m 8, w 1 and lam = k: the served candidates miss some of the exact
    # LCCS ranking's, so the two recalls are compared below 1
    ref = RefIndex.build(X, m=8, family="euclidean", w=1.0, seed=7, store=store)
    ref.save(tmp_path / "idx.pkl")
    ours = LCCSIndex.load(tmp_path / "idx.pkl", device="cpu")
    Qs = np.concatenate([Q, X[:12] + 0.3])
    kw = dict(k=6, lam=6, width=6, rerank_mult=2, use_gather_kernel=False, source="lccs")
    from repro_torch.obs import RecallDriftProbe

    got = RecallDriftProbe(ours, Qs, SearchParams(**kw), label="tobs-parity").measure()
    want = RefProbe(ref, Qs, RefParams(**kw), label="tobs-parity").measure()
    assert got == want
    assert 0.5 < got < 1.0
