"""The port's serving front (`repro_torch.router`) and the engine's
non-blocking entry point:

  1. the 13 cases of `tests/test_router.py` with the port's router, the
     port's `ServeStats` and stub engines that import nothing of `repro`
     (EDF batch formation, shape grouping, batch close on size and on the
     deadline timer, backpressure, drain and non-drain shutdown,
     least-depth dispatch, late requests counted), and the steady-state
     no-rebuild guarantee over two replicas of the port's smoke gemma-2b;
  2. `serve_batch_nowait(...).result()` equals `serve_batch`, records the
     stats once, and counts `n_live`, not padding; `ServeStats.snapshot` /
     `delta`;
  3. the port's router against the reference's router on a smoke gemma-2b,
     the same requests: ids equal, distances within rtol/atol 1e-5.  Both
     sides embed through one table of the reference model's embeddings and
     search the same index (saved by the reference, loaded by the port), so
     the comparison holds the routing, batching and search, not the two
     models' float rounding (`test_torch_serve.py` holds those);
  4. the `launch.serve --async` CLI on the CPU (self-retrieval >= 29/32, a
     valid Chrome trace);
  5. the kernel launch counter stays exact under threads.
"""
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.router import AdmissionQueue, QueueFull, Request, Router, Ticket
from repro_torch.serve.engine import ServeStats

torch.set_num_threads(2)

# queue bugs show as hangs: with pytest-timeout each test gets a watchdog
pytestmark = pytest.mark.timeout(120)

ROOT = Path(__file__).resolve().parent.parent


def _offer(q: AdmissionQueue, deadline: float, length: int = 16) -> Ticket:
    now = time.perf_counter()
    t = Ticket(deadline, now, q.name)
    q.offer(Request(np.full(length, length, dtype=np.int32), deadline, now, t))
    return t


class StubPending:
    def __init__(self, fn):
        self._fn = fn

    def result(self):
        return self._fn()


class StubEngine:
    """Engine-protocol stub: instant (or gated/delayed) answers, the port's
    ServeStats accounting."""

    def __init__(self, max_batch=4, delay=0.0, gate=None, name="stub"):
        self.max_batch = max_batch
        self.delay = delay
        self.gate = gate                      # threading.Event or None
        self.entered = threading.Event()      # set when a batch is picked up
        self.name = name
        self.stats = ServeStats()
        self.search_params = None
        self.index = object()

    def serve_batch_nowait(self, tokens, params=None, *, n_live=None):
        self.entered.set()
        if self.gate is not None:
            self.gate.wait()
        if self.delay:
            time.sleep(self.delay)
        n = tokens.shape[0]

        def _finish():
            self.stats.batches += 1
            self.stats.requests += n if n_live is None else n_live
            self.stats.plan_hits += 1
            ids = np.tile(np.arange(5, dtype=np.int32), (n, 1))
            return ids, np.zeros((n, 5), np.float32)

        return StubPending(_finish)


# -- 1. the admission queue --------------------------------------------------------


def test_batch_formation_is_deadline_ordered():
    q = AdmissionQueue(max_depth=16)
    base = time.perf_counter() + 5.0
    for off in (0.5, 0.1, 0.9, 0.3):
        _offer(q, base + off)
    batch = q.next_batch(4, linger_s=0.0)
    assert [round(r.deadline - base, 1) for r in batch] == [0.1, 0.3, 0.5, 0.9]


def test_batch_groups_by_token_shape():
    q = AdmissionQueue(max_depth=16)
    base = time.perf_counter() + 5.0
    _offer(q, base + 0.3, length=16)
    _offer(q, base + 0.1, length=32)   # earliest -> head shape is L=32
    _offer(q, base + 0.4, length=16)
    _offer(q, base + 0.2, length=32)
    first = q.next_batch(4, linger_s=0.0)
    assert [r.shape for r in first] == [(32,), (32,)]
    second = q.next_batch(4, linger_s=0.0)
    assert [r.shape for r in second] == [(16,), (16,)]
    assert second[0].deadline < second[1].deadline


def test_batch_closes_on_max_batch():
    q = AdmissionQueue(max_depth=16)
    base = time.perf_counter() + 5.0
    for i in range(6):
        _offer(q, base + i)
    assert len(q.next_batch(4, linger_s=10.0)) == 4  # no linger when full
    assert q.depth() == 2


def test_deadline_timer_preempts_linger():
    q = AdmissionQueue(max_depth=16)
    _offer(q, time.perf_counter() + 0.02)
    t0 = time.perf_counter()
    batch = q.next_batch(8, linger_s=5.0)
    assert len(batch) == 1
    assert time.perf_counter() - t0 < 1.0


def test_backpressure_rejects_with_retry_after():
    q = AdmissionQueue(max_depth=3)
    base = time.perf_counter() + 5.0
    for i in range(3):
        _offer(q, base + i)
    with pytest.raises(QueueFull) as ei:
        _offer(q, base + 9)
    assert ei.value.depth == 3
    assert ei.value.retry_after_s > 0
    assert q.depth() == 3  # the rejected request was never queued


def test_close_drains_then_yields_none():
    q = AdmissionQueue(max_depth=16)
    base = time.perf_counter() + 5.0
    _offer(q, base)
    q.close()
    assert len(q.next_batch(4, linger_s=5.0)) == 1  # drain short-circuits
    assert q.next_batch(4) is None
    with pytest.raises(RuntimeError, match="closed"):
        _offer(q, base)


# -- 1. the router over stub engines -------------------------------------------------


def test_router_serves_and_reports_window_stats():
    router = Router([StubEngine(max_batch=4)], default_slo_ms=500.0, linger_ms=1.0)
    tickets = [router.submit(np.zeros(16, np.int32)) for _ in range(10)]
    outs = [t.result(timeout=30) for t in tickets]
    router.drain(timeout_s=30)
    assert all(ids.shape == (5,) for ids, _ in outs)
    st = router.stats()
    assert st.admitted == 10 and st.completed == 10 and st.rejected == 0
    assert st.latency["count"] == 10 and st.latency["p99_ms"] > 0
    assert sum(k * v for k, v in st.batch_size_hist.items()) == 10
    assert st.replicas[0].serve["requests"] == 10  # n_live, not padding
    router.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        router.submit(np.zeros(16, np.int32))


def test_router_backpressure_at_depth_bound():
    gate = threading.Event()
    eng = StubEngine(max_batch=1, gate=gate)
    router = Router([eng], max_depth=2, default_slo_ms=500.0, linger_ms=0.0)
    try:
        router.submit(np.zeros(16, np.int32))   # picked up, blocked on gate
        assert eng.entered.wait(10)
        deadline = time.perf_counter() + 10
        admitted = 1
        with pytest.raises(QueueFull) as ei:
            # the worker may race one more request out of the queue; keep
            # submitting until the depth bound rejects
            while time.perf_counter() < deadline:
                router.submit(np.zeros(16, np.int32))
                admitted += 1
        assert ei.value.retry_after_s > 0
        assert router.stats().rejected == 1
        assert router.stats().admitted == admitted
    finally:
        gate.set()
        router.shutdown()


def test_shutdown_drains_in_flight_requests():
    eng = StubEngine(max_batch=4, delay=0.01)
    router = Router([eng], default_slo_ms=500.0, linger_ms=1.0)
    tickets = [router.submit(np.zeros(16, np.int32)) for _ in range(12)]
    router.shutdown(drain=True, timeout_s=30)
    assert all(t.done() for t in tickets)
    assert all(t.result()[0].shape == (5,) for t in tickets)
    assert eng.stats.requests == 12


def test_shutdown_without_drain_fails_queued_requests():
    gate = threading.Event()
    eng = StubEngine(max_batch=1, gate=gate)
    router = Router([eng], max_depth=64, default_slo_ms=500.0, linger_ms=0.0)
    tickets = [router.submit(np.zeros(16, np.int32)) for _ in range(6)]
    assert eng.entered.wait(10)
    threading.Timer(0.1, gate.set).start()  # un-wedge mid-shutdown
    router.shutdown(drain=False, timeout_s=30)
    states = []
    for t in tickets:
        try:
            t.result(timeout=10)
            states.append("served")
        except RuntimeError:
            states.append("failed")
    assert states.count("served") >= 1
    assert states.count("failed") >= 4


def test_least_depth_dispatch_balances_replicas():
    gate = threading.Event()
    engines = [StubEngine(max_batch=1, gate=gate, name=f"s{i}") for i in range(2)]
    router = Router(engines, max_depth=64, default_slo_ms=500.0, linger_ms=0.0)
    try:
        for _ in range(10):
            router.submit(np.zeros(16, np.int32))
        depths = [r.queue.depth() for r in router.replicas]
        assert abs(depths[0] - depths[1]) <= 1, depths
        assert sum(depths) >= 8
    finally:
        gate.set()
        router.shutdown()


def test_expired_deadline_is_served_and_counted():
    eng = StubEngine(max_batch=4, delay=0.05)
    router = Router([eng], default_slo_ms=0.001, linger_ms=0.0)
    t = router.submit(np.zeros(16, np.int32))
    ids, _ = t.result(timeout=30)
    router.drain(timeout_s=30)
    assert ids.shape == (5,)
    assert router.stats().deadline_misses == 1
    router.shutdown()


# -- the port's smoke gemma-2b ---------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_engine():
    from repro_torch.configs import ARCHS
    from repro_torch.core import SearchParams
    from repro_torch.data.synthetic import lm_token_batches
    from repro_torch.models import init_model
    from repro_torch.serve import RetrievalEngine

    cfg = ARCHS["gemma-2b"].smoke()
    engine = RetrievalEngine(cfg, init_model(cfg, seed=0, device="cpu"), m=16,
                             metric="angular", max_batch=8, device="cpu",
                             search_params=SearchParams(k=3, lam=16))
    corpus, _ = lm_token_batches(vocab=cfg.vocab, seed=7)(0, 48, 16)
    engine.build_index(corpus)
    return engine, corpus


def test_replicas_never_rebuild_in_steady_state(smoke_engine):
    """After warm(), two replicas of the port's engine serve with a flat
    plan_misses on every replica while plan_hits grow."""
    from repro_torch.exec import plan_cache

    engine, corpus = smoke_engine
    router = Router.replicate(engine, 2, default_slo_ms=2000.0, linger_ms=1.0)
    try:
        assert router.replicas[1].engine.model is engine.model  # no weight copied
        assert router.replicas[1].engine.index is engine.index
        router.warm(corpus[:8])
        assert router.ready()
        st = router.stats()  # warm() reset the window
        assert st.completed == 0
        assert all(r.serve["plan_misses"] == 0 for r in st.replicas)

        tickets = [router.submit(corpus[i % 48]) for i in range(32)]
        outs = [t.result(timeout=120) for t in tickets]
        router.drain(timeout_s=60)

        hits = sum(int((i % 48) in outs[i][0]) for i in range(32))
        assert hits >= 29, f"self-retrieval {hits}/32"
        st = router.stats()
        assert st.completed == 32
        for r in st.replicas:
            assert r.serve["plan_misses"] == 0, f"{r.name} rebuilt: {r.serve}"
            assert r.serve["plan_evictions"] == 0
        served = [r for r in st.replicas if r.serve["batches"] > 0]
        assert served and all(r.serve["plan_hits"] > 0 for r in served)
        assert sum(r.serve["requests"] for r in st.replicas) == 32  # n_live
        scopes = plan_cache().stats()["scopes"]
        assert "replica-0" in scopes and scopes["replica-0"]["hits"] > 0
    finally:
        router.shutdown()
        engine.name = None


# -- 2. the non-blocking entry point, snapshot / delta --------------------------------


def test_serve_batch_nowait_equals_serve_batch(smoke_engine):
    from repro_torch.obs.registry import registry

    engine, corpus = smoke_engine
    engine.name = "trouter-nowait"
    try:
        want_ids, want_d = engine.serve_batch(corpus[8:16])
        before = engine.stats.snapshot()
        c_req = registry().get("repro_serve_requests_total")
        req0 = c_req.value(engine="default")
        pending = engine.serve_batch_nowait(corpus[8:16], n_live=5)
        assert engine.stats.delta(before).batches == 0  # recorded on result()
        ids, dists = pending.result()
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(dists, want_d)
        assert pending.result()[0] is ids  # a second call records nothing
        d = engine.stats.delta(before)
        assert (d.requests, d.batches, d.plan_hits, d.plan_misses) == (5, 1, 1, 0)
        assert d.embed_s > 0 and d.search_s >= 0
        assert c_req.value(engine="default") == req0 + 5  # registered at __init__
    finally:
        engine.name = None


def test_serve_stats_snapshot_and_delta():
    s = ServeStats(requests=7, batches=2, embed_s=1.5, plan_hits=3, plan_evictions=1)
    snap = s.snapshot()
    assert snap == s and snap is not s
    s.requests += 5
    s.batches += 1
    s.embed_s += 0.25
    s.plan_misses += 2
    d = s.delta(snap)
    assert (d.requests, d.batches, d.embed_s, d.plan_hits, d.plan_misses,
            d.plan_evictions) == (5, 1, 0.25, 0, 2, 0)
    assert snap.requests == 7  # the snapshot is independent


# -- 3. the port's router against the reference's -------------------------------------


def _table_embed(corpus, emb, to):
    rows = {r.tobytes(): i for i, r in enumerate(corpus)}
    return lambda toks: to(emb[[rows[r.tobytes()] for r in np.asarray(toks)]])


def _route(router, embed, corpus, picks):
    for r in router.replicas:
        r.engine.embed = embed
    try:
        router.warm(corpus[:8])
        tickets = [router.submit(corpus[i]) for i in picks]
        outs = [t.result(timeout=120) for t in tickets]
        router.drain(timeout_s=60)
        return outs, router.stats()
    finally:
        router.shutdown()


def test_router_matches_reference_router(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as REF_ARCHS
    from repro.core import SearchParams as RefParams
    from repro.models import api as ref_api
    from repro.router import Router as RefRouter
    from repro.serve import RetrievalEngine as RefEngine
    from repro_torch.configs import ARCHS
    from repro_torch.core import LCCSIndex, SearchParams
    from repro_torch.data.synthetic import lm_token_batches
    from repro_torch.models import init_model
    from repro_torch.serve import RetrievalEngine

    ref_cfg, cfg = REF_ARCHS["gemma-2b"].smoke(), ARCHS["gemma-2b"].smoke()
    corpus, _ = lm_token_batches(vocab=cfg.vocab, seed=5)(0, 40, 16)
    ref = RefEngine(ref_cfg, ref_api.init_model(jax.random.key(0), ref_cfg), m=16,
                    max_batch=8, search_params=RefParams(k=3, lam=16), name="trouter-0")
    emb = np.asarray(ref.embed(corpus))  # the reference model's embeddings
    ref.embed = _table_embed(corpus, emb, jnp.asarray)
    ref.build_index(corpus)
    ref.index.save(tmp_path / "idx.pkl")
    ours = RetrievalEngine(cfg, init_model(cfg, seed=0, device="cpu"), m=16, max_batch=8,
                           device="cpu", search_params=SearchParams(k=3, lam=16),
                           name="trouter-0")
    ours.index = LCCSIndex.load(tmp_path / "idx.pkl", device="cpu")
    picks = np.random.default_rng(3).integers(0, 40, 28)
    kw = dict(default_slo_ms=5000.0, linger_ms=1.0)
    r_outs, r_st = _route(RefRouter.replicate(ref, 2, **kw),
                          _table_embed(corpus, emb, jnp.asarray), corpus, picks)
    o_outs, o_st = _route(Router.replicate(ours, 2, **kw),
                          _table_embed(corpus, emb, torch.from_numpy), corpus, picks)
    for i, ((r_ids, r_d), (o_ids, o_d)) in enumerate(zip(r_outs, o_outs)):
        np.testing.assert_array_equal(o_ids, np.asarray(r_ids), err_msg=f"request {i}")
        np.testing.assert_allclose(o_d, np.asarray(r_d), rtol=1e-5, atol=1e-5)
    assert sum(int(p in ids) for p, (ids, _) in zip(picks, o_outs)) >= 0.9 * len(picks)
    for st in (r_st, o_st):
        assert st.completed == len(picks) and st.rejected == 0
        assert all(r.serve["plan_misses"] == 0 for r in st.replicas)
    assert [r.name for r in o_st.replicas] == [r.name for r in r_st.replicas]


# -- 4. the async CLI on the CPU ------------------------------------------------------


def test_async_cli_serves_and_traces(tmp_path):
    trace = tmp_path / "serve_trace.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma-2b", "--smoke",
         "--device", "cpu", "--corpus", "64", "--requests", "32", "--m", "16", "--async",
         "--replicas", "2", "--instrument", "--trace", str(trace), "--drift-probe", "8"],
        capture_output=True, text=True, timeout=300,
        env={**{k: os.environ[k] for k in ("HOME", "TMPDIR") if k in os.environ},
             "PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    hits = re.search(r"async: 32 completed / 0 rejected / \d+ SLO misses .*"
                     r"self-retrieval (\d+)/32", out.stdout)
    assert hits and int(hits.group(1)) >= 29, out.stdout
    audits = re.findall(r"replica-\d: \d+ batches, .* plan (\d+) compiles / \d+ reuses / "
                        r"(\d+) evictions", out.stdout)
    assert len(audits) == 2 and all(a == ("0", "0") for a in audits), out.stdout
    assert re.search(r"recall-drift probe: recall@5 = [01]\.\d+ over 8", out.stdout)
    doc = json.loads(trace.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"router.submit", "queue_wait", "serve_batch", "embed", "search",
            "exec.hash_queries", "exec.probe", "exec.gather"} <= names, names
    for e in doc["traceEvents"]:
        assert e["ph"] == "X" and e["dur"] >= 0 and {"ts", "pid", "tid"} <= set(e)


# -- 5. the launch counter under threads ---------------------------------------------


class _CountingLock:
    def __init__(self):
        self._lock = threading.Lock()
        self.entered = 0

    def __enter__(self):
        self._lock.acquire()
        self.entered += 1
        return self

    def __exit__(self, *exc):
        self._lock.release()


def test_launch_counter_is_exact_under_threads(monkeypatch):
    """`common.launch` counts under the counter's lock: eight threads
    launching at once, with the interpreter switching threads every
    microsecond, lose no count, and every launch took the lock (a bare
    `LAUNCHES[k] += 1` is a read and a write that threads may interleave)."""
    lock = _CountingLock()
    monkeypatch.setattr(common, "_count_lock", lock)
    monkeypatch.setattr(common, "library",
                        lambda: SimpleNamespace(csa_probe_launch=lambda *a: 0))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    common.reset_launch_counts()
    n_threads, per = 8, 5000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            common.launch("csa_probe", "csa_probe_launch") for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    counts = common.launch_counts()
    common.reset_launch_counts()
    assert counts["csa_probe"] == n_threads * per
    assert sum(counts.values()) == n_threads * per
    assert lock.entered >= n_threads * per
