"""Replica router (port of `repro.router.router`): N engines behind one
deadline-aware `submit()`.

Each replica pairs one `RetrievalEngine` (or any engine-like object, see
below) with one `AdmissionQueue` and one worker thread.  `submit()` stamps
a deadline, picks the least-loaded queue (ties round-robin), and returns a
`Ticket`; the worker forms EDF micro-batches (`AdmissionQueue.next_batch`)
and serves them through the engine's non-blocking batch entry point
(`serve_batch_nowait(...).result()`).

Batches are padded to `engine.max_batch` by default ("bucketed" batching):
the plan cache then only ever sees one batch shape per token length, so the
no-rebuild guarantee holds for arbitrary traffic -- a half-full batch pays
full-batch compute, a bounded price for a bounded plan count.

Warm plan-cache handoff: replicas share one `SearchParams` and one index
object, and the plan cache (`repro_torch.exec`) keys on the index's
signature, so the first replica's build warms every replica.
`Router.replicate` shares the template engine's model (`nn.Module`) and
index: the weights are never copied, and all replicas run on the engine's
one device and its default stream.  `warm` serves a batch on the calling
thread first, so the kernel library is built and the TF32 switch set
(`kernels.common.no_tf32`, process-global) before the workers see traffic;
each worker's embed enters `torch.inference_mode` itself, which is
thread-local.

The router serves query traffic; corpus updates (insert/delete/compact)
stay on the engine's synchronous stream path -- a dynamic corpus behind
replicas would need consistency machinery this layer does not pretend to
have.

Engine protocol (duck-typed so tests can use stubs): `max_batch`, `stats`
(a `ServeStats`), `index` (not None once buildable), and
`serve_batch_nowait(tokens, params, n_live=...)` returning an object whose
`result()` yields `(ids, dists)` host arrays.
"""
from __future__ import annotations

import threading
import time
from collections import Counter

import numpy as np

# the submodule import path, not `from ..obs import trace`: the package
# re-exports the trace() contextmanager under that name
from ..obs.registry import registry
from ..obs.trace import add_span as _add_span
from ..obs.trace import span as _span

from .metrics import LatencyWindow, ReplicaStats, RouterStats, percentiles_ms
from .queue import AdmissionQueue, QueueFull, Request, Ticket

# batch sizes are small powers-of-two-ish counts, not durations
_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


def _pad_rows(rows: np.ndarray, to: int) -> np.ndarray:
    """Pad a (B, L) batch to B == `to` by repeating the last row; callers
    slice results back to the live prefix."""
    if rows.shape[0] >= to:
        return rows
    pad = np.repeat(rows[-1:], to - rows.shape[0], axis=0)
    return np.concatenate([rows, pad], axis=0)


class Replica:
    """One engine + queue + worker.  All non-queue mutable state is written
    by the worker thread only; readers see monotonic counters."""

    def __init__(self, name: str, engine, params, *, max_depth: int,
                 linger_s: float, pad_batches: bool):
        self.name = name
        self.engine = engine
        self.params = params
        self.linger_s = linger_s
        self.pad_batches = pad_batches
        self.queue = AdmissionQueue(max_depth, name=name)
        self.latency = LatencyWindow(label=name)
        reg = registry()
        self._c_completed = reg.counter(
            "repro_router_completed_total", "requests served to completion",
            labelnames=("replica",))
        self._c_misses = reg.counter(
            "repro_router_deadline_misses_total",
            "requests completed after their deadline",
            labelnames=("replica",))
        self._h_batch = reg.histogram(
            "repro_router_batch_size", "live requests per served micro-batch",
            labelnames=("replica",), buckets=_BATCH_BUCKETS)
        self._g_depth = reg.gauge(
            "repro_router_queue_depth", "admitted requests awaiting service",
            labelnames=("replica",))
        # monotonic totals; the window view subtracts the baselines below
        self.finished = 0      # requests that left the worker (ok or failed)
        self.completed = 0     # successfully served
        self.deadline_misses = 0
        self.hist: Counter[int] = Counter()
        self._b_completed = 0
        self._b_misses = 0
        self._b_hist: Counter[int] = Counter()
        self._b_serve = engine.stats.snapshot()
        self.thread = threading.Thread(
            target=self._loop, name=f"repro-router-{name}", daemon=True
        )

    def start(self) -> None:
        self.thread.start()

    def _loop(self) -> None:
        eng = self.engine
        while True:
            batch = self.queue.next_batch(eng.max_batch,
                                          linger_s=self.linger_s)
            if batch is None:
                return  # closed and drained
            n_live = len(batch)
            tokens = np.stack([r.tokens for r in batch])
            if self.pad_batches:
                tokens = _pad_rows(tokens, eng.max_batch)
            t0 = time.perf_counter()
            # retroactive queue-wait span: admission happened on the
            # submitter's thread, so the wait is only known at batch start
            _add_span("queue_wait", min(r.t_submit for r in batch), t0,
                      batch=n_live, replica=self.name)
            try:
                pending = eng.serve_batch_nowait(tokens, self.params,
                                                 n_live=n_live)
                ids, dists = pending.result()
            except Exception as exc:
                for r in batch:
                    r.ticket._fail(exc)
                self.finished += n_live
                continue
            t_done = time.perf_counter()
            self.queue.note_service(t_done - t0, n_live)
            self.hist[n_live] += 1
            self._h_batch.observe(n_live, replica=self.name)
            misses = 0
            for i, r in enumerate(batch):
                r.ticket._fulfil((ids[i], dists[i]))
                self.latency.record(t_done - r.t_submit)
                if t_done > r.deadline:
                    self.deadline_misses += 1
                    misses += 1
            self.completed += n_live
            self.finished += n_live
            self._c_completed.inc(n_live, replica=self.name)
            if misses:
                self._c_misses.inc(misses, replica=self.name)
            self._g_depth.set(self.queue.depth(), replica=self.name)

    def reset_window(self) -> None:
        self.latency.clear()
        self._b_completed = self.completed
        self._b_misses = self.deadline_misses
        self._b_hist = Counter(self.hist)
        self._b_serve = self.engine.stats.snapshot()

    def stats(self) -> ReplicaStats:
        hist = Counter(self.hist)
        hist.subtract(self._b_hist)
        serve = self.engine.stats.delta(self._b_serve)
        return ReplicaStats(
            name=self.name,
            queue_depth=self.queue.depth(),
            completed=self.completed - self._b_completed,
            deadline_misses=self.deadline_misses - self._b_misses,
            batch_size_hist={k: v for k, v in sorted(hist.items()) if v},
            serve={k: (round(v, 6) if isinstance(v, float) else v)
                   for k, v in vars(serve).items()},
        )


class Router:
    """Deadline-aware serving front over replicated engines."""

    def __init__(self, engines, *, params=None, max_depth: int = 256,
                 default_slo_ms: float = 100.0, linger_ms: float = 2.0,
                 pad_batches: bool = True, names=None):
        if not engines:
            raise ValueError("Router needs at least one engine")
        self.params = params if params is not None else getattr(
            engines[0], "search_params", None)
        self.default_slo_ms = default_slo_ms
        self.pad_batches = pad_batches
        names = names or [getattr(e, "name", None) or f"replica-{i}"
                          for i, e in enumerate(engines)]
        self.replicas = [
            Replica(n, e, self.params, max_depth=max_depth,
                    linger_s=linger_ms / 1e3, pad_batches=pad_batches)
            for n, e in zip(names, engines)
        ]
        self._lock = threading.Lock()
        self._admitted = 0  # guarded-by: _lock
        self._rejected = 0  # guarded-by: _lock
        self._b_admitted = 0  # guarded-by: _lock
        self._b_rejected = 0  # guarded-by: _lock
        self._rr = 0  # guarded-by: _lock
        self._shutdown = False  # guarded-by: _lock
        reg = registry()
        self._c_admitted = reg.counter(
            "repro_router_admitted_total", "requests admitted to a queue")
        self._c_rejected = reg.counter(
            "repro_router_rejected_total",
            "requests rejected at admission (queue full)")
        for r in self.replicas:
            r.start()

    # -- construction --------------------------------------------------------

    @classmethod
    def replicate(cls, engine, n_replicas: int, **kw) -> "Router":
        """Clone a built `RetrievalEngine` into `n_replicas` replicas that
        share its config, model (the same `nn.Module`: no weight is copied),
        device and index object -- the warm-handoff topology: one plan build
        per (params, shape) serves every replica.  The template engine is
        replica 0."""
        from ..serve import RetrievalEngine

        if engine.index is None:
            raise ValueError("replicate() needs a built index: call "
                             "build_index first")
        engine.name = getattr(engine, "name", None) or "replica-0"
        engines = [engine]
        for i in range(1, max(n_replicas, 1)):
            e = RetrievalEngine(
                engine.cfg, engine.model, m=engine.m, metric=engine.metric,
                max_batch=engine.max_batch,
                search_params=engine.search_params, store=engine.store,
                shards=engine.shards, device=engine.device, name=f"replica-{i}",
                instrument=getattr(engine, "instrument", False),
            )
            e.index = engine.index    # share the (immutable) index
            engines.append(e)
        return cls(engines, **kw)

    # -- admission -----------------------------------------------------------

    def submit(self, tokens: np.ndarray, *,
               deadline_ms: float | None = None) -> Ticket:
        """Admit one query (token ids, shape (L,)) with a deadline
        `deadline_ms` from now (default: the router's SLO).  Dispatches to
        the least-loaded replica queue (ties round-robin) and returns a
        `Ticket`; raises `QueueFull` with a retry-after hint when that
        queue is at its depth bound."""
        with self._lock:
            if self._shutdown:
                raise RuntimeError("router is shut down")
        tokens = np.asarray(tokens)
        if tokens.ndim != 1:
            raise ValueError(
                f"submit() takes one request's token ids, shape (L,); got "
                f"{tokens.shape} -- batches are formed by the router"
            )
        now = time.perf_counter()
        slo_ms = self.default_slo_ms if deadline_ms is None else deadline_ms
        with _span("router.submit"):
            depths = [r.queue.depth() for r in self.replicas]
            best = min(depths)
            cands = [i for i, d in enumerate(depths) if d == best]
            with self._lock:
                pick = cands[self._rr % len(cands)]
                self._rr += 1
            replica = self.replicas[pick]
            ticket = Ticket(now + slo_ms / 1e3, now, replica.name)
            try:
                replica.queue.offer(
                    Request(tokens, ticket.deadline, now, ticket))
            except QueueFull:
                with self._lock:
                    self._rejected += 1
                self._c_rejected.inc()
                raise
            with self._lock:
                self._admitted += 1
            self._c_admitted.inc()
        return ticket

    def submit_many(self, requests, *, deadline_ms=None) -> list[Ticket]:
        return [self.submit(t, deadline_ms=deadline_ms) for t in requests]

    # -- lifecycle -----------------------------------------------------------

    def warm(self, tokens) -> None:
        """Compile every plan the routed traffic will need: for each
        distinct token shape in `tokens` (a (B, L) array or a list of (L,)
        arrays, mixed lengths fine), run one padded micro-batch through
        every replica engine synchronously, then reset the stats window.
        Replica 0's build warms the shared plan cache, so later replicas
        hit it -- after `warm`, a steady-state run must show
        `plan_misses == 0` on every replica."""
        rows = ([np.asarray(t) for t in tokens]
                if isinstance(tokens, (list, tuple)) else [np.asarray(tokens)])
        groups: dict[tuple, list[np.ndarray]] = {}
        for t in rows:
            for row in (t[None] if t.ndim == 1 else t):
                groups.setdefault(row.shape, []).append(row)
        for rep in self.replicas:
            for rws in groups.values():
                batch = np.stack(rws[: rep.engine.max_batch])
                if self.pad_batches:
                    batch = _pad_rows(batch, rep.engine.max_batch)
                rep.engine.serve_batch_nowait(batch, self.params).result()
        self.reset_window()

    def ready(self) -> bool:
        """Readiness-probe predicate: every replica has a live worker, a
        built index, and at least one served (warm) batch."""
        return all(
            r.thread.is_alive()
            and r.engine.index is not None
            and r.engine.stats.batches > 0
            for r in self.replicas
        )

    def drain(self, timeout_s: float = 60.0, poll_s: float = 0.005) -> None:
        """Block until every admitted request has left the system --
        a shutdown-free barrier between measurement windows."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout_s:
            with self._lock:
                admitted = self._admitted
            if sum(r.finished for r in self.replicas) >= admitted:
                return
            time.sleep(poll_s)
        raise TimeoutError("router did not drain within timeout")

    def shutdown(self, *, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Stop admissions and join the workers.  With `drain=True` queued
        requests are served first (the workers' linger timers short-circuit
        once the queues close); otherwise they fail with RuntimeError."""
        with self._lock:
            self._shutdown = True
        if not drain:
            for r in self.replicas:
                r.queue.flush(RuntimeError(
                    "router shut down before serving this request"))
        for r in self.replicas:
            r.queue.close()
        deadline = time.perf_counter() + timeout_s
        for r in self.replicas:
            r.thread.join(max(deadline - time.perf_counter(), 0.0))
            if r.thread.is_alive():
                raise TimeoutError(
                    f"replica {r.name} did not stop within {timeout_s}s")

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc[0] is None)

    # -- observability -------------------------------------------------------

    def reset_window(self) -> None:
        """Start a fresh attribution window: clear latency reservoirs and
        re-baseline every counter, including each engine's ServeStats."""
        with self._lock:
            self._b_admitted = self._admitted
            self._b_rejected = self._rejected
        for r in self.replicas:
            r.reset_window()

    def stats(self) -> RouterStats:
        """One windowed snapshot: end-to-end latency percentiles, queue
        depth, admission counters, the merged batch-size histogram, and
        each replica's engine `ServeStats` delta (stage seconds + the
        per-replica plan-cache hit/miss attribution)."""
        reps = [r.stats() for r in self.replicas]
        lat: list[float] = []
        for r in self.replicas:
            lat.extend(r.latency.values())
        hist: Counter[int] = Counter()
        for rs in reps:
            hist.update(rs.batch_size_hist)
        with self._lock:
            admitted = self._admitted - self._b_admitted
            rejected = self._rejected - self._b_rejected
        return RouterStats(
            admitted=admitted,
            rejected=rejected,
            completed=sum(rs.completed for rs in reps),
            deadline_misses=sum(rs.deadline_misses for rs in reps),
            queue_depth=sum(rs.queue_depth for rs in reps),
            latency=percentiles_ms(lat),
            batch_size_hist={k: v for k, v in sorted(hist.items())},
            replicas=reps,
        )
