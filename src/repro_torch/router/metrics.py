"""SLO metrics for the serving front (port of `repro.router.metrics`).

Latency here is *end-to-end*: submit-to-result, queue wait included -- the
number a user-facing SLO is written against, not the device-only time the
engine's `ServeStats` stage sums measure.  `RouterStats` composes both: the
router-level window (percentiles, queue depth, admission counters, batch
sizes) plus each replica engine's `ServeStats` delta over the same window,
so one snapshot answers both "are we meeting the SLO" and "did any replica
silently retrace" (`serve["plan_misses"]` flat).

Everything is windowed: `Router.reset_window()` re-baselines the counters
and clears the latency reservoir, which is how benchmarks and readiness
probes attribute activity to one measurement interval.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import asdict, dataclass, field

import numpy as np

from ..obs.registry import registry

_EMPTY = {"count": 0, "p50_ms": None, "p95_ms": None, "p99_ms": None,
          "mean_ms": None, "max_ms": None}


def percentiles_ms(latencies_s) -> dict:
    """p50/p95/p99/mean/max over per-request latencies (seconds in,
    milliseconds out, rounded for the JSON artifacts)."""
    vals = list(latencies_s)
    if not vals:
        return dict(_EMPTY)
    a = np.asarray(vals, dtype=np.float64) * 1e3
    return {
        "count": int(a.size),
        "p50_ms": round(float(np.percentile(a, 50)), 3),
        "p95_ms": round(float(np.percentile(a, 95)), 3),
        "p99_ms": round(float(np.percentile(a, 99)), 3),
        "mean_ms": round(float(a.mean()), 3),
        "max_ms": round(float(a.max()), 3),
    }


class LatencyWindow:
    """Bounded reservoir of recent per-request latencies (seconds).  The
    bound keeps a long-running router's memory flat; at the default 16k a
    window holds every request of any sane measurement interval.

    The lock covers every deque access: `record` runs on each replica's
    worker thread while `values`/`percentiles` run on callers' threads, and
    CPython deques only guarantee atomic single-op appends -- the
    append-while-snapshotting pattern needs the explicit lock.  Each recorded
    latency is also mirrored into the registry histogram
    `repro_router_latency_seconds{replica=<label>}`, so Prometheus and the
    registry's snapshot/delta windowing see the same stream this reservoir
    holds (`clear()` clears only the window view -- registry series are
    monotone by design)."""

    def __init__(self, maxlen: int = 16384, label: str = "router"):
        self._vals: deque[float] = deque(maxlen=maxlen)  # guarded-by: _lock
        self._lock = threading.Lock()
        self.label = label
        self._hist = registry().histogram(
            "repro_router_latency_seconds",
            "end-to-end submit-to-result request latency (queue wait "
            "included)",
            labelnames=("replica",),
        )

    def record(self, seconds: float) -> None:
        with self._lock:
            self._vals.append(seconds)
        self._hist.observe(seconds, replica=self.label)

    def values(self) -> list[float]:
        with self._lock:
            return list(self._vals)

    def clear(self) -> None:
        with self._lock:
            self._vals.clear()

    def percentiles(self) -> dict:
        return percentiles_ms(self.values())


@dataclass
class ReplicaStats:
    """One replica's slice of the window: router-side counters plus the
    engine's `ServeStats` delta (requests/batches/stage seconds/plan-cache
    hits+misses) attributed to this replica over the window."""

    name: str
    queue_depth: int
    completed: int
    deadline_misses: int
    batch_size_hist: dict[int, int]
    serve: dict


@dataclass
class RouterStats:
    """One windowed snapshot of the whole serving front."""

    admitted: int = 0
    rejected: int = 0
    completed: int = 0
    deadline_misses: int = 0
    queue_depth: int = 0
    latency: dict = field(default_factory=lambda: dict(_EMPTY))
    batch_size_hist: dict = field(default_factory=dict)
    replicas: list[ReplicaStats] = field(default_factory=list)

    def to_dict(self) -> dict:
        """JSON-ready form (BENCH_search.json, readiness probes)."""
        return asdict(self)
