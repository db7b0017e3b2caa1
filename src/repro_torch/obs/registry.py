"""The metrics registry of the port (a copy of `repro.obs.registry`, which
imports no JAX; the port keeps its own so it imports nothing of `repro`).
Every counter of the serving path lives here, under the reference's metric
names letter for letter, so a scrape of either package reads the same
series:

    Counter    monotonic float; `inc(amount, **labels)`.  `reset()` exists
               for test isolation only.
    Gauge      last-write-wins float; `set(value, **labels)`.
    Histogram  cumulative bucket counts + sum + count for Prometheus
               exposition, and a bounded raw-sample reservoir (seq-stamped)
               so windowed consumers get exact percentiles.

All three are label-aware (one metric, many series) and lock-protected:
`record()` from replica worker threads never races a scrape's iteration.

Snapshot/delta windows:

    snap = registry().snapshot()
    ... serve a measurement window ...
    d = registry().since(snap)
    d.value("repro_router_deadline_misses_total")        # counter delta
    d.samples("repro_router_latency_seconds")            # window's raw obs

`since` attributes activity to one window without resetting anything.
The registry is process-global (`registry()`), like the plan cache.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Any

# Prometheus-style default buckets, biased toward serving latencies in
# seconds: 250us .. 10s covers an embed stage through a saturated queue.
DEFAULT_BUCKETS = (
    0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class _Metric:
    """Shared label plumbing: a metric is a named family of series, one per
    label-value tuple.  Subclasses define the per-series state."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[tuple, Any] = {}  # guarded-by: _lock

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[k]) for k in self.labelnames)

    def _match(self, labels: dict) -> list[tuple]:  # holds: _lock
        """Series keys matching a *partial* label filter (read-side sugar:
        `value(name)` sums every series, `value(name, scope="x")` one)."""
        unknown = set(labels) - set(self.labelnames)
        if unknown:
            raise ValueError(
                f"metric {self.name!r} has no labels {sorted(unknown)}; "
                f"labelnames are {self.labelnames}"
            )
        pos = {k: self.labelnames.index(k) for k in labels}
        return [
            key for key in self._series
            if all(key[i] == str(labels[k]) for k, i in pos.items())
        ]

    def match_keys(self, labels: dict) -> list[tuple]:
        """Locked `_match` -- the entry point for external read-side
        consumers (`Delta`) that do not hold the metric lock."""
        with self._lock:
            return self._match(labels)

    def labelsets(self) -> list[dict]:
        with self._lock:
            return [dict(zip(self.labelnames, key)) for key in self._series]

    def reset(self) -> None:
        """Drop every series (TEST ISOLATION ONLY -- production metrics are
        monotonic; a mid-flight reset breaks scrape deltas)."""
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(sum(self._series[k] for k in self._match(labels)))

    def collect(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._series)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            keys = self._match(labels)
            return float(sum(self._series[k] for k in keys)) if keys else 0.0

    def collect(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._series)


class _HistSeries:
    """One histogram series: cumulative buckets for exposition + a bounded
    seq-stamped reservoir for exact windowed percentiles."""

    __slots__ = ("count", "sum", "buckets", "reservoir", "seq")

    def __init__(self, n_buckets: int, maxlen: int):
        self.count = 0
        self.sum = 0.0
        self.buckets = [0] * n_buckets  # non-cumulative; render accumulates
        self.reservoir: deque[tuple[int, float]] = deque(maxlen=maxlen)
        self.seq = 0  # monotonically stamps every observation


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets=DEFAULT_BUCKETS, reservoir: int = 16384):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        self.reservoir = reservoir

    def _get(self, key: tuple) -> _HistSeries:  # holds: _lock
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.buckets) + 1,
                                                self.reservoir)
        return s

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = self._key(labels)
        with self._lock:
            s = self._get(key)
            s.count += 1
            s.sum += value
            i = 0
            for i, b in enumerate(self.buckets):
                if value <= b:
                    break
            else:
                i = len(self.buckets)  # +Inf bucket
            s.buckets[i] += 1
            s.seq += 1
            s.reservoir.append((s.seq, value))

    def samples(self, since_seq: int | None = None, **labels) -> list[float]:
        """Raw reservoir samples across matching series, optionally only
        those observed after `since_seq` (per-series when filtering one
        series; summed-seq baselines come from `Registry.snapshot`)."""
        with self._lock:
            out: list[float] = []
            for key in self._match(labels):
                s = self._series[key]
                for seq, v in s.reservoir:
                    if since_seq is None or seq > since_seq:
                        out.append(v)
            return out

    def count(self, **labels) -> int:
        with self._lock:
            return sum(self._series[k].count for k in self._match(labels))

    def sum_value(self, **labels) -> float:
        with self._lock:
            return float(sum(self._series[k].sum
                             for k in self._match(labels)))

    def collect(self) -> dict[tuple, dict]:
        with self._lock:
            return {
                key: {"count": s.count, "sum": s.sum,
                      "buckets": list(s.buckets), "seq": s.seq}
                for key, s in self._series.items()
            }

    def _seqs(self) -> dict[tuple, int]:
        with self._lock:
            return {key: s.seq for key, s in self._series.items()}

    def _samples_after(self, baselines: dict[tuple, int],
                       labels: dict) -> list[float]:
        with self._lock:
            out: list[float] = []
            for key in self._match(labels):
                base = baselines.get(key, 0)
                for seq, v in self._series[key].reservoir:
                    if seq > base:
                        out.append(v)
            return out


class Snapshot:
    """Point-in-time copy of every counter/gauge value and every histogram's
    (count, sum, seq) -- the baseline `Registry.since` diffs against."""

    def __init__(self, counters, gauges, hists):
        self.counters = counters  # {name: {key: value}}
        self.gauges = gauges
        self.hists = hists        # {name: {key: {"count","sum","seq"}}}


class Delta:
    """One measurement window: registry activity since a `Snapshot`."""

    def __init__(self, reg: "Registry", snap: Snapshot):
        self._reg = reg
        self._snap = snap

    def value(self, name: str, **labels) -> float:
        """Counter (or gauge) change over the window, summed across series
        matching the partial label filter."""
        m = self._reg.get(name)
        base = (self._snap.counters.get(name)
                or self._snap.gauges.get(name) or {})
        cur = m.collect()
        keys = m.match_keys(labels)
        return float(sum(cur.get(k, 0.0) - base.get(k, 0.0) for k in keys))

    def samples(self, name: str, **labels) -> list[float]:
        """A histogram's raw observations recorded during the window (exact
        as long as the window fits the reservoir bound)."""
        m = self._reg.get(name)
        if not isinstance(m, Histogram):
            raise TypeError(f"{name!r} is a {m.kind}, not a histogram")
        base = {k: v["seq"]
                for k, v in self._snap.hists.get(name, {}).items()}
        return m._samples_after(base, labels)

    def count(self, name: str, **labels) -> int:
        m = self._reg.get(name)
        base = self._snap.hists.get(name, {})
        cur = m.collect()
        keys = m.match_keys(labels)
        return int(sum(cur.get(k, {"count": 0})["count"]
                       - base.get(k, {"count": 0})["count"] for k in keys))


class Registry:
    """Process-wide metric namespace.  `counter`/`gauge`/`histogram` are
    get-or-create: re-declaring an existing name returns the same metric
    object (labelnames and kind must match -- two subsystems silently
    emitting different shapes under one name is the bug this raises on)."""

    def __init__(self):
        self._metrics: OrderedDict[str, _Metric] = OrderedDict()  # guarded-by: _lock
        self._lock = threading.Lock()

    def _declare(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames, **kw)
                return m
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {m.labelnames}; cannot redeclare as {cls.kind} "
                f"with {tuple(labelnames)}"
            )
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._declare(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._declare(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS, reservoir=16384) -> Histogram:
        return self._declare(Histogram, name, help, labelnames,
                             buckets=buckets, reservoir=reservoir)

    def get(self, name: str) -> _Metric:
        with self._lock:
            try:
                return self._metrics[name]
            except KeyError:
                raise KeyError(f"no metric named {name!r}") from None

    def collect(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # -- snapshot / delta ----------------------------------------------------

    def snapshot(self) -> Snapshot:
        counters, gauges, hists = {}, {}, {}
        for m in self.collect():
            if isinstance(m, Counter):
                counters[m.name] = m.collect()
            elif isinstance(m, Gauge):
                gauges[m.name] = m.collect()
            elif isinstance(m, Histogram):
                hists[m.name] = m.collect()
        return Snapshot(counters, gauges, hists)

    def since(self, snap: Snapshot) -> Delta:
        return Delta(self, snap)

    def reset(self) -> None:
        """Zero every metric (TEST ISOLATION ONLY)."""
        for m in self.collect():
            m.reset()


_REGISTRY = Registry()


def registry() -> Registry:
    """The process-global registry (one per process, like the plan cache)."""
    return _REGISTRY
