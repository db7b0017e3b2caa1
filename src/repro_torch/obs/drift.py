"""Recall-drift probe (port of `repro.obs.drift`): the feedback signal a
self-driving `SearchParams` tuner consumes.

An LSH deployment's recall is set at tuning time against a sample, then
silently drifts as the corpus churns (inserts shift the distance
distribution, deletes thin the candidate sets).  The probe pins a sample of
queries at construction and, on demand or on a cadence, replays them twice
against the *current* index -- once through the serving `SearchParams`,
once through the exact `source="bruteforce"` route (dense scoring over
every row, the same verification stages) -- and records achieved recall@k
as the gauge

    repro_recall_drift{probe=<label>}

Ground truth is recomputed per measurement on purpose: drift is "how far is
the served answer from the best answer available *now*", so the truth must
track corpus churn.  Both routes run through `repro_torch.exec.execute`, so
the probe's plans live in the ordinary plan cache (two extra plans total).
On the card the truth's `bruteforce` source ranks through `circrun_topk`.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .registry import registry


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def recall_at_k(ids, truth) -> float:
    """Mean |served ∩ truth| / |truth| per query; -1 padding ignored."""
    ids, truth = _host(ids), _host(truth)
    per_q = []
    for srv, tru in zip(ids, truth):
        t = set(int(x) for x in tru if x >= 0)
        if not t:
            continue
        s = set(int(x) for x in srv if x >= 0)
        per_q.append(len(s & t) / len(t))
    return float(np.mean(per_q)) if per_q else 0.0


class RecallDriftProbe:
    """Replay a pinned query sample against brute-force ground truth and
    gauge the achieved recall.

    index_fn   zero-arg callable returning the current index (pass
               ``lambda: engine.index`` so a dynamic corpus is re-read per
               measurement); a bare index object is also accepted.
    queries    (B, d) float32 pinned sample (numpy or a tensor) -- embed
               once, pin forever: the probe measures index drift, not
               embedding drift.
    params     the *serving* SearchParams under test (defaults mirror
               `execute`'s defaults).
    """

    def __init__(self, index_fn, queries, params=None, *,
                 label: str = "default", interval_s: float | None = None):
        self._index_fn = index_fn if callable(index_fn) else lambda: index_fn
        self.queries = (queries.detach().float() if isinstance(queries, torch.Tensor)
                        else torch.from_numpy(np.asarray(queries, np.float32)))
        self.params = params
        self.label = label
        self.interval_s = interval_s
        self.history: list[tuple[float, float]] = []  # (unix ts, recall)
        self._gauge = registry().gauge(
            "repro_recall_drift",
            "achieved recall@k of the serving SearchParams vs brute-force "
            "ground truth over the pinned probe sample",
            labelnames=("probe",),
        )
        self._runs = registry().counter(
            "repro_recall_drift_measurements_total",
            "completed drift-probe measurements", labelnames=("probe",),
        )
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _truth_params(self, p):
        from ..core.params import _suppress_width_warning

        # exact route: dense bruteforce scoring with a candidate budget
        # covering the serving cut; keep the store/verify config identical so
        # the probe isolates *candidate-generation* recall (the LSH part)
        with _suppress_width_warning():
            return p.replace(source="bruteforce", probes=1)

    def measure(self) -> float:
        """One measurement: serve + ground-truth the pinned sample, record
        the gauge, return achieved recall in [0, 1]."""
        from ..exec import execute, resolve_params

        index = self._index_fn()
        p = resolve_params(index, self.params)
        ids, _ = execute(index, self.queries, p)
        truth, _ = execute(index, self.queries, self._truth_params(p))
        recall = recall_at_k(ids, truth)
        self._gauge.set(recall, probe=self.label)
        self._runs.inc(probe=self.label)
        self.history.append((time.time(), recall))
        return recall

    def last(self) -> float | None:
        return self.history[-1][1] if self.history else None

    # -- cadence -------------------------------------------------------------

    def start(self) -> "RecallDriftProbe":
        """Measure on a background cadence (`interval_s` required)."""
        if self.interval_s is None:
            raise ValueError("interval_s not set; call measure() directly "
                             "or construct with interval_s=")
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"repro-drift-{self.label}", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.measure()
            except Exception:  # pragma: no cover -- keep the cadence alive
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=10)

    def __enter__(self) -> "RecallDriftProbe":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
