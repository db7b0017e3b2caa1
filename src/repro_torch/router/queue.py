"""Deadline-aware admission control for the serving front (the port's copy
of `repro.router.queue`, which imports no JAX).

The queue is the serving front's only shared mutable state: submitters
(`Router.submit`) race one worker thread per replica pulling micro-batches.
Four policies live here, and nowhere else:

  ordering   earliest-deadline-first (EDF), not arrival order -- a burst's
             tight-SLO requests are served ahead of lax ones that happened
             to arrive first.
  formation  a batch closes on `max_batch` queued requests or when
             lingering any longer would spend the earliest deadline's
             remaining slack (a deadline-driven timer seeded by the
             observed per-request service rate), whichever comes first --
             never on arrival order alone.
  shape      a micro-batch must be rectangular (`np.stack`), so the batch
             takes the EDF head's token shape and pulls only matching
             requests; mixed-length traffic keeps forming full batches
             instead of flushing on every length change the way
             `serve_stream`'s greedy coalescing does.
  bounds     depth beyond `max_depth` is rejected at the door with a
             retry-after estimate derived from the observed service rate:
             backpressure, not unbounded buffering.

`close()` wakes every waiter; a worker then drains whatever is queued
(linger timers short-circuit) and finally observes `None` -- the clean
drain-on-shutdown contract `Router.shutdown` relies on.
"""
from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass

import numpy as np


class QueueFull(RuntimeError):
    """Admission rejected: the replica's queue is at its depth bound.
    `retry_after_s` estimates when capacity frees up (queued depth times
    the observed per-request service time); well-behaved clients back off
    for that long instead of piling on."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(
            f"admission queue full (depth={depth}); retry after "
            f"~{retry_after_s * 1e3:.0f} ms"
        )
        self.depth = depth
        self.retry_after_s = retry_after_s


class Ticket:
    """Caller-side handle for one submitted request: a minimal future the
    replica worker fulfils.  `result()` blocks the submitter; the worker
    never blocks on it."""

    __slots__ = ("deadline", "t_submit", "replica", "_ev", "_value", "_exc")

    def __init__(self, deadline: float, t_submit: float, replica: str):
        self.deadline = deadline          # absolute perf_counter seconds
        self.t_submit = t_submit
        self.replica = replica
        self._ev = threading.Event()
        self._value = None
        self._exc: BaseException | None = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: float | None = None):
        """Block for this request's (ids, dists); re-raise a serving
        failure; TimeoutError if still in flight after `timeout`."""
        if not self._ev.wait(timeout):
            raise TimeoutError("request still in flight")
        if self._exc is not None:
            raise self._exc
        return self._value

    # -- worker side ---------------------------------------------------------

    def _fulfil(self, value) -> None:
        self._value = value
        self._ev.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()


@dataclass
class Request:
    """One admitted query: token ids (shape (L,)), its absolute deadline,
    and the ticket the worker fulfils."""

    tokens: np.ndarray
    deadline: float
    t_submit: float
    ticket: Ticket

    @property
    def shape(self) -> tuple:
        return self.tokens.shape


class AdmissionQueue:
    """Thread-safe bounded EDF queue (one per replica)."""

    def __init__(self, max_depth: int = 256, name: str = ""):
        self.max_depth = max_depth
        self.name = name
        self._heap: list[tuple[float, int, Request]] = []  # guarded-by: _cv
        self._cv = threading.Condition()
        self._seq = 0  # guarded-by: _cv
        self._closed = False  # guarded-by: _cv
        # EWMA per-request service time, fed back by the worker
        # (`note_service`); seeds both the retry-after estimate and the
        # deadline timer's slack reserve before any batch has completed
        self._per_req_s = 0.005  # guarded-by: _cv

    def depth(self) -> int:
        with self._cv:
            return len(self._heap)

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def offer(self, req: Request) -> None:
        """Admit one request, or raise `QueueFull` at the depth bound."""
        with self._cv:
            if self._closed:
                raise RuntimeError(f"admission queue {self.name!r} is closed")
            if len(self._heap) >= self.max_depth:
                raise QueueFull(
                    len(self._heap),
                    max(len(self._heap) * self._per_req_s, 1e-3),
                )
            heapq.heappush(self._heap, (req.deadline, self._seq, req))
            self._seq += 1
            self._cv.notify()

    def note_service(self, seconds: float, n_requests: int) -> None:
        """Worker feedback after each batch: keeps the EWMA service rate
        behind retry-after and the deadline timer current."""
        if n_requests <= 0:
            return
        per = seconds / n_requests
        with self._cv:
            self._per_req_s = 0.8 * self._per_req_s + 0.2 * per

    def next_batch(self, max_batch: int, *, linger_s: float = 0.002,
                   poll_s: float = 0.05) -> list[Request] | None:
        """Block for the next micro-batch (EDF order, one token shape), or
        `None` once the queue is closed and drained.

        The batch closes on whichever comes first: `max_batch` queued
        requests, the linger window expiring, or the earliest deadline's
        slack (deadline minus estimated batch service time) running out.
        An already-expired deadline dispatches immediately -- late work is
        served and counted as an SLO miss, never silently dropped."""
        now = time.perf_counter
        with self._cv:
            while not self._heap:
                if self._closed:
                    return None
                self._cv.wait(poll_s)
            t_anchor = now()
            while len(self._heap) < max_batch and not self._closed:
                # recompute each pass: a new arrival may carry an earlier
                # deadline and pull the close time forward
                slack_close = self._heap[0][0] - self._per_req_s * max_batch
                t_close = min(t_anchor + linger_s, slack_close)
                remaining = t_close - now()
                if remaining <= 0:
                    break
                self._cv.wait(min(remaining, poll_s))
            # EDF extraction, grouped on the head's token shape so the
            # batch is rectangular; mismatched shapes go back untouched
            picked: list[Request] = []
            skipped: list[tuple[float, int, Request]] = []
            shape: tuple | None = None
            while self._heap and len(picked) < max_batch:
                entry = heapq.heappop(self._heap)
                if shape is None:
                    shape = entry[2].shape
                if entry[2].shape == shape:
                    picked.append(entry[2])
                else:
                    skipped.append(entry)
            for entry in skipped:
                heapq.heappush(self._heap, entry)
            return picked

    def close(self) -> None:
        """Stop admissions and wake every waiter; workers drain what is
        queued, then observe None."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def flush(self, exc: BaseException) -> int:
        """Fail every queued request (non-draining shutdown).  Returns the
        number of requests flushed."""
        with self._cv:
            n = len(self._heap)
            for _, _, req in self._heap:
                req.ticket._fail(exc)
            self._heap.clear()
            return n
