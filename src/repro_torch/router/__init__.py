"""Async serving front of the port: deadline-aware continuous batching, SLO
metrics, and a replica router over `RetrievalEngine`s (port of
`repro.router`).

    router = Router.replicate(engine, 2, default_slo_ms=50.0)
    router.warm(sample_tokens)        # build plans once; replicas share them
    ticket = router.submit(tokens, deadline_ms=25.0)
    ids, dists = ticket.result()
    router.stats()                    # p50/p95/p99, depth, plan audit
    router.shutdown()                 # drains in-flight requests

See `queue.py` for the admission policy (EDF + deadline-driven batch
close + bounded-depth backpressure), `metrics.py` for the SLO window,
and `router.py` for dispatch and the warm plan-cache handoff.  The
replicas share one device, one stream, the model's weights and the index.
"""
from .metrics import LatencyWindow, ReplicaStats, RouterStats, percentiles_ms
from .queue import AdmissionQueue, QueueFull, Request, Ticket
from .router import Replica, Router

__all__ = [
    "AdmissionQueue",
    "LatencyWindow",
    "QueueFull",
    "Replica",
    "ReplicaStats",
    "Request",
    "Router",
    "RouterStats",
    "Ticket",
    "percentiles_ms",
]
