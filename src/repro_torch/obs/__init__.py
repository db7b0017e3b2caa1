"""`repro_torch.obs`: observability for the port's query path (port of
`repro.obs`, kept as the port's own copy: it imports nothing of `repro`).

    registry   `Counter`/`Gauge`/`Histogram` with labels, lock-protected,
               snapshot/delta windowing.  `ServeStats`, `RouterStats`,
               `LatencyWindow` and the plan cache's scope counters emit here,
               under the reference's metric names.
    tracing    `span("embed")`-style context managers threaded through
               Router.submit -> AdmissionQueue -> Replica ->
               RetrievalEngine.serve_batch -> exec stages, exported as
               Chrome-trace JSON (perfetto-loadable); `device_profile()`
               wraps `torch.profiler` for a kernel timeline.
    stages     instrumented plans (`execute(..., instrument=True)`) time
               every exec stage, fenced by `trace.fence` (a device synchronize on
               CUDA), into `repro_exec_stage_seconds{topology,stage}`.
    exposition `start_metrics_server(port)` serves Prometheus text format;
               `StatsLogger` prints the periodic one-liner.
    drift      `RecallDriftProbe` replays a pinned query sample against
               brute-force ground truth and gauges achieved recall.

Everything is opt-in: tracing disabled is a single bool check, and plans
built without `instrument` are the plain runners.
"""
from .registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    registry,
)
from .trace import (
    add_span,
    clear_trace,
    device_profile,
    disable_tracing,
    enable_tracing,
    events,
    export_chrome_trace,
    span,
    stage,
    to_chrome_trace,
    trace,
    tracing_enabled,
)
from .prom import MetricsServer, StatsLogger, render_text, start_metrics_server
from .drift import RecallDriftProbe, recall_at_k

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsServer",
    "RecallDriftProbe",
    "Registry",
    "StatsLogger",
    "add_span",
    "clear_trace",
    "device_profile",
    "disable_tracing",
    "enable_tracing",
    "events",
    "export_chrome_trace",
    "recall_at_k",
    "registry",
    "render_text",
    "span",
    "stage",
    "start_metrics_server",
    "to_chrome_trace",
    "trace",
    "tracing_enabled",
]
