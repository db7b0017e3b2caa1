"""Exposition: Prometheus text format over HTTP + the one-line periodic log.

    server = start_metrics_server(port=9100)   # /metrics, daemon thread
    print(render_text())                       # the same payload, in-process

The renderer follows the Prometheus text exposition format 0.0.4: HELP/TYPE
headers, escaped label values, histogram series as cumulative `_bucket{le=}`
plus `_sum`/`_count`.  `launch.serve --metrics-port` serves it; any scraper
parses it.  (The port's copy of `repro.obs.prom`, which imports no JAX.)

`StatsLogger` is the human-facing twin: a background thread that prints one
line per interval from a registry snapshot/delta -- requests served, QPS,
plan compiles, p50/p99 -- so an operator tailing the launcher's stdout sees
the same numbers Prometheus would, without running a scraper.
"""
from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .registry import Counter, Gauge, Histogram, registry


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _labels(names, key, extra=()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, key)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _num(x: float) -> str:
    if x == float("inf"):
        return "+Inf"
    return repr(float(x))


def render_text(reg=None) -> str:
    """The whole registry in Prometheus text exposition format."""
    reg = reg or registry()
    out: list[str] = []
    for m in reg.collect():
        out.append(f"# HELP {m.name} {_escape(m.help or m.name)}")
        out.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, (Counter, Gauge)):
            for key, val in sorted(m.collect().items()):
                out.append(f"{m.name}{_labels(m.labelnames, key)} {_num(val)}")
        elif isinstance(m, Histogram):
            for key, s in sorted(m.collect().items()):
                cum = 0
                for le, n in zip(m.buckets, s["buckets"]):
                    cum += n
                    out.append(
                        f"{m.name}_bucket"
                        f"{_labels(m.labelnames, key, [('le', _num(le))])}"
                        f" {cum}"
                    )
                out.append(
                    f"{m.name}_bucket"
                    f"{_labels(m.labelnames, key, [('le', '+Inf')])}"
                    f" {s['count']}"
                )
                out.append(f"{m.name}_sum{_labels(m.labelnames, key)}"
                           f" {_num(s['sum'])}")
                out.append(f"{m.name}_count{_labels(m.labelnames, key)}"
                           f" {s['count']}")
    return "\n".join(out) + "\n"


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 -- http.server API
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_response(404)
            self.end_headers()
            return
        body = render_text(self.server._repro_registry).encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # noqa: D102 -- silence per-scrape stderr spam
        pass


class MetricsServer:
    """Daemon-threaded /metrics endpoint.  `port=0` binds an ephemeral port
    (tests); read it back from `.port`."""

    def __init__(self, port: int = 9100, host: str = "", reg=None):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd._repro_registry = reg or registry()
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-metrics",
            daemon=True,
        )

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def start_metrics_server(port: int = 9100, host: str = "",
                         reg=None) -> MetricsServer:
    return MetricsServer(port, host, reg).start()


class StatsLogger:
    """One periodic log line from registry deltas: served requests, QPS,
    plan compiles, end-to-end p50/p99 over the interval."""

    def __init__(self, interval_s: float = 10.0, emit=print, reg=None):
        self.interval_s = interval_s
        self.emit = emit
        self.reg = reg or registry()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="repro-stats-log", daemon=True)

    def line(self, delta, dt: float) -> str:
        def d(name, **labels):
            try:
                return delta.value(name, **labels)
            except KeyError:
                return 0.0

        reqs = d("repro_serve_requests_total")
        misses = d("repro_plan_cache_misses_total")
        slo_miss = d("repro_router_deadline_misses_total")
        try:
            lat = delta.samples("repro_router_latency_seconds")
        except KeyError:
            lat = []
        if lat:
            a = np.asarray(lat) * 1e3
            pct = (f"p50/p99 {np.percentile(a, 50):.1f}/"
                   f"{np.percentile(a, 99):.1f} ms")
        else:
            pct = "p50/p99 -/- ms"
        return (f"[obs] {reqs:.0f} req in {dt:.1f}s "
                f"({reqs / dt if dt else 0.0:.1f} QPS); {pct}; "
                f"{slo_miss:.0f} SLO misses; {misses:.0f} plan compiles")

    def _loop(self) -> None:
        snap = self.reg.snapshot()
        t0 = time.perf_counter()
        while not self._stop.wait(self.interval_s):
            t1 = time.perf_counter()
            self.emit(self.line(self.reg.since(snap), t1 - t0))
            snap, t0 = self.reg.snapshot(), t1

    def start(self) -> "StatsLogger":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
