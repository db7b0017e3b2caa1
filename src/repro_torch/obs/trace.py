"""End-to-end tracing of the port: `span()` context managers through the
whole query path, exported as Chrome-trace JSON (perfetto-loadable); port of
`repro.obs.trace`.

The span tree for one served request:

    router.submit            (submitter thread)
    queue_wait               (worker thread, recorded retroactively per batch)
    serve_batch
      embed
      search
        exec.hash_queries    (instrumented plans only -- see exec.topology)
        exec.probe
        exec.gather / exec.survivors / exec.rerank / exec.merge

Tracing is OFF by default and `span()` is a guarded no-op when disabled: one
module-global bool check.  Enable with `enable_tracing()` (or the `trace()`
context manager, which also exports on exit), then load the JSON at
https://ui.perfetto.dev or chrome://tracing.

Stage timing is separate from tracing: instrumented exec plans always record
per-stage seconds into the registry histogram
`repro_exec_stage_seconds{topology,stage}`, and add trace events when
tracing is on.  A stage's interval covers its device work because the plan
fences each stage's output with `fence` (`torch.cuda.synchronize` of the
device its tensors lie on; nothing on the CPU, where PyTorch runs eagerly).
`device_profile()` wraps `torch.profiler` for a kernel timeline beside the
host-side span tree.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

import torch

from .registry import registry

_enabled = False
_lock = threading.Lock()
_events: list[dict] = []
_t0 = time.perf_counter()  # trace epoch: ts fields are µs since this

_STAGE_HIST = None  # lazily-declared registry histogram (import-order safe)


def _stage_hist():
    global _STAGE_HIST
    if _STAGE_HIST is None:
        _STAGE_HIST = registry().histogram(
            "repro_exec_stage_seconds",
            "per-stage device-inclusive wall seconds of instrumented "
            "search plans (repro.exec)",
            labelnames=("topology", "stage"),
        )
    return _STAGE_HIST


def tracing_enabled() -> bool:
    return _enabled


def enable_tracing(*, clear: bool = True) -> None:
    """Start collecting span events (process-wide, all threads)."""
    global _enabled, _t0
    with _lock:
        if clear:
            _events.clear()
            _t0 = time.perf_counter()
        _enabled = True


def disable_tracing() -> None:
    global _enabled
    with _lock:
        _enabled = False


def clear_trace() -> None:
    with _lock:
        _events.clear()


def add_span(name: str, t_start: float, t_end: float, **args) -> None:
    """Record a completed span from perf_counter timestamps -- the
    retroactive form, used where the interval is only known after the fact
    (queue wait: submit happened on another thread)."""
    if not _enabled:
        return
    ev = {
        "name": name,
        "ph": "X",
        "ts": (t_start - _t0) * 1e6,
        "dur": max(t_end - t_start, 0.0) * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
    }
    if args:
        ev["args"] = dict(args)
    with _lock:
        _events.append(ev)


@contextmanager
def span(name: str, **args):
    """Trace one interval on the current thread.  Near-zero cost when
    tracing is off; nested spans become a tree in the Chrome trace viewer
    (same-tid containment)."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_span(name, t0, time.perf_counter(), **args)


def fence(out):
    """Wait for the device work behind `out` (a tensor or a tuple/list of
    them) and return `out`: `torch.cuda.synchronize` of the CUDA device its
    first CUDA tensor lies on, nothing for CPU tensors.  The port's
    `block_until_ready`, for the inside of a `stage`."""
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            break
    return out


@contextmanager
def stage(topology: str, name: str):
    """One instrumented exec stage: records wall seconds into the
    `repro_exec_stage_seconds` histogram always (instrumented plans exist to
    measure), and an `exec.<name>` trace span when tracing is on.  The
    caller must `fence` its stage output inside the `with` so the interval
    includes the device work."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        _stage_hist().observe(t1 - t0, topology=topology, stage=name)
        if _enabled:
            add_span(f"exec.{name}", t0, t1, topology=topology)


def events() -> list[dict]:
    with _lock:
        return list(_events)


def to_chrome_trace() -> dict:
    """The collected spans as a Chrome-trace ("Trace Event Format") object:
    `json.dump` it and load at ui.perfetto.dev / chrome://tracing."""
    with _lock:
        evs = list(_events)
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def export_chrome_trace(path) -> dict:
    doc = to_chrome_trace()
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


@contextmanager
def trace(path=None, *, clear: bool = True):
    """Collect spans for the body and (optionally) export them:

        with obs.trace("serve_trace.json"):
            router.submit(...); ...

    Leaves tracing in its previous state on exit."""
    was = _enabled
    enable_tracing(clear=clear)
    try:
        yield
    finally:
        if not was:
            disable_tracing()
        if path is not None:
            export_chrome_trace(path)


def device_profile(logdir):
    """A kernel timeline beside the host-side span tree: a
    `torch.profiler.profile` context (CPU activity, and CUDA when a card is
    present) that writes a TensorBoard / Chrome trace under `logdir` on
    exit.  For people to read: the profiler may drop a session's first
    kernels, so counts come from `kernels.common.launch_counts`, not from
    this timeline."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, on_trace_ready=tensorboard_trace_handler(str(logdir)))
