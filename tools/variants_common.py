"""Build and timing helpers of the kernel variant tools (tools/*_variants.py):
each variant is a CUDA source compiled alone by nvcc into its own library
(all builds started together, under .scratch/), and a call is timed by its
kernels' device time under torch.profiler and by CUDA events around it.
Needs an NVIDIA card and nvcc; imports nothing at module level beyond
torch."""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import common  # noqa: E402

# tiny kernels launched first in each profiler session: torch.profiler may
# drop a session's first kernels (tools/profiler_clock.py)
LEAD_KERNELS = 512


def apply_edits(base: str, edits, name: str, tool: str, source: str) -> str:
    """`base` with each (old, new) text edit of a variant made once; exits
    when an old text is missing."""
    text = base
    for old, new in edits:
        if old not in text:
            sys.exit(f"{tool}: {name}: {old!r} not in {source}")
        text = text.replace(old, new)
    return text


def build_all(sources: dict, build_dir: Path, tool: str, verbose=()) -> dict:
    """name -> loaded library of each source (nvcc, one process a source, all
    started together; -Xptxas -v printed for the names in `verbose`).  A
    variant that does not
    build is reported and left out; the run stops when "committed" does not
    build."""
    build_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src, so = build_dir / f"v{i}.cu", build_dir / f"v{i}.so"
        src.write_text(text)
        extra = ("-Xptxas", "-v") if name in verbose else ()
        cmd = [common.find_nvcc(), *common.NVCC_FLAGS, *extra, "-shared", "-I",
               str(common.CSRC), str(src), "-o", str(so)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{tool}: nvcc failed for {name}:\n{out}", file=sys.stderr)
            continue
        if name in verbose and out:
            print(f"{tool}: {name}:\n{out}", file=sys.stderr)
        lib = ctypes.CDLL(str(so))
        for fn, args in common.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(args)
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    if "committed" not in libs:
        sys.exit(f"{tool}: the committed source did not build")
    return libs


def stream() -> int:
    """PyTorch's current raw CUDA stream, for a C entry point's last argument."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def device_ms(fn, match: str, launches: int, reps: int = 20) -> tuple:
    """(mean device time of a call of fn() that makes `launches` launches of
    kernels named `match`, the launches the profiler recorded of reps x
    launches): the mean over the recorded launches times `launches`, after
    LEAD_KERNELS tiny kernels (their sum over reps where it recorded every
    launch); nan where three sessions recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    lead = torch.zeros(1, device="cuda")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_KERNELS):
                lead.add_(1.0)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and match in e.name]
        if len(kern) == reps * launches:
            return sum(kern) / reps / 1e3, len(kern)
        if kern:
            return sum(kern) / len(kern) / 1e3 * launches, len(kern)
    return float("nan"), 0


def events_ms(fn, reps: int = 50) -> float:
    """Median of `reps` CUDA-event times of one call of fn() (host launch
    time included), after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
