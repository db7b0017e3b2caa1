"""Time design variants of the flash-attention kernel (src/repro_torch/kernels/
csrc/flash_attn.cu) at the shapes chip_smoke.py measures, on an NVIDIA card:

    python3 tools/flash_variants.py

Each variant is the committed source with a few textual edits, compiled
alone by nvcc into its own library (all builds started together).  The
parent commit's flash_attn.cu (the first design: float32 FMAs from shared
memory, one block a (32-query tile, q head), no tensor cores) can be timed
beside them by placing it at .scratch/flash_attn_parent.cu: it is the float32
SIMT alternative to the committed 3xTF32 tensor-core products.  Shapes:
gemma-2b's serving batch (B 32, S 32, Hq 8, Hkv 1, dh 256, causal), the same
with the L2 cache flushed before each launch (every input read from device
memory) and with an SGEMM of gemma-2b's widths (1024 x 2048 by 2048 x 8192)
before each launch, which evicts the kernel's code and data as the model's
projections do, gemma2-9b's heads at B 4, S 2048 (Hq 16, Hkv 8, dh 256), causal and
with window 1024 + softcap 50, and gemma-2b's heads at B 1, S 4096; q, k, v
standard normal.  For each variant and shape: the kernel's device time
under torch.profiler (the mean of the flash_attn_kernel launches it recorded
of 20 calls, after 32 untimed calls in the same session), CUDA events around
one call (median of 20, host launch time included; none where the L2 is
flushed or an SGEMM runs first), and the largest difference from the plain version
(`flash_attention_ref`) with whether it lies within rtol = atol = 1e-4; and
the SM clock and power that nvidia-smi reads while the committed kernel runs
at the long causal shape.  Writes one JSON line to stdout.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attention_ref  # noqa: E402

CAUSAL = dict(causal=True, window=0, softcap=0.0)
# tag -> (B, S, Hq, Hkv, dh, keyword arguments)
SHAPES = {
    "serving B 32, S 32": (32, 32, 8, 1, 256, CAUSAL),
    "serving, L2 flushed before each launch": (32, 32, 8, 1, 256, CAUSAL),
    "serving, an SGEMM before each launch": (32, 32, 8, 1, 256, CAUSAL),
    "B 4, S 2048, causal": (4, 2048, 16, 8, 256, CAUSAL),
    "B 4, S 2048, window 1024, softcap 50": (4, 2048, 16, 8, 256,
                                             dict(causal=True, window=1024, softcap=50.0)),
    "B 1, S 4096, Hq 8, Hkv 1, causal": (1, 4096, 8, 1, 256, CAUSAL),
}
FLUSH_BYTES = 128 << 20  # written between launches: more than the H100's 50 MB L2
TOL = dict(rtol=1e-4, atol=1e-4)
PAD = 32  # untimed calls in each profiler session, before the marker and the timed ones
BUILD = ROOT / ".scratch" / "flash_variants"
# a parent source with the same `flash_attn_launch` signature (the lse pointer
# after o, passed null here)
PARENT = ROOT / ".scratch" / "flash_attn_parent.cu"
SMALL_BIG = "mma(s[n], as[st], bb[n][2 * st], bb[n][2 * st + 1]);"
BIG_SMALL = "mma(s[n], ab[st], bs[n][2 * st], bs[n][2 * st + 1]);"
P_SMALL = "mma(o[n0 + u], ps, wb[u][0], wb[u][1]);"
V_SMALL = "mma(o[n0 + u], pb, ws[u][0], ws[u][1]);"
SHORT = "constexpr int kShortSlabs = 2, kShortKS = 2, kShortBN = 16;"


def short(slabs: int, ks: int, bn: int) -> list:
    """The short-sequence blocks as `slabs` slabs of `ks` warps, `bn`-key tiles."""
    return [(SHORT, f"constexpr int kShortSlabs = {slabs}, kShortKS = {ks}, kShortBN = {bn};")]


# name -> [(text in flash_attn.cu, replacement)]
VARIANTS = {
    "short: 32-key tiles": short(2, 2, 32),
    "short: 4 slabs of 4 warps, 32-key tiles": short(4, 4, 32),
    "short: 4 slabs of 2 warps": short(4, 2, 16),
    "short: 4 slabs of 1 warp": short(4, 1, 16),
    "short: 2 slabs of 4 warps": short(2, 4, 16),
    "short tiles at every shape": [
        ("if ((long long)B * a.Hkv * ((a.rows + 127) / 128) >= sms)", "if (false)")],
    "short tiles with every loop unrolled": [
        ("constexpr int kUnrollD = KS > 1 ? 1 : DW / 16;", "constexpr int kUnrollD = DW / 16;"),
        ("constexpr int kUnrollK = KS > 1 ? 1 : kNS;", "constexpr int kUnrollK = kNS;")],
    "128-row tiles of one warp a slab at every shape": [
        ("if ((long long)B * a.Hkv * ((a.rows + 127) / 128) >= sms)", "if (true)")],
    "long: 16-key tiles": [("constexpr int kLongBN = 32;", "constexpr int kLongBN = 16;")],
    "accurate exp2f and division (no ex2.approx, rcp.approx)": [
        ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));', "r = exp2f(v);"),
        ('asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));', "r = 1.f / v;")],
    # diagnostics, wrong outputs: what the correction products and the split cost
    "one TF32 product, big x big (wrong output)": [
        (SMALL_BIG, "(void)0;"), (BIG_SMALL, "(void)0;"), (P_SMALL, "(void)0;"),
        (V_SMALL, "(void)0;")],
    "no split: the float32 bits as tf32 in all three products (wrong output)": [
        ("big = to_tf32(x);", "big = __float_as_uint(x);"),
        ("small = to_tf32(x - __uint_as_float(big));", "small = __float_as_uint(x);")],
}


def device_ms(fn, reps: int = 20) -> tuple:
    """(mean device time of a call, flash_attn_kernel launches the profiler
    recorded after the PAD untimed calls, of reps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1)  # the marker
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(kern) if "spin_kernel" in e.name]
    timed = [e.time_range.elapsed_us() for e in kern[marks[-1] + 1:] if marks
             and "flash_attn_kernel" in e.name]
    if not timed:
        return float("nan"), 0
    return sum(timed) / len(timed) / 1e3, len(timed)


def events_ms(fn, reps: int = 20) -> float:
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


def build_all(sources: dict) -> dict:
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src, so = BUILD / f"v{i}.cu", BUILD / f"v{i}.so"
        src.write_text(text)
        cmd = [common.find_nvcc(), *common.NVCC_FLAGS, "-shared", "-I", str(common.CSRC),
               str(src), "-o", str(so)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:  # reported, and the other variants still timed
            print(f"flash_variants: nvcc failed for {name}:\n{out}", file=sys.stderr)
            continue
        libs[name] = ctypes.CDLL(str(so))
    if "committed" not in libs:
        sys.exit("flash_variants: the committed source did not build")
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_variants: needs an NVIDIA card")
    # the shared helpers inlined, so that a variant may edit them too
    base = (common.CSRC / "flash_attn.cu").read_text().replace(
        '#include "tf32x3.cuh"', (common.CSRC / "tf32x3.cuh").read_text())
    sources = {"committed": base}
    for name, edits in VARIANTS.items():
        text = base
        for old, new in edits:
            if old not in text:
                sys.exit(f"flash_variants: {name}: {old!r} not in flash_attn.cu")
            text = text.replace(old, new)
        sources[name] = text
    if PARENT.exists():
        sources["parent (float32 SIMT, the first design)"] = PARENT.read_text()
    libs = build_all(sources)
    for lib in libs.values():
        lib.flash_attn_launch.argtypes = list(common.SIGNATURES["flash_attn_launch"])
        lib.flash_attn_launch.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())  # noqa: E731
    res = {"card": torch.cuda.get_device_name(0)}
    for tag, (B, S, Hq, Hkv, dh, kw) in SHAPES.items():
        q = torch.randn(B, S, Hq, dh, device=dev, generator=g)
        k = torch.randn(B, S, Hkv, dh, device=dev, generator=g)
        v = torch.randn(B, S, Hkv, dh, device=dev, generator=g)
        ref = flash_attention_ref(q, k, v, **kw)
        out = torch.empty_like(q)
        flush = torch.empty(FLUSH_BYTES // 4, device=dev) if "flushed" in tag else None
        gemm = ((torch.randn(1024, 2048, device=dev, generator=g),
                 torch.randn(2048, 8192, device=dev, generator=g)) if "SGEMM" in tag else None)

        def run(lib):
            if flush is not None:
                flush.zero_()
            if gemm is not None:  # as in the model: a projection's GEMM just ran
                torch.matmul(*gemm)
            err = lib.flash_attn_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        out.data_ptr(), None, B, S, S, Hq, Hkv, dh,
                                        int(kw["causal"]), kw["window"], kw["softcap"],
                                        stream())
            assert err == 0, err

        recs = {}
        for name, lib in libs.items():
            run(lib)
            torch.cuda.synchronize()
            dev_ms, seen = device_ms(lambda: run(lib))
            recs[name] = dict(device_ms=dev_ms, launches_seen=seen,
                              events_ms=None if flush is not None or gemm is not None
                              else events_ms(lambda: run(lib)),
                              max_abs_err=float((out - ref).abs().max()),
                              within_tol=bool(torch.allclose(out, ref, **TOL)))
        if tag == "B 4, S 2048, causal":  # the SM clock while the committed kernel runs
            for _ in range(300):
                run(libs["committed"])
            res["clocks.sm, power.draw under load"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip()
            torch.cuda.synchronize()
        res[tag] = recs
        del q, k, v, ref, out, flush, gemm
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
