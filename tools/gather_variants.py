"""Time design variants of the verify kernels (src/repro_torch/kernels/csrc/
gather.cu) at one verify batch of the main path, on an NVIDIA card:

    python3 tools/gather_variants.py

Each variant is the committed source with a few textual edits, compiled
alone by nvcc into its own library (all builds started together); the
parent's gather.cu (scan entries only) can be timed beside them by placing
it at .scratch/gather_parent.cu.  Inputs: 10^6 x 128 fp32 rows (and their
int8 codes), 1,000 queries x 100 candidates drawn at random, the last 5 of
each row -1.  For each variant: the scans (gather_l2_launch,
gather_q_launch) and the fused entries at the main path's shapes
(gather_l2_topk_launch, exact mode, k 10; gather_q_topk_launch, survivors,
R 40), each by its kernels' device time under torch.profiler (mean of 30)
and by CUDA events around one launch (median of 50, host launch time
included); whether the fused outputs equal the committed build's scan +
the plain epilogue bit for bit (variants that change the lanes a candidate
sum in another order, and may not); and the same timings of the committed
build with every candidate the same row (no device-memory traffic).
Writes one JSON line to stdout.
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

from repro_torch.exec import stages  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.store.stores import Fp32Store, Int8Store, _quantize_rows  # noqa: E402

N, D, B, L, K, R = 1_000_000, 128, 1000, 100, 10, 40
BUILD = ROOT / ".scratch" / "variants"
PARENT = ROOT / ".scratch" / "gather_parent.cu"
# the scan loop of gather.cu, one candidate a group at a time, and the same
# with two in flight (every row load of both issued before any arithmetic)
ONE_LOOP = """  for (int base = 0; base < n; base += NG) {  // the same count on every lane
    int slot = base + group;
    int id = slot < n ? ids_s[slot] : -1;
    bool live = slot < n && (id >= 0 || !skip_negative);
    if (id < 0) id = 0;  // negative ids read row 0
    float s = live ? rows.scale(id) : 0.f;
    Acc acc;
    for (int c0 = 0; c0 < C; c0 += G * kChunks) {
      typename Rows::Chunk r[kChunks];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        int c = c0 + j * G + lane;
        if (live && c < C) r[j] = rows.load(id, a.d, c);
      }
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        int c = c0 + j * G + lane;
        if (live && c < C) rows.add(acc, r[j], s, qs, c);
      }
    }
    float v = acc.finish(G, qq);  // every lane joins the shuffles
    if (lane == 0 && slot < n) put(slot, live, v);
  }"""
TWO_LOOP = """  constexpr int kU = 2;
  for (int base = 0; base < n; base += NG * kU) {
    int slot[kU], id[kU];
    bool live[kU];
    float s[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      slot[u] = base + u * NG + group;
      id[u] = slot[u] < n ? ids_s[slot[u]] : -1;
      live[u] = slot[u] < n && (id[u] >= 0 || !skip_negative);
      if (id[u] < 0) id[u] = 0;
      s[u] = live[u] ? rows.scale(id[u]) : 0.f;
    }
    Acc acc[kU];
    for (int c0 = 0; c0 < C; c0 += G * kChunks) {
      typename Rows::Chunk r[kU][kChunks];
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          int c = c0 + j * G + lane;
          if (live[u] && c < C) r[u][j] = rows.load(id[u], a.d, c);
        }
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          int c = c0 + j * G + lane;
          if (live[u] && c < C) rows.add(acc[u], r[u][j], s[u], qs, c);
        }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float v = acc[u].finish(G, qq);
      if (lane == 0 && slot[u] < n) put(slot[u], live[u], v);
    }
  }"""
# name -> [(text in gather.cu, replacement)]
VARIANTS = {
    "64 threads a block": [("kThreads = 128;", "kThreads = 64;")],
    "256 threads a block": [("kThreads = 128;", "kThreads = 256;")],
    "2 chunks a lane (16 lanes a fp32 row, 4 an int8 row)": [("kChunks = 4;", "kChunks = 2;")],
    "1 chunk a lane (32 lanes, 8 lanes)": [("kChunks = 4;", "kChunks = 1;")],
    "8 chunks a lane (4 lanes, 1 lane)": [("kChunks = 4;", "kChunks = 8;")],
    "bitonic sort, no rank count": [("kRankMax = 1024;", "kRankMax = 0;")],
    "at least 8 blocks an SM (__launch_bounds__)": [
        ("__launch_bounds__(kThreads)\ngather_topk_kernel",
         "__launch_bounds__(kThreads, 8)\ngather_topk_kernel"),
        ("__launch_bounds__(kThreads)\ngather_scan_kernel",
         "__launch_bounds__(kThreads, 8)\ngather_scan_kernel")],
    "evict-first row loads (__ldcs)": [
        ("return __ldg(reinterpret_cast<const float4*>(data",
         "return __ldcs(reinterpret_cast<const float4*>(data"),
        ("return __ldg(reinterpret_cast<const int4*>(codes",
         "return __ldcs(reinterpret_cast<const int4*>(codes")],
    "two candidates a group in flight": [(ONE_LOOP, TWO_LOOP)],
}


def device_ms(fn, reps: int = 30) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kern) / 1e3 / reps


def events_ms(fn, reps: int = 50) -> float:
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
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn, args in common.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(args)
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("gather_variants: needs an NVIDIA card")
    base = (common.CSRC / "gather.cu").read_text()
    sources = {"committed": base}
    for name, edits in VARIANTS.items():
        text = base
        for old, new in edits:
            if old not in text:
                sys.exit(f"gather_variants: {name}: {old!r} not in gather.cu")
            text = text.replace(old, new)
        sources[name] = text
    if PARENT.exists():
        sources["parent (scan entries)"] = PARENT.read_text()
    libs = build_all(sources)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn(N, D, device=dev, generator=g)
    ids = torch.randint(0, N, (B, L), device=dev, dtype=torch.int32, generator=g)
    ids[:, L - 5:] = -1
    Q = torch.randn(B, D, device=dev, generator=g)
    codes, scale = _quantize_rows(X)
    stream = lambda: torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())

    def scan(lib, int8):
        out = torch.empty((B, L), device=dev)
        if int8:
            err = lib.gather_q_launch(codes.data_ptr(), scale.data_ptr(), ids.data_ptr(),
                                      Q.data_ptr(), out.data_ptr(), N, D, B, L, 0, stream())
        else:
            err = lib.gather_l2_launch(X.data_ptr(), ids.data_ptr(), Q.data_ptr(),
                                       out.data_ptr(), N, D, B, L, 0, stream())
        assert err == 0, err
        return out

    def fused(lib, int8):
        k = R if int8 else K
        oi = torch.empty((B, k), device=dev, dtype=torch.int32)
        ov = torch.empty((B, k), device=dev)
        rows = (codes.data_ptr(), scale.data_ptr()) if int8 else (X.data_ptr(),)
        fn = lib.gather_q_topk_launch if int8 else lib.gather_l2_topk_launch
        err = fn(*rows, ids.data_ptr(), ids.data_ptr(), Q.data_ptr(), oi.data_ptr(),
                 ov.data_ptr(), None, N, D, B, L, k, 8192, 0, int(not int8), stream())
        assert err == 0, err
        return oi, ov

    d32 = Fp32Store(rows=X).gather_dist(ids, Q, metric="euclidean", use_kernel=True)
    d8 = Int8Store(q=codes, scale=scale).gather_dist(ids, Q, metric="euclidean",
                                                      use_kernel=True)
    want32 = stages.topk_ids(d32, ids, K)
    v8, i8 = stages._smallest(d8, R)
    want8 = (torch.gather(ids, 1, i8), v8)

    def timings(lib, with_fused=True):
        rec = {f"{what} {kind} device_ms": device_ms(lambda: fn(lib, kind == "int8"))
               for what, fn in (("scan", scan), ("fused", fused))[:2 if with_fused else 1]
               for kind in ("fp32", "int8")}
        rec.update({f"{what} {kind} events_ms": events_ms(lambda: fn(lib, kind == "int8"))
                    for what, fn in (("scan", scan), ("fused", fused))[:2 if with_fused else 1]
                    for kind in ("fp32", "int8")})
        return rec

    res = {"card": torch.cuda.get_device_name(0),
           "unique_rows": int(torch.unique(ids[ids >= 0]).numel())}
    for name, lib in libs.items():
        parent = name.startswith("parent")
        rec = timings(lib, with_fused=not parent)
        if not parent:
            a, b = fused(lib, False), fused(lib, True)
            rec["fused equal to the committed scan + epilogue"] = bool(
                torch.equal(a[0], want32[0]) and torch.equal(a[1], want32[1])
                and torch.equal(b[0], want8[0]) and torch.equal(b[1], want8[1]))
        res[name] = rec
    ids.fill_(7)  # every candidate the same row: the kernels without memory traffic
    res["committed, one row for every candidate"] = timings(libs["committed"])
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
