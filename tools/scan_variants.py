"""Time design variants of the selective-scan kernel (src/repro_torch/kernels/
csrc/ssm_scan.cu) at four shapes of N 16 and D 8192, on an NVIDIA card:

    python3 tools/scan_variants.py

Each variant is the committed source (with the step it shares with the
backward, ssm_scan.cuh, inlined) with a few textual edits, compiled alone by
nvcc into its own library (all builds started together); each launch writes
no checkpoint, as serving's.  The
parent commit's ssm_scan.cu (the earlier design: a thread a channel,
launched once a 2,048-step chunk with t0, t1) can be timed beside them by
placing it at .scratch/ssm_scan_parent.cu.  Shapes: falcon-mamba-7b's
serving batch (B 32, L 32), the same with the L2 cache flushed before each
launch (every input read from device memory), a long batch (B 4, L 2048)
and one long sequence (B 1, L 4096); dt = softplus(z), A = -exp(0.5 z), x,
B, C standard normal, h0 zero.  For each variant and shape: the kernel's
device time under torch.profiler (the mean of the scan launches it
recorded of 20 calls), CUDA events around one call (median of 20, host
launch time included; none where the L2 is flushed), and the largest
difference from the plain version (`ssm_scan_batched_ref`) with whether it
lies within rtol = atol = 1e-5; and the SM clock and power that nvidia-smi
reads while the committed kernel runs at the long batch.  Writes one JSON
line to stdout.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from variants_common import ROOT, apply_edits, build_all, device_ms, events_ms, stream

from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_batched_ref  # noqa: E402

SHAPES = {"serving B 32, L 32": (32, 32), "serving, L2 flushed before each launch": (32, 32),
          "B 4, L 2048": (4, 2048), "B 1, L 4096": (1, 4096)}
FLUSH_BYTES = 128 << 20  # written between launches: more than the H100's 50 MB L2
D, N = 8192, 16
TOL = dict(rtol=1e-5, atol=1e-5)
TOOL = "scan_variants"
BUILD = ROOT / ".scratch" / "scan_variants"
PARENT = ROOT / ".scratch" / "ssm_scan_parent.cu"
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));'
# name -> [(text in ssm_scan.cu, replacement)]
VARIANTS = {
    "accurate expf(dt A)": [("kLog2e = 1.4426950408889634f;", "kLog2e = 1.0f;"),
                            (EX2, "r = expf(v);")],
    "library exp2f (no flush to zero)": [(EX2, "r = exp2f(v);")],
    "4-byte tile copies": [("if (a.vec_dx)", "if (false)"), ("if (a.vec_bc)", "if (false)")],
    "short sequences as long ones": [("if (a.L <= 2 * kSteps)", "if (false)")],
    "one channel a thread, four stages, for every long sequence": [
        ("if (pairs > 2LL * sms)", "if (false)")],
    "two channels a thread, two stages, for every long sequence": [
        ("if (pairs > 2LL * sms)", "if (true)")],
    "one channel a thread, 64 registers, for long sequences in large batches": [
        ("launch<G, 2, 2, 96>(a", "launch<G, 1, 2, 64>(a")],
    "two channels a thread, 128 registers": [("launch<G, 2, 2, 96>(a", "launch<G, 2, 2, 128>(a")],
    "one stage (no tile in flight while one is scanned)": [
        ("launch<G, 1, 2, 64>(a", "launch<G, 1, 1, 64>(a"),
        ("launch<G, 2, 2, 96>(a", "launch<G, 2, 1, 96>(a"),
        ("launch<G, 1, 4, 128>(a", "launch<G, 1, 1, 128>(a")],
    "16-step tiles": [("kSteps = 32;", "kSteps = 16;")],
    "64 channel groups a block": [("kGroups = 32;", "kGroups = 64;")],
    "16 channel groups a block": [("kGroups = 32;", "kGroups = 16;")],
    "the tile loop unrolled 2 groups of steps at a time": [
        ("#pragma unroll\n  for (int j = 0; j < kSteps; j += G)",
         "#pragma unroll 2\n  for (int j = 0; j < kSteps; j += G)")],
    # diagnostics, wrong outputs: what the SFU, the loads and the stores cost
    "no exp (a = dt A; wrong output)": [(EX2, "r = v;")],
    "no tile loads (stale shared memory; wrong output)": [
        ("if (t < tiles) issue(t);", "if (t < 0) issue(t);"),
        ("if (t + kStages - 1 < tiles) issue", "if (t + kStages - 1 < 0) issue")],
    "no y stores (wrong output)": [
        ("if (kFull || j + g < steps) {", "if (yv[0] == 1234.5f) {")],
    "no exp, no B, C shared loads (wrong output)": [
        (EX2, "r = v;"),
        ("const float4 bv = hash_tile::lds4(bs + s * kMaxN + kS * g);",
         "const float4 bv = make_float4(0.5f, 0.25f, 0.125f, 0.0625f);"),
        ("const float4 cv = hash_tile::lds4(cs + s * kMaxN + kS * g);",
         "const float4 cv = make_float4(0.5f, 0.25f, 0.125f, 0.0625f);")],
    "no B, C shared loads (constants; wrong output)": [
        ("const float4 bv = hash_tile::lds4(bs + s * kMaxN + kS * g);",
         "const float4 bv = make_float4(0.5f, 0.25f, 0.125f, 0.0625f);"),
        ("const float4 cv = hash_tile::lds4(cs + s * kMaxN + kS * g);",
         "const float4 cv = make_float4(0.5f, 0.25f, 0.125f, 0.0625f);")],
}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit(f"{TOOL}: needs an NVIDIA card")
    step = (common.CSRC / "ssm_scan.cuh").read_text().replace("#pragma once\n", "")
    base = (common.CSRC / "ssm_scan.cu").read_text().replace('#include "ssm_scan.cuh"\n', step)
    sources = {"committed": base}
    for name, edits in VARIANTS.items():
        sources[name] = apply_edits(base, edits, name, TOOL, "ssm_scan.cu")
    if PARENT.exists():
        sources["parent"] = PARENT.read_text()
    libs = build_all(sources, BUILD, TOOL)
    if "parent" in libs:  # its entry point took the chunk's t0, t1 and no checkpoints
        P, I = ctypes.c_void_p, ctypes.c_int
        libs["parent"].ssm_scan_launch.argtypes = [P] * 8 + [I] * 6 + [P]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    res = {"card": torch.cuda.get_device_name(0)}
    for tag, (B, L) in SHAPES.items():
        dt = torch.nn.functional.softplus(torch.randn(B, L, D, device=dev, generator=g))
        x = torch.randn(B, L, D, device=dev, generator=g)
        Bc = torch.randn(B, L, N, device=dev, generator=g)
        Cc = torch.randn(B, L, N, device=dev, generator=g)
        A = -torch.exp(0.5 * torch.randn(D, N, device=dev, generator=g))
        h0 = torch.zeros(B, D, N, device=dev)
        y_ref, h_ref = ssm_scan_batched_ref(dt, x, Bc, Cc, A, h0)
        y = torch.empty_like(x)
        hs = [torch.empty_like(h0), torch.empty_like(h0)]
        ptrs = [t.data_ptr() for t in (dt, x, Bc, Cc, A)]
        flush = torch.empty(FLUSH_BYTES // 4, device=dev) if "flushed" in tag else None

        def run(name, lib):
            if flush is not None:
                flush.zero_()
            if name != "parent":
                err = lib.ssm_scan_launch(*ptrs, h0.data_ptr(), y.data_ptr(), hs[0].data_ptr(),
                                          None, B, L, D, N, stream())
                assert err == 0, (name, err)
                return hs[0]
            h = h0
            for i, lo in enumerate(range(0, L, 2048)):  # its wrapper's chunks
                err = lib.ssm_scan_launch(*ptrs, h.data_ptr(), y.data_ptr(),
                                          hs[i % 2].data_ptr(), B, L, D, N, lo,
                                          min(L, lo + 2048), stream())
                assert err == 0, (name, err)
                h = hs[i % 2]
            return h

        recs = {}
        for name, lib in libs.items():
            h = run(name, lib)
            torch.cuda.synchronize()
            err = max(float((y - y_ref).abs().max()), float((h - h_ref).abs().max()))
            ok = bool(torch.allclose(y, y_ref, **TOL) and torch.allclose(h, h_ref, **TOL))
            launches = -(-L // 2048) if name == "parent" else 1
            dev_ms, seen = device_ms(lambda: run(name, lib), "ssm_scan", launches)
            recs[name] = dict(device_ms=dev_ms, launches_seen=seen,
                              events_ms=None if flush is not None  # the flush counts there
                              else events_ms(lambda: run(name, lib), 20),
                              max_abs_err=err, within_tol=ok)
        if tag == "B 4, L 2048":  # the SM clock while the committed kernel runs
            for _ in range(3000):
                run("committed", libs["committed"])
            res["clocks.sm, power.draw under load"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip()
            torch.cuda.synchronize()
        res[tag] = recs
        del dt, x, Bc, Cc, A, h0, y, hs, y_ref, h_ref, flush
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
