"""Time design variants of the selective scan's backward (src/repro_torch/
kernels/csrc/ssm_scan_bwd.cu) at chip_smoke.py's three backward shapes, on an
NVIDIA card:

    python3 tools/scan_bwd_variants.py [name fragment ...]

(with fragments, only the variants whose names hold one, and the committed
source, are built and timed)

Each variant is the committed source with a few textual edits to its knobs
(steps a sub-tile, stages in the cp.async ring, steps of outputs staged
before a flush, registers a thread), compiled alone by nvcc into its own
library (all builds started together, -Xptxas -v printed for each).  The
parent commit's ssm_scan_bwd.cu (the tile's states in shared memory, loads
not overlapped, 8 warps an SM) can be timed beside them by placing it at
.scratch/ssm_scan_bwd_parent.cu.  The checkpoints come from the committed
forward (ssm_scan.cu, built beside them).  Shapes (D 8192, N 16):
falcon-mamba-7b's training shape (B 8, L 64), B 4, L 2048 and B 1, L 4096;
dt = softplus(z), A = -exp(0.5 z), x, B, C, h0 and dy standard normal, no
gradient of the final state (as training calls it).  For each variant and
shape: the device time of a call (its two kernels) under torch.profiler
(mean of 20 calls), and of its walk kernel alone (the rest the reduce),
CUDA events around one call (median of 20, host launch time included), the
largest error of each gradient against the plain
version (`ssm_scan_bwd_ref`) as a share of that gradient's largest entry,
with whether all lie within 5e-5 (chip_smoke.py's SCAN_BWD_REL_TOL), whether
its outputs equal the committed kernel's bit for bit, and the walk kernel's
registers, local memory (spills), shared memory and resident blocks and
warps an SM (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor).
Writes one JSON line to stdout, with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from variants_common import ROOT, apply_edits, build_all, device_ms, events_ms, stream

from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_bwd_ref  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import TILE, bwd_blocks  # noqa: E402

TOOL = "scan_bwd_variants"
BUILD = ROOT / ".scratch" / "scan_bwd_variants"
PARENT = ROOT / ".scratch" / "ssm_scan_bwd_parent.cu"
REL_TOL = 5e-5
D, N = 8192, 16
SHAPES = {"training, B 8, L 64": (8, 64), "B 4, L 2048": (4, 2048), "B 1, L 4096": (1, 4096)}
GRADS = ("ddt", "dx", "dB", "dC", "dA", "dh0")
# appended to every source: the walk kernel's resources at a state size N,
# out[] = registers, local bytes, shared bytes a block, blocks an SM, warps
# an SM (both the committed design and the parent name it
# ssm_scan_bwd_kernel<G> and its shared floats Smem<G>::kFloats)
INFO = r"""
template <int G>
static int ssm_scan_bwd_info_g(int* out) {
  const size_t smem = Smem<G>::kFloats * sizeof(float);
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncSetAttribute(ssm_scan_bwd_kernel<G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&at, ssm_scan_bwd_kernel<G>);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ssm_scan_bwd_kernel<G>,
                                                      32 * G, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs, out[1] = (int)at.localSizeBytes, out[2] = (int)(smem + at.sharedSizeBytes);
  out[3] = blocks, out[4] = blocks * G;
  return 0;
}

extern "C" int ssm_scan_bwd_info(int N, int* out) {
  return N <= 4 ? ssm_scan_bwd_info_g<1>(out) : N <= 8 ? ssm_scan_bwd_info_g<2>(out)
                                               : ssm_scan_bwd_info_g<4>(out);
}
"""
INFO_KEYS = ("registers", "local_bytes", "shared_bytes_a_block", "blocks_an_sm", "warps_an_sm")


def knob(name: str, value: str) -> tuple:
    """The edit of one of the committed source's knob constants."""
    defaults = {"kSub": "8", "kStages": "2", "kFlush": "kSub", "kRegs": "128"}
    return (f"constexpr int {name} = {defaults[name]};", f"constexpr int {name} = {value};")


# name -> [(text in ssm_scan_bwd.cu, replacement)]
VARIANTS = {
    "4-step sub-tiles (1.875 exps a state and step)": [knob("kSub", "4")],
    "3 stages": [knob("kStages", "3")],
    "1 stage (no tile in flight while one is walked)": [knob("kStages", "1")],
    "sums flushed two sub-tiles at a time": [knob("kFlush", "2 * kSub")],
    "sums flushed a tile at a time": [knob("kFlush", "kSteps")],
    "168 registers (3 blocks an SM at N 16)": [knob("kRegs", "168")],
    "copy and flush loops unrolled as the compiler chooses": [
        ("#pragma unroll 1\n  for (int e", "  for (int e"),
        ("#pragma unroll 1\n      for (int e", "      for (int e")],
    # the same adds in the same order, over more SMs at the training shape
    "reduce in blocks of 64 threads": [
        ("constexpr int kReduceThreads = 256;", "constexpr int kReduceThreads = 64;")],
}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit(f"{TOOL}: needs an NVIDIA card")
    base = (common.CSRC / "ssm_scan_bwd.cu").read_text()
    keep = sys.argv[1:]  # name fragments: time only the variants that hold one
    sources = {"committed": base + INFO}
    for name, edits in VARIANTS.items():
        if not keep or any(k in name for k in keep):
            sources[name] = apply_edits(base, edits, name, TOOL, "ssm_scan_bwd.cu") + INFO
    if PARENT.exists() and (not keep or any(k in "parent" for k in keep)):
        sources["parent (a tile's states staged in shared memory)"] = PARENT.read_text() + INFO
    sources["forward"] = (common.CSRC / "ssm_scan.cu").read_text()
    libs = build_all(sources, BUILD, TOOL, verbose=tuple(n for n in sources if n != "forward"))
    fwd = libs.pop("forward", None)
    if fwd is None:
        sys.exit(f"{TOOL}: the forward did not build")
    for lib in libs.values():
        lib.ssm_scan_bwd_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.ssm_scan_bwd_info.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    res = {"card": torch.cuda.get_device_name(0), "nvidia-smi name, power.limit": card}
    for tag, (B, L) in SHAPES.items():
        def randn(*shape, s=1.0):
            return s * torch.randn(shape, generator=g, device=dev)

        ins = [torch.nn.functional.softplus(randn(B, L, D)), randn(B, L, D), randn(B, L, N),
               randn(B, L, N), -torch.exp(randn(D, N, s=0.5)), randn(B, D, N)]
        dy = randn(B, L, D)
        y, h = torch.empty_like(ins[0]), torch.empty_like(ins[5])
        ckpt = torch.empty((B, -(-L // TILE), D, N), device=dev)
        assert fwd.ssm_scan_launch(*(t.data_ptr() for t in ins), y.data_ptr(), h.data_ptr(),
                                   ckpt.data_ptr(), B, L, D, N, stream()) == 0
        want = ssm_scan_bwd_ref(*ins, dy)
        outs = [torch.empty_like(t) for t in ins]  # ddt, dx, dB, dC, dA, dh0
        scratch = torch.empty(2 * B * bwd_blocks(D) * L * N + B * D * N, device=dev)
        recs, ref_bits = {}, None
        for name, lib in libs.items():
            def run(lib=lib):
                err = lib.ssm_scan_bwd_launch(
                    *(t.data_ptr() for t in ins[:5]), ckpt.data_ptr(), dy.data_ptr(), None,
                    *(t.data_ptr() for t in outs), scratch.data_ptr(), B, L, D, N, stream())
                assert err == 0, (name, err)

            for t in outs:
                t.fill_(float("nan"))
            run()
            torch.cuda.synchronize()
            rel = {k: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for k, a, b in zip(GRADS, outs, want)}
            bits = [t.clone() for t in outs]
            if name == "committed":
                ref_bits = bits
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(bits, ref_bits))
            info = (ctypes.c_int * len(INFO_KEYS))()
            ok = lib.ssm_scan_bwd_info(N, ctypes.addressof(info)) == 0
            ms, seen = device_ms(run, "ssm_scan_bwd", 2)
            walk_ms, _ = device_ms(run, "ssm_scan_bwd_kernel", 1)
            recs[name] = dict(device_ms=ms, walk_ms=walk_ms, reduce_ms=ms - walk_ms,
                              launches_seen=seen, events_ms=events_ms(run, 20),
                              rel_err=rel, within_tol=max(rel.values()) <= REL_TOL,
                              bits_of_committed=same,
                              walk_kernel=dict(zip(INFO_KEYS, info)) if ok else None)
            del bits
        res[tag] = recs
        del ins, dy, y, h, ckpt, want, outs, scratch, ref_bits
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
