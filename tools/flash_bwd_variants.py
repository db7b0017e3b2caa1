"""Time design variants of the flash-attention backward (src/repro_torch/
kernels/csrc/flash_attn_bwd.cu) at chip_smoke.py's five backward shapes, on
an NVIDIA card:

    python3 tools/flash_bwd_variants.py [name fragment ...]

(with fragments, only the variants whose names hold one, and the committed
source, are built and timed)

Each variant is the committed source with a few textual edits to its knobs
(the dK / dV pass's slabs of 16 keys a block, warps a slab, parts of dh
its score products are split into and rows a tile; the dQ pass's slabs of
16 rows, warps a slab, parts of dh and keys a tile; the operand split;
the row chunks), compiled alone by nvcc into its own library (all builds
started together, -Xptxas -v printed for the committed one).  The parent
commit's flash_attn_bwd.cu (float32 FMAs from shared memory, a delta
pre-pass, no row chunks) can be timed beside them by placing it at
.scratch/flash_attn_bwd_parent.cu.  Shapes: gemma-2b's training attention
(B 8, S 64, Hq 8, Hkv 1, dh 256, causal), B 4, S 2048, Hq 16, Hkv 8, dh 256
causal and with window 1024 + softcap 50, whisper-tiny's cross attention
(B 4, Sq 640 over 1,500, 6 heads of 64, not causal) and rows with no key
(B 2, Sq 150 > Skv 70, Hq 4, Hkv 2, dh 64, causal); q, k, v, dO standard
normal, o and lse from the forward kernel.  For each variant and shape:
the device time of a call under torch.profiler (mean of 10 calls) in all
and by kernel, CUDA events around one call (median of 20, host launch time
included), the row chunks, and the largest error of dq, dk, dv against the
plain version (`flash_attention_bwd_ref`) as a share of that gradient's
largest entry, with whether it lies within 2e-4 (chip_smoke.py's
FLASH_BWD_REL_TOL).  Writes one JSON line to stdout, with the card's name
and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from variants_common import LEAD_KERNELS, ROOT, apply_edits, build_all, events_ms, stream

from repro_torch.kernels.flash_attn import (flash_attention_bwd_ref,  # noqa: E402
                                            flash_attention_ref)
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402

TOOL = "flash_bwd_variants"
BUILD = ROOT / ".scratch" / "flash_bwd_variants"
PARENT = ROOT / ".scratch" / "flash_attn_bwd_parent.cu"
REL_TOL = 2e-4
CAUSAL = dict(causal=True, window=0, softcap=0.0)
# tag -> (B, Sq, Skv, Hq, Hkv, dh, keyword arguments), as chip_smoke.py's
SHAPES = {
    "gemma-2b training, B 8, S 64, Hq 8 / Hkv 1, dh 256, causal": (8, 64, 64, 8, 1, 256, CAUSAL),
    "B 4, S 2048, Hq 16 / Hkv 8, dh 256, causal": (4, 2048, 2048, 16, 8, 256, CAUSAL),
    "gemma2-9b, B 4, S 2048, window 1024, softcap 50": (
        4, 2048, 2048, 16, 8, 256, dict(causal=True, window=1024, softcap=50.0)),
    "whisper-tiny cross, B 4, Sq 640 over 1,500, 6 heads of 64": (
        4, 640, 1500, 6, 6, 64, dict(causal=False, window=0, softcap=0.0)),
    "rows with no key, B 2, Sq 150 > Skv 70, Hq 4 / Hkv 2, dh 64": (2, 150, 70, 4, 2, 64, CAUSAL),
}
KV = "constexpr int kKvSlabs = 2, kKvKS = 4, kKvKD = 2, kKvBR = 32;"
Q = "constexpr int kQSlabs = 2, kQKS = 4, kQKD = 2, kQBK = 32;"
CH = "constexpr int kKvBlocksPerSM = 1;"
SPLIT = ("  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
         "  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;\n}")
RNA = "(__float_as_uint({}) + 0x1000u) & 0xffffe000u"  # cvt.rna.tf32.f32's bits
TRUNC = "__float_as_uint({}) & 0xffffe000u"


def split_as(big: str, small: str) -> str:
    """bsplit's body: big = big(x), small = small(x - big)."""
    return (f"  big = {big.format('x')};\n"
            f"  small = {small.format('x - __uint_as_float(big)')};\n}}")


def kv(slabs: int, ks: int, kd: int, br: int) -> tuple:
    return (KV, f"constexpr int kKvSlabs = {slabs}, kKvKS = {ks}, kKvKD = {kd}, kKvBR = {br};")


def dq(slabs: int, ks: int, kd: int, bk: int) -> tuple:
    return (Q, f"constexpr int kQSlabs = {slabs}, kQKS = {ks}, kQKD = {kd}, kQBK = {bk};")


# name -> [(text in flash_attn_bwd.cu, replacement)]
VARIANTS = {
    "score products not split over dh (each warp all of dh, 8 rows or keys)": [
        kv(2, 4, 1, 32), dq(2, 4, 1, 32)],
    "dK / dV: 2 warps a slab, not split over dh": [kv(2, 2, 1, 32)],
    "dK / dV: 1 slab of 4 warps (16-key blocks)": [kv(1, 4, 2, 32)],
    "dK / dV: 4 slabs of 2 warps, 16-row tiles": [kv(4, 2, 2, 16)],
    "dQ: 2 warps a slab, not split over dh": [dq(2, 2, 1, 32)],
    "dQ: 1 slab of 4 warps (16-row blocks)": [dq(1, 4, 2, 32)],
    "dQ: 4 slabs of 2 warps, 16-key tiles": [dq(4, 2, 2, 16)],
    # the operand split: the committed one rounds big as cvt.rna.tf32.f32
    # does, in integer operations, and truncates small
    "split by cvt.rna.tf32.f32, big and small (the forward's)": [
        (SPLIT, "  split(x, big, small);\n}")],
    "split by integer rounding, big and small (cvt.rna's bits)": [
        (SPLIT, split_as(RNA, RNA))],
    "split: both truncated": [(SPLIT, split_as(TRUNC, TRUNC))],
    "no row chunks (C = 1)": [("if (blocks == 0 || blocks >= slots) return 1;", "return 1;")],
    "row chunks for 2 dK / dV blocks an SM": [(CH, "constexpr int kKvBlocksPerSM = 2;")],
}
# kernel-name fragments a call's device time is cut into
KERNELS = ("dq_kernel", "dkdv_kernel", "reduce_kernel", "prep_kernel")


def device_ms(fn, reps: int = 10) -> dict:
    """Mean device time of a call of fn(), in all and by kernel (KERNELS),
    after LEAD_KERNELS tiny kernels in the same profiler session; the
    launches recorded beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    lead = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_KERNELS):
            lead.add_(1.0)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "flash_attn_bwd" in e.name:
            frag = next((f for f in KERNELS if f in e.name), "other")
            ms, n = by.get(frag, (0.0, 0))
            by[frag] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return dict(device_ms=sum(ms for ms, _ in by.values()) / reps,
                by_kernel_ms={f: ms / reps for f, (ms, _) in by.items()},
                launches_seen={f: n for f, (_, n) in by.items()})


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit(f"{TOOL}: needs an NVIDIA card")
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    base = (csrc / "flash_attn_bwd.cu").read_text()
    sources = {"committed": base}
    keep = sys.argv[1:]  # name fragments: time only the variants that hold one
    for name, edits in VARIANTS.items():
        if not keep or any(k in name for k in keep):
            sources[name] = apply_edits(base, edits, name, TOOL, "flash_attn_bwd.cu")
    if PARENT.exists() and (not keep or any(k in "parent" for k in keep)):
        sources["parent (float32 FMAs)"] = PARENT.read_text()
    libs = build_all(sources, BUILD, TOOL, verbose=("committed",))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    res = {"card": torch.cuda.get_device_name(0), "nvidia-smi name, power.limit": card}
    for tag, (B, Sq, Skv, Hq, Hkv, dh, kw) in SHAPES.items():
        q = torch.randn((B, Sq, Hq, dh), generator=g, device=dev)
        k, v = (torch.randn((B, Skv, Hkv, dh), generator=g, device=dev) for _ in range(2))
        do = torch.randn((B, Sq, Hq, dh), generator=g, device=dev)
        o, lse = flash_ops._forward(q, k, v, kw["causal"], kw["window"], kw["softcap"], True)
        o_ref, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
        want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        del o_ref, lse_ref
        grads = [torch.empty_like(t) for t in (q, k, v)]
        recs = {}
        for name, lib in libs.items():
            chunks = (lib.flash_attn_bwd_chunks(B, Sq, Skv, Hq, Hkv, dh)
                      if hasattr(lib, "flash_attn_bwd_chunks") else 1)
            scratch = torch.empty(2 * chunks * k.numel() * (chunks > 1) + B * Sq * Hq,
                                  device=dev)

            def run(lib=lib, scratch=scratch):
                err = lib.flash_attn_bwd_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    do.data_ptr(), *(t.data_ptr() for t in grads), scratch.data_ptr(), B, Sq,
                    Skv, Hq, Hkv, dh, int(kw["causal"]), kw["window"], kw["softcap"], stream())
                assert err == 0, (name, err)

            run()
            torch.cuda.synchronize()
            rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(grads, want)]
            recs[name] = dict(chunks=chunks, **device_ms(run), events_ms=events_ms(run, 20),
                              rel_err=dict(zip(("dq", "dk", "dv"), rel)),
                              within_tol=max(rel) <= REL_TOL)
            del scratch
        res[tag] = recs
        del q, k, v, do, o, lse, want, grads
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
