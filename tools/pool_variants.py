"""Time design variants of the probe pool's dedupe and top-lambda kernel
(src/repro_torch/kernels/csrc/pool_topk.cu) at three pools, on an NVIDIA
card:

    python3 tools/pool_variants.py

Pools (made here from seeds, as chip_smoke.py's paths make them): the lccs
pool (1,000 queries x 12,800 entries: n 10^6, d 128, m 64, W 100, lam 100)
and the multiprobe-skip pool (17 probes, W 64, lam 200) of a clustered
corpus, and a serving-shaped pool (32 x 4,096: 4,096 gaussian rows of
gemma-2b's width 2,048, an angular index of m 32, W 64, lam 64).  For each
pool it prints the `pool_stats` the band filter rests on
(`ref.pool_cut_stats`: the cut lcp, the distinct ids and the entries at or
above it, the row's distinct ids; median, min and max over rows), then for
each variant its kernels' device time under torch.profiler (mean of 20
calls), CUDA events around one call (median of 50, host launch time
included; outputs allocated once, outside the timing) and whether its
output equals `ref.pool_topk_plain` bit for bit.

Each variant is the committed source with a few textual edits, compiled
alone by nvcc (all builds started together).  The design before the bands
(one table of each whole tile, tiles of 8,192 entries: two launches for the
lccs pool), placed at .scratch/pool_topk_parent.cu, is timed beside them,
whole and cut after each of its phases; the committed design is cut after
each of its phases too (a cut kernel returns early and writes no output),
and the two are timed once more in turns (parent, committed, committed,
parent).
Writes one JSON line a pool to stdout.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from variants_common import ROOT, apply_edits, build_all, device_ms, events_ms, stream

from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.csa_probe import ops as probe_ops  # noqa: E402
from repro_torch.kernels.csa_probe.ref import (  # noqa: E402
    pool_chunk,
    pool_cut_stats,
    pool_levels,
    pool_topk_plain,
)

COMMITTED_SRC = (common.CSRC / "pool_topk.cu").read_text()
BUILD = ROOT / ".scratch" / "pool_variants"
PARENT = ROOT / ".scratch" / "pool_topk_parent.cu"
PARENT_TILE = 8192  # the parent wrapper's tile
TOOL = "pool_variants"
CUT = "  if (out_cols > 0) return;  // cut here\n"
# the committed design's phases: (name, the text the cut goes before)
PHASES = (("load + histogram", "  // 4. band passes"),
          ("+ band passes", "  int32_t* oi = out_ids + blk * out_cols;"),
          ("+ a larger table's cut and select", "  // 8. choose every id"))
PARENT_PHASES = (("insert", "  // 2. count the table's ids by lcp"),
                 ("+ histogram and cut", "  // 4. the take-th smallest id"),
                 ("+ select", "  // 5. choose every id above the cut's lcp"))
# the tile staged in shared memory by two 1-D bulk copies (TMA) on an
# mbarrier, then read into registers, in place of the 16-byte loads
STAGE_TMA = [
    ("         (size_t)ints * sizeof(int);",
     "         (size_t)ints * sizeof(int) + 2 * (size_t)cap * sizeof(int32_t) + 64;"),
    ("  K key[E];\n  if (vec) {\n",
     """  uintptr_t st = (reinterpret_cast<uintptr_t>(meta + kMeta) + 15) & ~uintptr_t(15);
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(reinterpret_cast<void*>(st));
  int32_t* stage_i = reinterpret_cast<int32_t*>(st + 16);
  int32_t* stage_l = stage_i + cap;
  if (vec) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      const uint32_t bytes = (uint32_t)len * 4;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar), "r"(2 * bytes) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                   " [%0], [%1], %2, [%3];"
                   ::"r"((uint32_t)__cvta_generic_to_shared(stage_i)), "l"(row_i),
                   "r"(bytes), "r"(bar) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                   " [%0], [%1], %2, [%3];"
                   ::"r"((uint32_t)__cvta_generic_to_shared(stage_l)), "l"(row_l),
                   "r"(bytes), "r"(bar) : "memory");
    }
    for (int spin = 0; spin < (1 << 20); ++spin) {  // bounded: a fault shows, not a hang
      uint32_t done;
      asm volatile("{\\n.reg .pred p;\\n"
                   "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\\n"
                   "selp.u32 %0, 1, 0, p;\\n}" : "=r"(done) : "r"(bar) : "memory");
      if (done) break;
    }
  }
  K key[E];
  if (vec) {
"""),
    ("(int)smem_bytes<K, T>(table_cap(Key<K>::kMaxTile), kMaxK)", "232448"),
    ("        iv = __ldg(reinterpret_cast<const int4*>(row_i + j));\n"
     "        lv = __ldg(reinterpret_cast<const int4*>(row_l + j));",
     "        iv = *reinterpret_cast<const int4*>(stage_i + j);\n"
     "        lv = *reinterpret_cast<const int4*>(stage_l + j);"),
]
# name -> [(text in pool_topk.cu, replacement)]
VARIANTS = {
    "no band filter (every entry into one table, t0 = 0)": [
        ("      meta[kT0] = best;", "      meta[kT0] = 0;")],
    "one lcp a band": [
        ("    const int want = max(2 * band, band + k - distinct);",
         "    const int want = band + 1;")],
    "floors that add as many entries as the missing ids take at the duplication seen": [
        ("    const int want = max(2 * band, band + k - distinct);",
         "    const int want = band + max(band, (k - distinct) * band / max(distinct, 1) + 1);")],
    "tables of 4x their entries": [("constexpr int kGrow = 2;", "constexpr int kGrow = 4;")],
    "tables of 8x their entries": [("constexpr int kGrow = 2;", "constexpr int kGrow = 8;")],
    "no ranking by count (every table selected by the radix passes)": [
        ("constexpr int kRankMax = 256;", "constexpr int kRankMax = 0;")],
    "ranking by count up to 1,024 ids": [
        ("constexpr int kRankMax = 256;", "constexpr int kRankMax = 1024;")],
    "every band through the ring (E 4 and 8 too)": [
        ("    if constexpr (E <= 8) {", "    if constexpr (false) {")],
    "a read before the atomicCAS": [
        ("    const K old = atomicCAS(&tab[slot], KK::kNone, key);\n"
         "    if (old == KK::kNone) return 1;",
         "    K old = *reinterpret_cast<volatile K*>(&tab[slot]);\n"
         "    if (old == KK::kNone) old = atomicCAS(&tab[slot], KK::kNone, key);\n"
         "    if (old == KK::kNone) return 1;")],
    "every band's keys inserted where they lie (no ring)": [
        ("    if constexpr (E <= 8) {", "    if constexpr (true) {")],
    "histogram by __match_any_sync (one add a lcp a warp)": [
        ("    if (key[e] != KK::kNone) atomicAdd(&sub[warp * kBinsPad + KK::lcp(key[e])], 1);",
         "    {\n      const int bin = key[e] == KK::kNone ? -1 : KK::lcp(key[e]);\n"
         "      const unsigned peers = __match_any_sync(kFull, bin);\n"
         "      if (bin >= 0 && lane == __ffs(peers) - 1)\n"
         "        atomicAdd(&sub[warp * kBinsPad + bin], __popc(peers));\n    }")],
    "1,024 threads a block (E 16 at the lccs pool), one block an SM": [
        ("constexpr int kThreads = 512,", "constexpr int kThreads = 1024,")],
    "512 threads a block on a small grid too": [("  if (blocks < sms)\n", "  if (false)\n")],
    "512 threads, one block an SM (no register cap)": [
        ("__launch_bounds__(T, kWideThreads / T)", "__launch_bounds__(T, 1)")],
    "staged in shared memory by cp.async.bulk (TMA) on an mbarrier": STAGE_TMA,
}
N, D, M, BATCH = 1_000_000, 128, 64, 1_000
LCCS = dict(k=10, lam=100, width=100, source="lccs")
SKIP = dict(k=10, lam=200, width=64, source="multiprobe-skip", probes=17)
SERVE_DOCS, SERVE_D, SERVE_M, SERVE_Q = 4096, 2048, 32, 32
SERVE = dict(k=5, lam=64, width=64, source="lccs")


def summary(x: torch.Tensor) -> dict:
    v = x.double().cpu()
    return dict(median=float(v.median()), min=float(v.min()), max=float(v.max()))


def pool_stats(ids, lcps, n: int, lam: int) -> dict:
    cut, above, entries, distinct = pool_cut_stats(ids, lcps, n, lam)
    return dict(cut_lcp=summary(cut), distinct_at_or_above_cut=summary(above),
                entries_at_or_above_cut=summary(entries), distinct=summary(distinct))


def recorded_pools(dev) -> dict:
    """tag -> (ids, lcps, n, lam): the pools the sources hand to pool_topk."""
    import repro_torch.kernels.csa_probe as probe_pkg
    from repro_torch.core import LCCSIndex, SearchParams
    from repro_torch.data import clustered_vectors, queries_from

    calls = []
    orig = probe_ops.pool_topk

    def rec(*args):
        calls.append(args)
        return orig(*args)

    X = clustered_vectors(N, D, n_clusters=100, seed=0)
    Q = torch.from_numpy(queries_from(X, BATCH, jitter=0.05, seed=1)).to(dev)
    index = LCCSIndex.build(torch.from_numpy(X).to(dev), m=M, family="euclidean", w=16.0,
                            device=dev)
    rng = np.random.default_rng(0)
    E = torch.from_numpy(rng.normal(size=(SERVE_DOCS, SERVE_D)).astype(np.float32)).to(dev)
    s_index = LCCSIndex.build(E, m=SERVE_M, family="angular", device=dev)
    Es = E[:SERVE_Q] + 0.01 * torch.randn(SERVE_Q, SERVE_D, device=dev)
    probe_ops.pool_topk = probe_pkg.pool_topk = rec
    try:
        index.search(Q, SearchParams(**LCCS))
        index.search(Q, SearchParams(**SKIP))
        s_index.search(Es, SearchParams(**SERVE))
    finally:
        probe_ops.pool_topk = probe_pkg.pool_topk = orig
    return dict(zip(("lccs", "multiprobe-skip", "serving"), calls))


def caller(lib, ids, lcps, n: int, lam: int, tile: int):
    """One call of the kernel the way the wrapper makes it, at tiles of
    `tile` entries, with its outputs allocated once: (fn, launches, out)."""
    B, pool = ids.shape
    k = min(lam, n)
    chunk = pool_chunk(k, n, tile)
    levels = pool_levels(pool, k, n, tile)
    bufs = []
    for i in range(len(levels)):
        last = i == len(levels) - 1
        shape = (B, lam) if last else (B, levels[i + 1])
        bufs.append((torch.empty(shape, dtype=torch.int32, device=ids.device),
                     torch.empty(shape, dtype=torch.int32, device=ids.device)))

    def fn():
        a, b = ids, lcps
        for i, p in enumerate(levels):
            oi, ov = bufs[i]
            cols = lam if i == len(levels) - 1 else k
            err = lib.pool_topk_launch(a.data_ptr(), b.data_ptr(), oi.data_ptr(), ov.data_ptr(),
                                       B, p, n, chunk, k, cols, stream())
            if err:
                raise RuntimeError(f"pool_topk_launch: cudaError {err}")
            a, b = oi, ov

    return fn, len(levels), bufs[-1]


def timed(lib, args, tile: int, want) -> dict:
    ids, lcps, n, lam = args
    fn, launches, out = caller(lib, ids, lcps, n, lam, tile)
    try:  # a launch the card refuses (say, too much shared memory) is reported
        fn()
    except RuntimeError as e:
        return dict(error=str(e))
    torch.cuda.synchronize()
    dev_ms, seen = device_ms(fn, "pool_topk_kernel", launches)
    rec = dict(device_ms=dev_ms, device_launches_seen=seen, launches_per_call=launches,
               events_ms=events_ms(fn))
    if want is not None:
        fn()
        rec["equal_to_plain"] = bool(torch.equal(out[0], want[0])
                                     and torch.equal(out[1], want[1]))
    return rec


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit(f"{TOOL}: needs an NVIDIA card")
    base = COMMITTED_SRC
    sources = {"committed": base}
    for name, edits in VARIANTS.items():
        sources[name] = apply_edits(base, edits, name, TOOL, "pool_topk.cu")
    for name, before in PHASES:
        sources[f"committed, cut after {name}"] = apply_edits(
            base, [(before, CUT + before)], name, TOOL, "pool_topk.cu")
    if PARENT.exists():
        parent = PARENT.read_text()
        sources["parent design"] = parent
        for name, before in PARENT_PHASES:
            sources[f"parent design, cut after {name}"] = apply_edits(
                parent, [(before, CUT + before)], name, TOOL, PARENT.name)
    libs = build_all(sources, BUILD, TOOL, verbose=("committed",))

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pools = recorded_pools(dev)
    card = torch.cuda.get_device_name(0)
    for tag, args in pools.items():
        ids, lcps, n, lam = args
        want = pool_topk_plain(ids, lcps, n, lam)
        res = dict(card=card, pool=tag, shape=dict(B=ids.shape[0], pool=ids.shape[1], n=n,
                                                   lam=lam),
                   pool_stats=pool_stats(ids, lcps, n, lam))
        for name, lib in libs.items():
            parent = name.startswith("parent")
            cut = " cut after " in name
            res[name] = timed(lib, args, PARENT_TILE if parent else 16384,
                              None if cut else want)
        res["committed, tiles of 8,192 + merge"] = timed(libs["committed"], args, 8192, want)
        if "parent design" in libs:  # the two designs again, in turns
            res["turns: parent, committed, committed, parent"] = [
                timed(libs[name], args, tile, want)["device_ms"]
                for name, tile in (("parent design", PARENT_TILE), ("committed", 16384),
                                   ("committed", 16384), ("parent design", PARENT_TILE))]
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
