"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Drives the port's main path on one NVIDIA card at the paper's SIFT size
(n = 1,000,000, d = 128, m = 64; clustered synthetic data, Euclidean family
at w = 16): LCCSIndex.build on the card, then LCCSIndex.search of 10,000
queries in batches of 1,000 through the "lccs" and "multiprobe-skip"
sources (fp32 store) and the two-stage int8 store.  It builds the CUDA
kernels from the sources in the checkout, shows through their launch counts
that the main path went through them, holds each kernel against its plain
PyTorch version on the card at the main path's shapes, and times both.

Each phase prints one JSON line; any failure exits non-zero.  The last line
is {"ok": true, "device": {...}}.  Without CUDA, or without the rest of the
repository beside it, the script fails before printing a result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

N, D, M, W_BUCKET = 1_000_000, 128, 64, 16.0
N_QUERIES, BATCH, K = 10_000, 1_000, 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (published)
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (published)
LCCS = dict(k=K, lam=100, width=100, source="lccs")
SKIP = dict(k=K, lam=200, width=64, source="multiprobe-skip", probes=17)
GATHER_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 summation order


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync_time(fn):
    """(result, seconds) of fn() on the host clock, fenced by synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def median_ms(fn, reps: int) -> float:
    """Median device time of fn() over `reps` runs, CUDA events, after one
    warm-up run."""
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


@contextmanager
def recording(module, name: str, store: list):
    """Record the arguments of every call to module.<name> (the wrapper the
    main path calls) while the block runs."""
    orig = getattr(module, name)

    def rec(*args, **kw):
        store.append((args, kw))
        return orig(*args, **kw)

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, orig)


def exact_knn(X: torch.Tensor, Q: torch.Tensor, k: int) -> torch.Tensor:
    """Ground-truth k nearest rows by chunked torch.cdist (smoke check only)."""
    out = []
    for s in range(0, Q.shape[0], BATCH):
        d = torch.cdist(Q[s:s + BATCH], X)
        out.append(torch.topk(d, k, dim=1, largest=False).indices)
    return torch.cat(out)


def run_searches(index, Q: torch.Tensor, params):
    ids, dists = [], []
    for s in range(0, Q.shape[0], BATCH):
        i, d = index.search(Q[s:s + BATCH], params)
        ids.append(i)
        dists.append(d)
    return torch.cat(ids), torch.cat(dists)


def check_outputs(ids, dists, n_q: int) -> None:
    if ids.shape != (n_q, K) or dists.shape != (n_q, K) or ids.dtype != torch.int32:
        fail(f"bad output shapes {tuple(ids.shape)} {tuple(dists.shape)} {ids.dtype}")
    valid = ids >= 0
    if not torch.isfinite(dists[valid]).all() or not bool(valid[:, 0].all()):
        fail("non-finite distances or empty results")


def recall_at_k(ids: torch.Tensor, truth: torch.Tensor) -> float:
    hit = (ids[:, :, None].long() == truth[:, None, :]).any(dim=2).sum()
    return float(hit) / truth.numel()


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.manual_seed(0)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run(dev)


def run(dev: torch.device) -> None:
    from repro_torch.core import LCCSIndex, SearchParams
    from repro_torch.core.index import candidates
    from repro_torch.data import clustered_vectors, queries_from
    from repro_torch.exec import stages
    from repro_torch.kernels import common
    from repro_torch.kernels.csa_probe import ops as probe_ops
    from repro_torch.kernels.csa_probe.ref import csa_probe_plain, dedupe_topk_scatter
    from repro_torch.kernels.gather_l2 import ops as l2_ops
    from repro_torch.kernels.gather_l2.ref import gather_dist_ref
    from repro_torch.kernels.gather_q import ops as q_ops
    from repro_torch.kernels.gather_q.ref import gather_dist_q_ref

    card = card_line()

    # -- 1. card + kernel build ---------------------------------------------
    t0 = time.perf_counter()
    so = common.build(verbose=True)
    common.library()
    emit(phase="build_kernels", card=card, library=so.name,
         seconds=time.perf_counter() - t0)

    # -- 2. fp32 index on the card -------------------------------------------
    X_np = clustered_vectors(N, D, n_clusters=100, seed=0)
    Q_np = queries_from(X_np, N_QUERIES, jitter=0.05, seed=1)
    X = torch.from_numpy(X_np).to(dev)
    Q = torch.from_numpy(Q_np).to(dev)
    index, build_s = sync_time(
        lambda: LCCSIndex.build(X, m=M, family="euclidean", w=W_BUCKET, device=dev))
    emit(phase="build_index", store="fp32", n=N, d=D, m=M, seconds=build_s,
         index_bytes=index.index_bytes(), store_bytes=index.store_bytes(),
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    truth = exact_knn(X, Q, K)
    src_rows = torch.from_numpy(
        np.random.default_rng(1).choice(N, N_QUERIES, replace=False)).to(dev)

    # -- 3. main path: fp32 searches -----------------------------------------
    index.search(Q[:BATCH], SearchParams(**LCCS))  # warm-up
    index.search(Q[:BATCH], SearchParams(**SKIP))
    launches = {}
    common.reset_launch_counts()
    results = {}
    for name, kw in (("lccs", LCCS), ("multiprobe-skip", SKIP)):
        (ids, dists), secs = sync_time(lambda: run_searches(index, Q, SearchParams(**kw)))
        check_outputs(ids, dists, N_QUERIES)
        results[name] = ids
        emit(phase="search", store="fp32", source=name, params=kw, qps=N_QUERIES / secs,
             seconds=secs, recall_at_10=recall_at_k(ids, truth),
             top1_self=float((ids[:, 0].long() == src_rows).float().mean()))
    fp32_counts = common.launch_counts()
    emit(phase="launches", run="fp32 lccs + multiprobe-skip", counts=fp32_counts)
    top1 = float((results["lccs"][:, 0].long() == src_rows).float().mean())
    if top1 < 0.90:
        fail(f"lccs top-1 self-retrieval {top1} < 0.90")

    # -- 3b. where one lccs batch spends its time (not counted as launches) --
    qb = Q[:BATCH]
    pl = SearchParams(**LCCS, use_probe_kernel=True, use_gather_kernel=True)
    qh = stages.hash_queries(index.family, qb)
    w_ids, w_lcps = probe_ops.csa_probe_windows(index.csa, qh, width=pl.width)
    cand, _ = dedupe_topk_scatter(w_ids.reshape(BATCH, -1), w_lcps.reshape(BATCH, -1),
                                  N, pl.lam)
    stage_ms = {
        "hash_queries": median_ms(lambda: stages.hash_queries(index.family, qb), 5),
        "probe_windows (csa_probe)": median_ms(
            lambda: probe_ops.csa_probe_windows(index.csa, qh, width=pl.width), 5),
        "dedupe_topk_scatter": median_ms(
            lambda: dedupe_topk_scatter(w_ids.reshape(BATCH, -1), w_lcps.reshape(BATCH, -1),
                                        N, pl.lam), 5),
        "verify (gather_l2 + top-k)": median_ms(
            lambda: stages.verify(index.store, index.tail, qb, cand, pl, "euclidean"), 5),
        "search (whole batch)": median_ms(lambda: index.search(qb, pl), 5),
    }
    emit(phase="stages", store="fp32", source="lccs", batch=BATCH, ms=stage_ms)

    # -- 4. fused probe == legacy window path (first 100 queries) ------------
    fused = candidates(index, Q[:100], SearchParams(**LCCS, use_probe_kernel=True))
    legacy = candidates(index, Q[:100], SearchParams(**LCCS, use_probe_kernel=False))
    same = torch.equal(fused[0], legacy[0]) and torch.equal(fused[1], legacy[1])
    emit(phase="fused_vs_legacy", queries=100, identical=same)
    if not same:
        fail("fused and legacy candidates differ")

    # -- 5. main path: int8 two-stage ----------------------------------------
    index8, build8_s = sync_time(
        lambda: LCCSIndex.build(X, m=M, family="euclidean", w=W_BUCKET, store="int8",
                                device=dev))
    emit(phase="build_index", store="int8", seconds=build8_s,
         index_bytes=index8.index_bytes(), store_bytes=index8.store_bytes())
    p8 = SearchParams(**LCCS, store="int8")
    index8.search(Q[:BATCH], p8)  # warm-up
    common.reset_launch_counts()
    (ids8, d8), secs = sync_time(lambda: run_searches(index8, Q, p8))
    int8_counts = common.launch_counts()
    check_outputs(ids8, d8, N_QUERIES)
    emit(phase="search", store="int8", source="lccs", params=dict(LCCS, rerank_mult=4),
         qps=N_QUERIES / secs, seconds=secs, recall_at_10=recall_at_k(ids8, truth))
    emit(phase="launches", run="int8 lccs", counts=int8_counts)
    launches = {k: fp32_counts[k] + int8_counts[k] for k in fp32_counts}
    for k, v in launches.items():
        if v == 0:
            fail(f"kernel {k} was never launched on the main path")

    # -- 6. each kernel vs its plain version at the main path's shapes ------
    probe_calls, l2_calls, q_calls = [], [], []
    with recording(probe_ops, "csa_probe", probe_calls), \
            recording(l2_ops, "gather_dist_kernel", l2_calls), \
            recording(q_ops, "gather_dist_q_kernel", q_calls):
        index.search(Q[:BATCH], SearchParams(**LCCS))
        index.search(Q[:BATCH], SearchParams(**SKIP))
        index8.search(Q[:BATCH], p8)
    kernels = []

    # B1: the lccs worklist (all shifts of a batch) and the skip pairs worklist
    # calls: lccs all-shift windows; skip base windows, skip pairs; int8 lccs
    if len(probe_calls) != 4 or not l2_calls or not q_calls:
        fail(f"unexpected kernel calls: {len(probe_calls)} {len(l2_calls)} {len(q_calls)}")
    worklists = {"lccs": probe_calls[0], "multiprobe-skip pairs": probe_calls[2]}
    probe_err, probe_rows = 0, {}
    for tag, (args, _) in worklists.items():
        k_out = probe_ops.csa_probe(*args)
        p_out = csa_probe_plain(*args)
        if not (torch.equal(k_out[0], p_out[0]) and torch.equal(k_out[1], p_out[1])):
            fail(f"csa_probe kernel != plain version on the {tag} worklist")
        probe_rows[tag] = int(args[4].shape[0])
    args = worklists["lccs"][0]
    I, L, Hd, qd, shifts, qidx, width = args
    R = shifts.shape[0]
    steps = max(1, N.bit_length())
    # least bytes: per row, (steps + 2) I entries and at least the first
    # compared Hd symbol of each of those rows, 2W I and L window entries,
    # the (R, 2W) ids and lcps written, the worklist, the probe strings once
    probe_bytes = (R * ((steps + 2) * 8 + 2 * width * 8 + 2 * width * 8 + 8)
                   + qd.numel() * 4)
    kernels.append(dict(
        name="csa_probe", route="cuda", source="src/repro_torch/kernels/csrc/csa_probe.cu",
        replaces="src/repro/kernels/csa_probe/csa_probe.py:98",
        launches=launches["csa_probe"], max_abs_err=probe_err,
        ms=median_ms(lambda: probe_ops.csa_probe(*args), 20),
        plain_ms=median_ms(lambda: csa_probe_plain(*args), 3),
        bound_ms=probe_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
        shape=dict(R=R, n=N, m=M, width=width, rows_checked=probe_rows),
    ))

    # B2 / B3: the verify scans, both metrics, a zero row included
    (data, ids, queries), _ = l2_calls[0]
    (codes, scale, ids_q, queries_q), _ = q_calls[0]
    for name, kernel, plain, k_args, row_bytes, src, repl in (
        ("gather_l2", l2_ops.gather_dist_kernel, gather_dist_ref, (data, ids, queries),
         4 * D, "src/repro_torch/kernels/csrc/gather.cu",
         "src/repro/kernels/gather_l2/gather_l2.py:38"),
        ("gather_q", q_ops.gather_dist_q_kernel, gather_dist_q_ref,
         (codes, scale, ids_q, queries_q), D + 4, "src/repro_torch/kernels/csrc/gather.cu",
         "src/repro/kernels/gather_q/gather_q.py:41"),
    ):
        err = 0.0
        for metric in ("euclidean", "angular"):
            z_args = list(k_args)
            zero_id = max(0, int(k_args[-2][0, 0]))
            z_args[0] = k_args[0].clone()
            z_args[0][zero_id] = 0  # a zero row: NaN from the unclamped norms
            kd = kernel(*z_args, metric=metric)
            pd = plain(*z_args, metric=metric)
            if not torch.equal(torch.isnan(kd), torch.isnan(pd)):
                fail(f"{name} {metric}: NaN pattern differs from the plain version")
            torch.testing.assert_close(kd.nan_to_num(), pd.nan_to_num(), **GATHER_TOL)
            if metric == "angular" and not bool(torch.isnan(kd[0, 0])):
                fail(f"{name}: zero row did not give NaN")
            err = max(err, float((kd.nan_to_num() - pd.nan_to_num()).abs().max()))
        b_ids = k_args[-2]
        uniq = int(torch.unique(torch.clamp(b_ids, min=0)).numel())
        B, Lc = b_ids.shape
        nbytes = uniq * row_bytes + b_ids.numel() * 4 * 2 + B * D * 4
        flops = 3 * B * Lc * D
        bound_s = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=launches[name], max_abs_err=err,
            ms=median_ms(lambda: kernel(*k_args, metric="euclidean"), 50),
            plain_ms=median_ms(lambda: plain(*k_args, metric="euclidean"), 5),
            bound_ms=bound_s * 1e3,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
            else "operations",
            library_ms=None, shape=dict(B=B, L=Lc, n=N, d=D, unique_rows=uniq),
        ))
    emit(phase="kernels_vs_plain", tolerance=dict(csa_probe="bit-identical",
                                                  gather=GATHER_TOL), ok=True)

    # -- 7. small input: the kernel path agrees with the plain CPU path ------
    Xs = X_np[:4000]
    cpu = LCCSIndex.build(Xs, m=M, family="euclidean", w=W_BUCKET, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        cpu.save(Path(tmp) / "small.pkl")
        gpu = LCCSIndex.load(Path(tmp) / "small.pkl", device=dev)
    Qs = torch.from_numpy(Xs[:64] + 0.05)
    qh = stages.hash_queries(cpu.family, Qs)
    for kw in (LCCS, SKIP):
        p = SearchParams(**kw, use_probe_kernel=True, use_gather_kernel=True)
        ci, cl = stages.probe(cpu, Qs, qh, p)
        gi, gl = stages.probe(gpu, Qs.to(dev), qh.to(dev), p)
        if not (torch.equal(ci, gi.cpu()) and torch.equal(cl, gl.cpu())):
            fail(f"small input: {kw['source']} candidates differ between card and CPU")
        _, cd = stages.verify(cpu.store, cpu.tail, Qs, ci, p, "euclidean")
        _, gd = stages.verify(gpu.store, gpu.tail, Qs.to(dev), gi, p, "euclidean")
        torch.testing.assert_close(cd, gd.cpu(), **GATHER_TOL)
    emit(phase="small_input_vs_cpu", n=4000, ok=True)

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
