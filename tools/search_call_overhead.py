"""Host cost of one `LCCSIndex.search` call on the card, and of the plan
lookup in it: the main path's n = 10^6 index (chip_smoke.py's cell 1, m 64,
w 16), fp32 and int8, `lccs` at lam = width = 100, batches of 1,000
queries.

For each store: `--calls` searches of one batch, each fenced by
`torch.cuda.synchronize`, timed on the host clock (median and quartiles,
ms), and the host-only work in front of the runner (`--lookups` times, no
device work): `exec.compile_plan` where the package has the plan cache,
else the topology's `resolve` + `build` that `execute` ran per call.  One
JSON line a store.  Point PYTHONPATH at either tree's `src` to compare two
commits in one call on one card, in turns:

    PYTHONPATH=src python3 tools/search_call_overhead.py [--calls 300] [--lookups 2000]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

N, D, M, W_BUCKET, BATCH = 1_000_000, 128, 64, 16.0, 1_000


def quartiles_ms(seconds: list[float]) -> dict:
    q1, med, q3 = statistics.quantiles([s * 1e3 for s in seconds], n=4)
    return {"q1": q1, "median": med, "q3": q3}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=300)
    ap.add_argument("--lookups", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("search_call_overhead: needs an NVIDIA card")
    from repro_torch.core import LCCSIndex, SearchParams
    from repro_torch.data import clustered_vectors, queries_from
    from repro_torch.exec import plan as plan_mod
    from repro_torch.kernels import common

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    common.library()
    X_np = clustered_vectors(N, D, n_clusters=100, seed=0)
    X = torch.from_numpy(X_np).to(dev)
    Q = torch.from_numpy(queries_from(X_np, BATCH, jitter=0.05, seed=1)).to(dev)
    p = SearchParams(k=10, lam=100, width=100, source="lccs")
    for store in ("fp32", "int8"):
        index = LCCSIndex.build(X, m=M, family="euclidean", w=W_BUCKET, store=store,
                                device=dev)
        for _ in range(5):
            index.search(Q, p)
        calls = []
        for _ in range(args.calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index.search(Q, p)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
        if hasattr(plan_mod, "compile_plan"):
            lookup = "compile_plan"
            fn = lambda: plan_mod.compile_plan(index, Q, p)
        else:
            lookup = "resolve + build"
            adapter = plan_mod.get_topology(plan_mod.topology_of(index))
            fn = lambda: adapter.build(index, adapter.resolve(index, p))
        fn()
        lookups = []
        for _ in range(args.lookups):
            t0 = time.perf_counter()
            fn()
            lookups.append(time.perf_counter() - t0)
        call_ms = quartiles_ms(calls)
        print(json.dumps({"store": store, "card": card, "batch": BATCH, "calls": args.calls,
                          "call_ms": call_ms, "qps": BATCH / call_ms["median"] * 1e3,
                          "lookup": lookup, "lookup_us": {
                              k: v * 1e3 for k, v in quartiles_ms(lookups).items()}}),
              flush=True)
        del index
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
