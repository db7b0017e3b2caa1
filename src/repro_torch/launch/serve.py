"""Serving launcher of the port: a model's embeddings + LCCS-LSH retrieval
over a corpus of token documents (port of `repro.launch.serve`, the
synchronous path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --smoke \\
        --corpus 512 --requests 128 [--dynamic] [--store int8] [--device cpu]

Serves from random-init weights (`init_model`, seed 0) on the card unless
`--device cpu`.  `--smoke` takes the architecture's reduced configuration.
`--dynamic` serves a SegmentedLCCSIndex and interleaves an insert / delete /
compact burst into the request stream.  Not offered yet (ROADMAP A10):
`--ckpt-dir`, `--shards`, `--async`, `--metrics-port`, `--trace`,
`--instrument`, `--drift-probe`, `--build-chunk-rows`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import ARCHS
from ..core import SearchParams, available_sources
from ..core.params import _suppress_width_warning
from ..data.synthetic import lm_token_batches
from ..models import init_model
from ..serve import RetrievalEngine
from ..store import available_stores


def request_stream(corpus: np.ndarray, n_requests: int, extra: np.ndarray | None = None):
    """The launcher's request stream: `n_requests` corpus documents picked by
    `default_rng(1)`; with `extra` (a dynamic corpus), a churn burst in its
    middle -- insert `extra`, delete every (n // 8)-th id, compact -- with
    query micro-batches around each update.  Returns (picks, stream)."""
    n = corpus.shape[0]
    picks = np.random.default_rng(1).integers(0, n, n_requests)
    stream: list = [corpus[i] for i in picks]
    if extra is not None:
        mid = len(stream) // 2
        stream[mid:mid] = [("insert", extra), ("delete", np.arange(0, n, max(n // 8, 1))),
                           ("compact",)]
    return picks, stream


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="gemma-2b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--corpus", type=int, default=512)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--lam", type=int, default=64)
    ap.add_argument("--probes", type=int, default=1)
    ap.add_argument("--source", default=None, choices=sorted(available_sources()),
                    help="candidate source; default: lccs, or multiprobe-skip "
                         "when --probes > 1")
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--dynamic", action="store_true",
                    help="serve a SegmentedLCCSIndex and interleave "
                         "insert/delete/compact updates into the stream")
    ap.add_argument("--store", default="fp32", choices=sorted(available_stores()),
                    help="corpus-vector layout: fp32 = exact single-stage "
                         "verify; bf16/int8 = quantized two-stage rerank")
    ap.add_argument("--rerank-mult", type=int, default=4,
                    help="two-stage over-fetch factor (quantized stores "
                         "rerank the best k*rerank_mult survivors in fp32)")
    ap.add_argument("--device", default="cuda",
                    help="device of the model and the index (cuda or cpu)")
    args = ap.parse_args(argv)

    search_params = SearchParams.from_legacy(k=args.k, lam=args.lam, probes=args.probes)
    with _suppress_width_warning():  # derived from the user's own choice above
        search_params = search_params.replace(store=args.store,
                                              rerank_mult=args.rerank_mult)
        if args.source:
            search_params = search_params.replace(source=args.source)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = cfg.smoke()
    model = init_model(cfg, seed=0, device=args.device)
    engine = RetrievalEngine(cfg, model, m=args.m, metric="angular",
                             max_batch=args.max_batch, search_params=search_params,
                             store=args.store, device=args.device)
    gen = lm_token_batches(vocab=cfg.vocab, seed=0)
    corpus, _ = gen(0, args.corpus, 32)
    t0 = time.perf_counter()
    engine.build_index(corpus, dynamic=args.dynamic)
    layout = "dynamic" if args.dynamic else "static"
    print(f"[launch.serve] indexed {args.corpus} docs in "
          f"{time.perf_counter() - t0:.1f}s "
          f"(index {engine.index.index_bytes() / 1e6:.2f} MB + "
          f"{args.store} store {engine.index.store_bytes() / 1e6:.2f} MB, "
          f"{layout}; {engine.device})", flush=True)

    extra = gen(1, args.max_batch, 32)[0] if args.dynamic else None
    picks, stream = request_stream(corpus, args.requests, extra)
    results = engine.serve_stream(stream)
    qres = [r for r in results if not (isinstance(r, tuple) and isinstance(r[0], str))]
    hits = sum(int(picks[i] in ids) for i, (ids, _) in enumerate(qres))
    s = engine.stats
    print(f"[launch.serve] {s.requests} requests / {s.batches} batches; "
          f"embed {s.embed_s:.2f}s search {s.search_s:.2f}s; "
          f"self-retrieval {hits}/{args.requests}", flush=True)
    if args.dynamic:
        idx = engine.index
        print(f"[launch.serve] churn: +{s.inserts} -{s.deletes} docs, "
              f"{s.compactions} compactions; live={idx.n_live} "
              f"segments={idx.segment_sizes()} buffer={idx.buffer_count}", flush=True)


if __name__ == "__main__":
    main()
