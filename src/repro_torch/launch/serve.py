"""Serving launcher of the port: a model's embeddings + LCCS-LSH retrieval
over a corpus of token documents (port of `repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --smoke \\
        --corpus 512 --requests 128 [--dynamic] [--store int8] [--device cpu] \\
        [--shards 4] [--build-chunk-rows 4096] [--async --replicas 2 --slo-ms 500] \
        [--ckpt-dir DIR]

Serves from random-init weights (`init_model`, seed 0) on the card unless
`--device cpu`.  `--arch` names an architecture of the port's registry
(gemma-2b, gemma3-1b, gemma2-9b, qwen2-7b, falcon-mamba-7b,
qwen3-moe-235b-a22b, llama4-maverick-400b-a17b, zamba2-7b; qwen2-vl-7b and
whisper-tiny are refused, since the engine embeds token ids through a
decoder LM's forward: `serve.engine.check_servable`); `--smoke` takes its
reduced configuration.
`--dynamic` serves a SegmentedLCCSIndex and interleaves an insert / delete /
compact burst into the request stream.  `--shards N` partitions the static
index into N row shards on the one device (`repro_torch.shard`: shard-local
search + the exact global top-k merge); `--build-chunk-rows ROWS` builds the
static index out of core, in ROWS-row blocks (bit-identical).

--async serves the request stream through the deadline-aware serving front
(`repro_torch.router`): --replicas N engines sharing one device, one model
(its weights are not copied) and one index, behind one submit(); --slo-ms
the per-request deadline; --queue-depth the per-replica admission bound.
The launcher warms every plan, polls the router's readiness probe, then
reports the SLO window: p50/p95/p99 end-to-end latency, deadline misses,
and the per-replica plan audit.

Observability (`repro_torch.obs`): --metrics-port N serves Prometheus text
format on :N/metrics and logs a one-line stats summary every
--stats-interval seconds; --trace PATH writes the request span tree as
Chrome-trace JSON (ui.perfetto.dev); --instrument serves through the
staged, per-stage-timed plans (the same bits); --drift-probe N replays N
pinned corpus queries against brute-force ground truth after serving and
reports the recall (the repro_recall_drift gauge).

--ckpt-dir DIR serves the weights of the latest checkpoint in DIR (a train
state that `repro_torch.launch.train --ckpt-dir DIR` or the reference's
launcher wrote) in place of the random ones, as the reference does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..checkpoint import CheckpointManager
from ..configs import ARCHS
from ..core import SearchParams, available_sources
from ..core.params import _suppress_width_warning
from ..data.synthetic import lm_token_batches
from ..models import init_model
from ..serve import RetrievalEngine
from ..serve.engine import check_servable
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


def _wait_ready(router, timeout_s: float = 120.0, poll_s: float = 0.1) -> float:
    """Readiness probe: poll the router until every replica has a live
    worker and a warm plan cache.  Returns the time to ready in seconds."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if router.ready():
            return time.perf_counter() - t0
        time.sleep(poll_s)
    st = router.stats()
    raise TimeoutError(
        f"router not ready after {timeout_s:.0f}s: "
        + ", ".join(f"{r.name}: batches={r.serve['batches']}" for r in st.replicas)
    )


def _serve_async(engine, corpus, picks, args, search_params) -> dict:
    """The --async serving path: replicate the engine, warm + probe
    readiness, push the request stream through the deadline-aware front,
    and report the SLO window and the per-replica plan audit.  Returns the
    answers (`outs`: (request index, (ids, dists)) per admitted request),
    the window's `RouterStats`, the wall seconds and the self-retrieval
    hits."""
    from ..router import QueueFull, Router

    router = Router.replicate(engine, args.replicas, params=search_params,
                              default_slo_ms=args.slo_ms, max_depth=args.queue_depth)
    try:
        router.warm(corpus[: engine.max_batch])
        ready_s = _wait_ready(router)
        print(f"[launch.serve] router ready in {ready_s * 1e3:.0f} ms "
              f"({args.replicas} replicas, slo {args.slo_ms:.0f} ms, "
              f"queue depth {args.queue_depth})", flush=True)
        t0 = time.perf_counter()
        tickets, rejected = [], 0
        for i in picks:
            try:
                tickets.append((int(i), router.submit(corpus[i])))
            except QueueFull as e:
                rejected += 1
                time.sleep(e.retry_after_s)
        outs = [(i, t.result(timeout=300)) for i, t in tickets]
        router.drain(timeout_s=60)
        wall = time.perf_counter() - t0
        hits = sum(int(i in ids) for i, (ids, _) in outs)
        st = router.stats()
        lat = st.latency
        print(f"[launch.serve] async: {st.completed} completed / "
              f"{st.rejected} rejected / {st.deadline_misses} SLO misses "
              f"in {wall:.2f}s ({st.completed / wall:.1f} QPS); "
              f"p50/p95/p99 = {lat['p50_ms']}/{lat['p95_ms']}/{lat['p99_ms']} ms; "
              f"self-retrieval {hits}/{len(tickets)}", flush=True)
        # the plan audit, per replica: misses flat after warm(), evictions
        # flat always (an evicted plan is a future rebuild)
        for r in st.replicas:
            print(f"[launch.serve]   {r.name}: {r.serve['batches']} batches, "
                  f"sizes {r.batch_size_hist}, plan "
                  f"{r.serve['plan_misses']} compiles / "
                  f"{r.serve['plan_hits']} reuses / "
                  f"{r.serve['plan_evictions']} evictions", flush=True)
    finally:
        router.shutdown()
    return dict(outs=outs, stats=st, wall=wall, hits=hits, ready_s=ready_s)


def _obs_epilogue(engine, corpus, args, search_params, metrics_srv, stats_log):
    """After serving: the drift probe, the Chrome-trace export, the metrics
    teardown.  Returns the drift probe's recall (None without one)."""
    recall = None
    if args.drift_probe:
        from ..obs import RecallDriftProbe

        n = min(args.drift_probe, len(corpus))
        sample = engine.embed(corpus[:n])
        probe = RecallDriftProbe(lambda: engine.index, sample, search_params,
                                 label="launch.serve")
        recall = probe.measure()
        print(f"[launch.serve] recall-drift probe: "
              f"recall@{search_params.k} = {recall:.3f} over {n} pinned "
              f"queries (gauge repro_recall_drift)", flush=True)
    if args.trace:
        from ..obs import export_chrome_trace

        doc = export_chrome_trace(args.trace)
        print(f"[launch.serve] wrote {len(doc['traceEvents'])} trace events "
              f"to {args.trace} (load at ui.perfetto.dev)", flush=True)
    if stats_log is not None:
        stats_log.stop()
    if metrics_srv is not None:
        metrics_srv.close()
    return recall


def build_parser() -> argparse.ArgumentParser:
    """The launcher's command line."""
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
    ap.add_argument("--build-chunk-rows", type=int, default=None, metavar="ROWS",
                    help="build the static index out of core: stream the "
                         "embedded corpus through the chunked CSA merge in "
                         "ROWS-row blocks (bit-identical to the monolithic "
                         "build; bounds build transients to O(ROWS) fp32)")
    ap.add_argument("--rerank-mult", type=int, default=4,
                    help="two-stage over-fetch factor (quantized stores "
                         "rerank the best k*rerank_mult survivors in fp32)")
    ap.add_argument("--shards", type=int, default=1,
                    help="partition the static index into this many row "
                         "shards on the device (shard-local search + exact "
                         "global top-k merge); on one card the shards run in "
                         "turn, so this is slower than the monolithic index "
                         "and is not a speed option")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the latest checkpoint a training run wrote there "
                         "(`repro_torch.launch.train --ckpt-dir`, or the reference's)")
    ap.add_argument("--device", default="cuda",
                    help="device of the model and the index (cuda or cpu)")
    ap.add_argument("--async", dest="async_serve", action="store_true",
                    help="serve through the deadline-aware async front "
                         "(repro_torch.router): EDF micro-batching, bounded-queue "
                         "backpressure, SLO latency stats")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica engines behind the router (--async); replicas "
                         "share one device, one model and one index, so plans "
                         "are built once")
    ap.add_argument("--slo-ms", type=float, default=500.0,
                    help="per-request deadline for --async submissions; late "
                         "answers are served but counted as SLO misses (the "
                         "default budgets the launcher's all-at-once request "
                         "burst, where queue wait dominates)")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="per-replica admission bound (--async); beyond it "
                         "submit() rejects with a retry-after hint")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text format on this port (/metrics) "
                         "and log a periodic one-line stats summary")
    ap.add_argument("--stats-interval", type=float, default=5.0,
                    help="seconds between periodic stats log lines "
                         "(with --metrics-port)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="collect the request span tree and write Chrome-trace "
                         "JSON here (load at ui.perfetto.dev)")
    ap.add_argument("--instrument", action="store_true",
                    help="serve through the staged per-stage-timed plans: the "
                         "same bits, every exec stage timed into "
                         "repro_exec_stage_seconds and the trace")
    ap.add_argument("--drift-probe", type=int, default=0, metavar="N",
                    help="after serving, replay N pinned corpus queries against "
                         "brute-force ground truth and report achieved recall "
                         "(the repro_recall_drift gauge)")
    return ap


def main(argv: list[str] | None = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.shards > 1 and args.dynamic:
        ap.error("--shards and --dynamic are mutually exclusive "
                 "(the sharded layout is static)")
    if args.async_serve and args.dynamic:
        ap.error("--async serves query traffic; corpus updates (--dynamic) "
                 "stay on the synchronous stream path")
    if args.build_chunk_rows is not None and args.dynamic:
        ap.error("--build-chunk-rows streams the *static* build; dynamic "
                 "corpora ingest out of core via "
                 "SegmentedLCCSIndex.ingest_chunks")
    # the reference re-execs itself here with more (fake) devices when
    # --shards exceeds the visible count; the port's shards all live on the
    # one device, so no device check or re-exec is needed

    search_params = SearchParams.from_legacy(k=args.k, lam=args.lam, probes=args.probes)
    with _suppress_width_warning():  # derived from the user's own choice above
        search_params = search_params.replace(store=args.store,
                                              rerank_mult=args.rerank_mult)
        if args.shards > 1:
            search_params = search_params.replace(shards=args.shards)
        if args.source:
            search_params = search_params.replace(source=args.source)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = cfg.smoke()
    check_servable(cfg)
    model = init_model(cfg, seed=0, device=args.device)
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if mgr.latest_step() is not None:
            meta = mgr.restore_model(model)
            print(f"[launch.serve] restored step {meta['step']} from {args.ckpt_dir}",
                  flush=True)

    # observability front: metrics endpoint + periodic log line + tracing
    metrics_srv, stats_log = None, None
    if args.metrics_port is not None:
        from ..obs import StatsLogger, start_metrics_server

        metrics_srv = start_metrics_server(args.metrics_port)
        stats_log = StatsLogger(interval_s=args.stats_interval,
                                emit=lambda line: print(line, flush=True)).start()
        print(f"[launch.serve] Prometheus metrics on :{metrics_srv.port}/metrics "
              f"(stats line every {args.stats_interval:.0f}s)", flush=True)
    if args.trace:
        from ..obs import enable_tracing

        enable_tracing()

    engine = RetrievalEngine(cfg, model, m=args.m, metric="angular",
                             max_batch=args.max_batch, search_params=search_params,
                             store=args.store,
                             shards=args.shards if args.shards > 1 else None,
                             device=args.device, instrument=args.instrument)
    gen = lm_token_batches(vocab=cfg.vocab, seed=0)
    corpus, _ = gen(0, args.corpus, 32)
    t0 = time.perf_counter()
    engine.build_index(corpus, dynamic=args.dynamic, chunk_rows=args.build_chunk_rows)
    layout = ("dynamic" if args.dynamic
              else f"{args.shards} shards" if args.shards > 1 else "static")
    print(f"[launch.serve] indexed {args.corpus} docs in "
          f"{time.perf_counter() - t0:.1f}s "
          f"(index {engine.index.index_bytes() / 1e6:.2f} MB + "
          f"{args.store} store {engine.index.store_bytes() / 1e6:.2f} MB, "
          f"{layout}; {engine.device})", flush=True)

    extra = gen(1, args.max_batch, 32)[0] if args.dynamic else None
    picks, stream = request_stream(corpus, args.requests, extra)
    if args.async_serve:
        _serve_async(engine, corpus, picks, args, search_params)
        _obs_epilogue(engine, corpus, args, search_params, metrics_srv, stats_log)
        return
    results = engine.serve_stream(stream)
    qres = [r for r in results if not (isinstance(r, tuple) and isinstance(r[0], str))]
    hits = sum(int(picks[i] in ids) for i, (ids, _) in enumerate(qres))
    s = engine.stats
    print(f"[launch.serve] {s.requests} requests / {s.batches} batches; "
          f"embed {s.embed_s:.2f}s search {s.search_s:.2f}s; "
          f"self-retrieval {hits}/{args.requests}", flush=True)
    # the plan audit: a steady-state serving loop shows a flat build count
    # and no eviction (an evicted plan is a future rebuild)
    print(f"[launch.serve] plan cache: {s.plan_misses} compiles / "
          f"{s.plan_hits} reuses / {s.plan_evictions} evictions "
          f"across {s.batches} batches", flush=True)
    if args.dynamic:
        idx = engine.index
        print(f"[launch.serve] churn: +{s.inserts} -{s.deletes} docs, "
              f"{s.compactions} compactions; live={idx.n_live} "
              f"segments={idx.segment_sizes()} buffer={idx.buffer_count}", flush=True)
    _obs_epilogue(engine, corpus, args, search_params, metrics_srv, stats_log)


if __name__ == "__main__":
    main()
