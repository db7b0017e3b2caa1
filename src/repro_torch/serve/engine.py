"""Retrieval serving engine (port of `repro.serve.engine`): model embeddings
+ LCCS-LSH ANN.

  build:  corpus token sequences -> the model's final hidden states,
          mean-pooled over the sequence and L2-normalised -> LCCSIndex, or,
          with ``dynamic=True``, a SegmentedLCCSIndex that absorbs online
          inserts and deletes without a full rebuild; with ``shards`` > 1 a
          ShardedLCCSIndex of that many row shards on the engine's device
          (static corpora only), and with ``chunk_rows`` the static build
          runs out of core (bit-identical).
  serve:  batched requests -> embed -> candidate source -> verified top-k,
          with greedy micro-batching.  `serve_stream` interleaves update
          requests -- ("insert", tokens) / ("delete", ids) / ("compact",) --
          with query micro-batches, flushing queued queries before each
          update so every query sees a consistent corpus.

The engine runs on one device (None = CUDA, raising without it): the model
must already live there.  On CUDA the embedding launches the `flash_attn` or
`ssm_scan` kernel in every attention or Mamba-1 layer, and the search the
index's kernels; on the CPU their plain versions run.  Every search goes
through the plan cache (`repro_torch.exec.compile_plan`, scoped by the
engine's `name`), and `stats` carries this engine's plan hits, misses and
evictions: a steady-state serving loop grows only `plan_hits`.
`serve_batch_nowait` returns a `PendingBatch` for the replica router
(`repro_torch.router`).  The stats have registry twins
(`repro_serve_*_total{engine}`) and the serving calls trace spans
(`repro_torch.obs`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..core import LCCSIndex, SearchParams, SegmentedLCCSIndex
from ..core.index import resolve_device
from ..exec import compile_plan, plan_cache
from ..shard import ShardedLCCSIndex
from ..kernels.common import no_tf32
from ..obs.registry import registry
from ..obs.trace import add_span as _add_span
from ..obs.trace import span as _span

DEFAULT_PARAMS = SearchParams(k=5, lam=64)


def check_servable(cfg) -> None:
    """Raise ValueError for a model the engine cannot embed with.  The
    engine embeds token ids through the decoder LM's forward (the
    reference's `lm.forward`): a VLM's forward needs patch embeddings
    beside the text, and a whisper's runs an encoder over audio frames, so
    neither is served (the reference's engine fails inside the model on
    both)."""
    if cfg.vlm or cfg.enc_dec:
        kind = "a VLM" if cfg.vlm else "an encoder-decoder"
        raise ValueError(f"{cfg.name} is {kind}: the retrieval engine embeds token ids "
                         "through a decoder LM's forward, and serves no such model")


@dataclass
class ServeStats:
    requests: int = 0
    batches: int = 0
    embed_s: float = 0.0
    search_s: float = 0.0
    inserts: int = 0
    deletes: int = 0
    compactions: int = 0
    # plan-cache outcomes of this engine's serving calls (repro_torch.exec):
    # plan_misses counts plans built, plan_hits reuses; plan_evictions counts
    # this engine's plans later pushed out of the LRU cache (each one a
    # future rebuild)
    plan_hits: int = 0
    plan_misses: int = 0
    plan_evictions: int = 0

    def snapshot(self) -> "ServeStats":
        """An independent copy: the window baseline the serving front
        (`repro_torch.router`) diffs against."""
        return replace(self)

    def delta(self, baseline: "ServeStats") -> "ServeStats":
        """Field-wise `self - baseline`: the activity since `baseline` was
        snapshotted."""
        return ServeStats(**{
            f.name: getattr(self, f.name) - getattr(baseline, f.name)
            for f in fields(self)
        })

    def reset(self) -> None:
        """Zero every counter in place."""
        for f in fields(self):
            setattr(self, f.name, f.default)


class PendingBatch:
    """An in-flight micro-batch from `serve_batch_nowait`: the embed and the
    search are launched, not waited for.  On CUDA it holds one event
    recorded after the embed and one after the search, on the current
    stream; `result()` waits on those two events only -- not on the whole
    device, whose other work may be another replica's -- then records the
    engine stats once and returns host arrays.  On the CPU the work is done
    when `serve_batch_nowait` returns, and the split comes from the host
    clock marks taken there.

    Called promptly (the router does), the embed/search split matches
    `serve_batch`'s; a late `result()` shifts idle wall time into it."""

    def __init__(self, engine: "RetrievalEngine", ids, dists, n_live: int, hit: bool,
                 t0: float, t_embed: float, t_search: float, events):
        self._engine = engine
        self._ids = ids
        self._dists = dists
        self._n_live = n_live
        self._hit = hit
        self._t0 = t0
        self._t_embed = t_embed
        self._t_search = t_search
        self._events = events  # (after embed, after search) CUDA events, or None
        self._out: tuple[np.ndarray, np.ndarray] | None = None

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        if self._out is not None:
            return self._out
        t1, t2 = self._t_embed, self._t_search
        if self._events is not None:
            self._events[0].synchronize()
            t1 = time.perf_counter()
            self._events[1].synchronize()
            t2 = time.perf_counter()
        self._out = (self._ids.cpu().numpy(), self._dists.cpu().numpy())
        self._engine._record_serve(self._n_live, t1 - self._t0, max(t2 - t1, 0.0),
                                   self._hit)
        # retroactive spans: the device work drained between the launch (t0)
        # and now, on whichever thread called result()
        _add_span("serve_batch", self._t0, t2, batch=self._n_live)
        _add_span("embed", self._t0, t1)
        _add_span("search", t1, t2)
        return self._out


class RetrievalEngine:
    def __init__(self, cfg, model, *, m: int = 64, metric: str = "angular",
                 max_batch: int = 32, search_params: SearchParams = DEFAULT_PARAMS,
                 store: str = "fp32", shards: int | None = None, device=None,
                 name: str | None = None, instrument: bool = False):
        check_servable(cfg)
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        model_dev = next(model.parameters()).device
        if model_dev != dev:
            raise ValueError(f"the model lives on {model_dev}, the engine on {dev}")
        self.device = dev
        self.cfg = cfg
        self.model = model
        self.m = m
        self.metric = metric
        self.max_batch = max_batch
        self.search_params = search_params
        # `store` picks the corpus-vector layout: "fp32" serves exact
        # single-stage verification; "bf16"/"int8" quantize on ingest and
        # serve the two-stage rerank path (search_params.rerank_mult)
        self.store = store
        # shards > 1 partitions the built index into that many row shards on
        # the engine's device (repro_torch.shard): shard-local search + the
        # exact global top-k merge
        self.shards = shards
        # `name` labels this engine's plan-cache activity (its scope); the
        # replica router names its engines replica-0..N-1
        self.name = name
        # instrument=True serves through the staged, per-stage-timed plans
        # (the same bits; every stage in repro_exec_stage_seconds)
        self.instrument = instrument
        self.index: LCCSIndex | SegmentedLCCSIndex | ShardedLCCSIndex | None = None
        self.stats = ServeStats()
        # registry twins of the stats counters, labeled by engine: what
        # Prometheus and StatsLogger read
        self._obs_label = name or "default"
        reg = registry()
        self._c_requests = reg.counter(
            "repro_serve_requests_total", "queries served", labelnames=("engine",))
        self._c_batches = reg.counter(
            "repro_serve_batches_total", "serving micro-batches completed",
            labelnames=("engine",))
        self._c_embed_s = reg.counter(
            "repro_serve_embed_seconds_total", "wall seconds in the embedding stage",
            labelnames=("engine",))
        self._c_search_s = reg.counter(
            "repro_serve_search_seconds_total", "wall seconds in the staged search",
            labelnames=("engine",))
        self._c_updates = reg.counter(
            "repro_serve_updates_total", "corpus updates applied (insert/delete/compact)",
            labelnames=("engine", "op"))
        # evictions are charged per scope by the cache; the engine pulls the
        # delta since its last served batch
        self._last_evictions = plan_cache().scope_evictions(self.name)

    def _sync(self) -> None:
        """Wait for the device's queued work (host timers around CUDA work)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _record_serve(self, n: int, embed_s: float, search_s: float, hit: bool) -> None:
        """Record one served micro-batch in the stats and their registry twins."""
        s = self.stats
        s.requests += n
        s.batches += 1
        s.embed_s += embed_s
        s.search_s += search_s
        s.plan_hits += int(hit)
        s.plan_misses += int(not hit)
        ev = plan_cache().scope_evictions(self.name)
        s.plan_evictions += ev - self._last_evictions
        self._last_evictions = ev
        self._c_requests.inc(n, engine=self._obs_label)
        self._c_batches.inc(engine=self._obs_label)
        self._c_embed_s.inc(embed_s, engine=self._obs_label)
        self._c_search_s.inc(search_s, engine=self._obs_label)

    def embed(self, tokens) -> torch.Tensor:
        """(n, S) tokens -> (n, D) float32 on the engine's device: the final
        hidden states mean-pooled over S and L2-normalised, in `max_batch`
        chunks."""
        no_tf32()
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long)
        out = []
        with torch.inference_mode():
            for lo in range(0, toks.shape[0], self.max_batch):
                hidden = self.model(toks[lo:lo + self.max_batch].to(self.device))
                emb = torch.mean(hidden, dim=1)
                out.append(emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True))
        return out[0] if len(out) == 1 else torch.cat(out)

    def build_index(self, corpus_tokens, *, seed: int = 0, dynamic: bool = False,
                    chunk_rows: int | None = None):
        """Embed + index the corpus.  `dynamic=True` builds a
        SegmentedLCCSIndex so `insert`/`delete`/`compact` work afterwards.
        The engine's `store` kind decides the vector layout.  With `shards`
        > 1 the built index is partitioned into that many row shards
        (static corpora only -- the sharded layout is immutable).
        `chunk_rows` routes a static build through the out-of-core path
        (`LCCSIndex.build(chunk_rows=)`, bit-identical); a dynamic corpus
        ingests out of core through `SegmentedLCCSIndex.ingest_chunks`
        instead, so `dynamic=True` refuses it."""
        if dynamic and self.shards and self.shards > 1:
            raise ValueError(
                "sharded serving needs a static corpus: shards > 1 and "
                "dynamic=True are mutually exclusive"
            )
        if dynamic and chunk_rows is not None:
            raise ValueError(
                "chunk_rows streams the static build; a dynamic corpus ingests "
                "out of core through SegmentedLCCSIndex.ingest_chunks"
            )
        emb = self.embed(corpus_tokens)
        fam = "angular" if self.metric == "angular" else "euclidean"
        kw = dict(m=self.m, family=fam, seed=seed, store=self.store, device=self.device)
        if dynamic:
            self.index = SegmentedLCCSIndex.build(emb, **kw)
        elif self.shards and self.shards > 1:
            self.index = ShardedLCCSIndex.build(emb, shards=self.shards,
                                                chunk_rows=chunk_rows, **kw)
        else:
            self.index = LCCSIndex.build(emb, chunk_rows=chunk_rows, **kw)
        return self.index

    # -- dynamic corpus (SegmentedLCCSIndex only) ----------------------------

    def _dynamic_index(self) -> SegmentedLCCSIndex:
        if self.index is None:
            raise RuntimeError("build_index first")
        if not isinstance(self.index, SegmentedLCCSIndex):
            raise TypeError(
                "corpus updates need build_index(..., dynamic=True); this "
                "engine holds a static LCCSIndex"
            )
        return self.index

    def insert(self, corpus_tokens) -> np.ndarray:
        """Embed + insert new corpus documents; returns their global ids."""
        gids = self._dynamic_index().insert(self.embed(corpus_tokens))
        self.stats.inserts += len(gids)
        self._c_updates.inc(len(gids), engine=self._obs_label, op="insert")
        return gids

    def delete(self, ids) -> int:
        """Tombstone corpus documents by global id."""
        n = self._dynamic_index().delete(ids)
        self.stats.deletes += n
        self._c_updates.inc(n, engine=self._obs_label, op="delete")
        return n

    def compact(self, *, full: bool = False) -> int:
        """Roll the delta buffer (and small segments) into a CSA segment."""
        n = self._dynamic_index().compact(full=full)
        self.stats.compactions += 1
        self._c_updates.inc(engine=self._obs_label, op="compact")
        return n

    def _search(self, q_emb: torch.Tensor, params: SearchParams):
        """The batch's plan from the cache (scoped by the engine's name), run
        on the embeddings.  Returns (ids, dists, hit)."""
        plan, hit = compile_plan(self.index, q_emb, params, return_hit=True,
                                 scope=self.name, instrument=self.instrument)
        ids, dists = plan.run(self.index, q_emb)
        return ids, dists, hit

    def serve_batch(self, query_tokens, params: SearchParams | None = None):
        """One micro-batched serving step.  Returns (ids, dists) as numpy."""
        if self.index is None:
            raise RuntimeError("build_index first")
        p = params or self.search_params
        n = int(np.shape(query_tokens)[0])
        with _span("serve_batch", batch=n):
            self._sync()
            t0 = time.perf_counter()
            with _span("embed"):
                q_emb = self.embed(query_tokens)
                self._sync()  # embed time is not credited to the search
            t1 = time.perf_counter()
            with _span("search"):
                ids, dists, hit = self._search(q_emb, p)
                ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
            t2 = time.perf_counter()
        self._record_serve(n, t1 - t0, t2 - t1, hit)
        return ids, dists

    def serve_batch_nowait(self, query_tokens, params: SearchParams | None = None, *,
                           n_live: int | None = None) -> PendingBatch:
        """`serve_batch` without the wait: launch the embed and the search
        and return a `PendingBatch`, whose `result()` waits for this batch's
        work only and records the stats (with this call's plan-cache
        outcome).  `n_live` is the number of real requests when the caller
        padded the batch (the router does), so `stats.requests` counts
        users, not padding."""
        if self.index is None:
            raise RuntimeError("build_index first")
        p = params or self.search_params
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        q_emb = self.embed(query_tokens)
        stream = torch.cuda.current_stream(self.device) if cuda else None
        after_embed = torch.cuda.Event() if cuda else None
        if cuda:
            after_embed.record(stream)
        t_embed = time.perf_counter()
        ids, dists, hit = self._search(q_emb, p)
        events = None
        if cuda:
            after_search = torch.cuda.Event()
            after_search.record(stream)
            events = (after_embed, after_search)
        n = int(np.shape(query_tokens)[0]) if n_live is None else n_live
        return PendingBatch(self, ids, dists, n, hit, t0, t_embed, time.perf_counter(),
                            events)

    def serve_stream(self, requests: list, params: SearchParams | None = None):
        """Greedy micro-batching over a request stream: coalesce up to
        max_batch queued queries per step.

        A request is either a query (token array) or -- against a dynamic
        index -- a corpus update tuple:

            ("insert", tokens (b, L))   -> ("inserted", global ids)
            ("delete", ids)             -> ("deleted", n_live_removed)
            ("compact",)                -> ("compacted", rows_merged)

        Updates flush queued queries first, so results stay in stream order
        and every query is answered against the corpus state at its arrival.
        A query whose length differs from the queued batch flushes it first,
        so every micro-batch is rectangular and no query is padded.
        Returns one entry per request: (ids, dists) for queries, the ack
        tuples above for updates."""
        p = params or self.search_params
        results: list = []
        queue: list[np.ndarray] = []

        def flush():
            if not queue:
                return
            ids, dists = self.serve_batch(np.stack(queue), p)
            results.extend(zip(ids, dists))
            queue.clear()

        for r in requests:
            if isinstance(r, tuple) and r and isinstance(r[0], str):
                op = r[0]
                if op in ("insert", "delete", "compact") and not isinstance(
                        self.index, SegmentedLCCSIndex):
                    raise ValueError(
                        f"stream op {op!r} needs a dynamic corpus, but this "
                        f"engine holds a static {type(self.index).__name__}; "
                        f"build the index with build_index(..., dynamic=True)"
                    )
                flush()  # queries queued before the update see the old corpus
                if op == "insert":
                    results.append(("inserted", self.insert(r[1])))
                elif op == "delete":
                    results.append(("deleted", self.delete(r[1])))
                elif op == "compact":
                    results.append(("compacted", self.compact()))
                else:
                    raise ValueError(f"unknown stream op {op!r}")
                continue
            r = np.asarray(r)
            if queue and r.shape != queue[0].shape:
                flush()  # length change: close the rectangular micro-batch
            queue.append(r)
            if len(queue) >= self.max_batch:
                flush()
        flush()
        return results
