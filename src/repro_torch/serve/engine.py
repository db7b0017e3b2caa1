"""Retrieval serving engine (port of `repro.serve.engine`): model embeddings
+ LCCS-LSH ANN.

  build:  corpus token sequences -> the model's final hidden states,
          mean-pooled over the sequence and L2-normalised -> LCCSIndex, or,
          with ``dynamic=True``, a SegmentedLCCSIndex that absorbs online
          inserts and deletes without a full rebuild.
  serve:  batched requests -> embed -> candidate source -> verified top-k,
          with greedy micro-batching.  `serve_stream` interleaves update
          requests -- ("insert", tokens) / ("delete", ids) / ("compact",) --
          with query micro-batches, flushing queued queries before each
          update so every query sees a consistent corpus.

The engine runs on one device (None = CUDA, raising without it): the model
must already live there.  On CUDA the embedding launches the `flash_attn` or
`ssm_scan` kernel in every attention or Mamba-1 layer, and the search the
index's kernels; on the CPU their plain versions run.  Every search goes
through `repro_torch.exec.execute`.

Not ported yet: `serve_batch_nowait` / `PendingBatch` and the stats'
`snapshot` / `delta` (they go with the replica router), sharded serving
(`shards` > 1, ROADMAP A9), the out-of-core build (`chunk_rows`, A8), and the
plan-cache and metrics-registry counters (A6 and the obs port).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..core import LCCSIndex, SearchParams, SegmentedLCCSIndex
from ..core.index import resolve_device
from ..exec import execute
from ..kernels.common import no_tf32

DEFAULT_PARAMS = SearchParams(k=5, lam=64)


@dataclass
class ServeStats:
    requests: int = 0
    batches: int = 0
    embed_s: float = 0.0
    search_s: float = 0.0
    inserts: int = 0
    deletes: int = 0
    compactions: int = 0

    def reset(self) -> None:
        """Zero every counter in place."""
        for f in fields(self):
            setattr(self, f.name, f.default)


class RetrievalEngine:
    def __init__(self, cfg, model, *, m: int = 64, metric: str = "angular",
                 max_batch: int = 32, search_params: SearchParams = DEFAULT_PARAMS,
                 store: str = "fp32", shards: int | None = None, device=None):
        if shards is not None and shards > 1:
            raise NotImplementedError("sharded serving is not ported yet (ROADMAP A9)")
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
        self.index: LCCSIndex | SegmentedLCCSIndex | None = None
        self.stats = ServeStats()

    def _sync(self) -> None:
        """Wait for the device's queued work (host timers around CUDA work)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        The engine's `store` kind decides the vector layout."""
        if chunk_rows is not None:
            raise NotImplementedError("the out-of-core build is not ported yet (ROADMAP A8)")
        emb = self.embed(corpus_tokens)
        fam = "angular" if self.metric == "angular" else "euclidean"
        cls = SegmentedLCCSIndex if dynamic else LCCSIndex
        self.index = cls.build(emb, m=self.m, family=fam, seed=seed, store=self.store,
                               device=self.device)
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
        return gids

    def delete(self, ids) -> int:
        """Tombstone corpus documents by global id."""
        n = self._dynamic_index().delete(ids)
        self.stats.deletes += n
        return n

    def compact(self, *, full: bool = False) -> int:
        """Roll the delta buffer (and small segments) into a CSA segment."""
        n = self._dynamic_index().compact(full=full)
        self.stats.compactions += 1
        return n

    def serve_batch(self, query_tokens, params: SearchParams | None = None):
        """One micro-batched serving step.  Returns (ids, dists) as numpy."""
        if self.index is None:
            raise RuntimeError("build_index first")
        p = params or self.search_params
        self._sync()
        t0 = time.perf_counter()
        q_emb = self.embed(query_tokens)
        self._sync()  # embed time is not credited to the search
        t1 = time.perf_counter()
        ids, dists = execute(self.index, q_emb, p)
        ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
        t2 = time.perf_counter()
        s = self.stats
        s.requests += int(np.shape(query_tokens)[0])
        s.batches += 1
        s.embed_s += t1 - t0
        s.search_s += t2 - t1
        return ids, dists

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
