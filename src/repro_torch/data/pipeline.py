"""Deterministic, resumable, sharded data pipeline (port of
`repro.data.pipeline`).

Determinism contract: batch content is a pure function of (seed, step) --
restart at step k reproduces exactly the batches a non-preempted run would
have seen (the checkpoint stores only the step integer).  Sharding
contract: each data-parallel process slices the same global batch by its
shard index, so no coordination is needed.  An optional LCCS-LSH
near-duplicate filter (`data.dedup.NearDupFilter`, the paper's technique in
the data path) masks batch rows whose embeddings collide with recent
history.  Batches are numpy arrays; the train step moves them to its
device."""
from __future__ import annotations

from typing import Callable

import numpy as np


class DataPipeline:
    def __init__(
        self,
        batch_fn: Callable,  # (step, global_batch, seq_len) -> (tokens, labels)
        *,
        global_batch: int,
        seq_len: int,
        shard_index: int = 0,
        n_shards: int = 1,
        start_step: int = 0,
        dedup=None,  # optional data.dedup.NearDupFilter
    ):
        if global_batch % n_shards:
            raise ValueError(f"a global batch of {global_batch} does not split into "
                             f"{n_shards} shards")
        self.batch_fn = batch_fn
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.shard_index = shard_index
        self.n_shards = n_shards
        self.step = start_step
        self.dedup = dedup

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state["step"])

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        """{"tokens", "labels"} (per-shard rows, seq_len) int32 and "mask"
        float32, 0 on the rows the filter drops."""
        tokens, labels = self.batch_fn(self.step, self.global_batch, self.seq_len)
        per = self.global_batch // self.n_shards
        lo = self.shard_index * per
        tokens = tokens[lo:lo + per]
        labels = labels[lo:lo + per]
        mask = np.ones(tokens.shape, np.float32)
        if self.dedup is not None:
            keep = self.dedup.filter_batch(tokens)
            mask *= keep[:, None].astype(np.float32)
        self.step += 1
        return {"tokens": tokens, "labels": labels, "mask": mask}
