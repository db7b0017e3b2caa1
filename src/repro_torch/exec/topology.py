"""Monolithic and segmented topology adapters (PyTorch port of
`repro.exec.topology`).

`search_pipeline` is the staged hash -> probe -> verify body.  Both adapters
run it; the segmented index differs only in params resolution: its
per-segment fan-out and exact candidate merge live in the registered
"segmented" candidate source (`core.segments`).  The one different
execution shape is the disk-lazy rerank tail: a quantized index whose fp32
rows live in an .npy runs stage 1 (hash -> probe -> survivors) on
the device, gathers the survivors' rows from the memmap on the host, and
reranks them on the device.
"""
from __future__ import annotations

import torch

from ..core.params import SearchParams, _suppress_width_warning
from ..store import tail as tail_mod
from . import stages
from .plan import register_topology


def search_pipeline(index, queries: torch.Tensor, params: SearchParams):
    """hash -> probe -> verify over one resident-data index."""
    qh = stages.hash_queries(index.family, queries)
    cand_ids, _ = stages.probe(index, queries, qh, params)
    return stages.verify(
        index.store, index.tail, queries, cand_ids, params,
        params.metric or index.metric,
    )


def survivor_pipeline(index, queries: torch.Tensor, params: SearchParams):
    """hash -> probe -> stage-1 survivors only: the device half of the
    disk-tail split plan.  Returns survivor ids (B, R)."""
    qh = stages.hash_queries(index.family, queries)
    cand_ids, _ = stages.probe(index, queries, qh, params)
    surv, _ = stages.survivors(
        index.store, queries, cand_ids, params, params.metric or index.metric
    )
    return surv


def has_disk_tail(index) -> bool:
    """True when the index's exact rerank rows live on disk (quantized store,
    no resident tail, `tail_path` set)."""
    return (
        not index.store.exact
        and index.tail is None
        and bool(index.tail_path)
    )


def _resolve_common(index, p: SearchParams) -> SearchParams:
    # pin the tri-state kernel toggles to concrete bools for this index's
    # device; derived copies do not re-fire the WindowWidthWarning
    dev = index.device
    if p.use_gather_kernel is None:
        with _suppress_width_warning():
            p = p.replace(use_gather_kernel=stages.resolve_use_kernel(None, dev))
    if p.use_probe_kernel is None:
        with _suppress_width_warning():
            p = p.replace(use_probe_kernel=stages.resolve_use_probe_kernel(None, dev))
    stages.check_store_kind(index.store, p)
    return p


def _monolithic_build(index, p: SearchParams):
    if not has_disk_tail(index):
        return lambda idx, queries: search_pipeline(idx, queries, p)

    def run(idx, queries):
        # split plan: device stage 1 -> host memmap gather -> device rerank
        surv = survivor_pipeline(idx, queries, p)
        rows = torch.from_numpy(tail_mod.gather_tail(idx.tail_path, surv.cpu().numpy()))
        return stages.rerank_rows(rows.to(queries.device), queries, surv, p.k,
                                  p.metric or idx.metric)

    return run


def _segmented_resolve(index, p: SearchParams) -> SearchParams:
    # `p.source` names the *per-segment* source; rewrite it onto the
    # registered "segmented" wrapper (source="segmented", inner=<source>).
    # SearchParams itself rejects inner="segmented" / "sharded" (recursion).
    if p.source != "segmented":
        with _suppress_width_warning():
            p = p.replace(source="segmented", inner=p.source)
    return _resolve_common(index, p)


register_topology("monolithic", resolve=_resolve_common, build=_monolithic_build)
# a segmented index keeps its rerank tail resident (disk-lazy tails are a
# static-index feature), so it runs the plain monolithic body
register_topology("segmented", resolve=_segmented_resolve, build=_monolithic_build)
