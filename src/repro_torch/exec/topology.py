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

Instrumented plans (`_monolithic_build_instrumented`, both topologies) call
the same stage functions as the plain runner, one `obs.stage` timer and one
`obs.fence` a stage, so their bits equal the plain plan's.  The stages of
`repro_exec_stage_seconds{topology,stage}`, per store:

    exact store (fp32), fused verify     hash_queries, probe, gather
    exact store, unfused verify          hash_queries, probe, gather, merge
    quantized store (int8, bf16)         hash_queries, probe, survivors,
                                         gather, rerank
    quantized store, disk tail           hash_queries, probe, survivors,
                                         gather (host memmap), rerank

The fused verify (`stages.fused_verify`: the gather kernels on, a store with
`gather_topk`, a kernel metric; so the fp32 store on the card) scans and
ranks in one kernel (`gather_l2_topk`), timed as `gather`: it has no
`merge` stage of its own, and no plain top-k runs on the card to give it
one.  `survivors` is the quantized store's fused scan and rank
(`gather_q_topk` for int8 on the card), as in the reference.
"""
from __future__ import annotations

import torch

from ..core.params import SearchParams, _suppress_width_warning
from ..obs.trace import fence
from ..obs.trace import stage as _obs_stage
from ..store import tail as tail_mod
from . import stages
from .plan import register_topology, topology_of


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
    # device, in one copy (this runs on every search call); derived copies do
    # not re-fire the WindowWidthWarning
    dev = index.device
    pins = {}
    if p.use_gather_kernel is None:
        pins["use_gather_kernel"] = stages.resolve_use_kernel(None, dev)
    if p.use_probe_kernel is None:
        pins["use_probe_kernel"] = stages.resolve_use_probe_kernel(None, dev)
    if pins:
        with _suppress_width_warning():
            p = p.replace(**pins)
    stages.check_store_kind(index.store, p)
    return p


def _tail_rows(tail_path: str, surv: torch.Tensor) -> torch.Tensor:
    """The survivors' fp32 rows from the disk tail, on the survivors' device."""
    rows = torch.from_numpy(tail_mod.gather_tail(tail_path, surv.cpu().numpy()))
    return rows.to(surv.device)


def _monolithic_build(index, p: SearchParams):
    if not has_disk_tail(index):
        return lambda idx, queries: search_pipeline(idx, queries, p)

    def run(idx, queries):
        # split plan: device stage 1 -> host memmap gather -> device rerank
        surv = survivor_pipeline(idx, queries, p)
        return stages.rerank_rows(_tail_rows(idx.tail_path, surv), queries, surv, p.k,
                                  p.metric or idx.metric)

    return run


def _monolithic_build_instrumented(index, p: SearchParams):
    """The staged variant of `_monolithic_build`: the same stage calls, each
    fenced inside an `obs.stage` timer (stage names: the module docstring)."""
    topo = topology_of(index)
    metric = p.metric or index.metric

    def front(idx, queries):
        with _obs_stage(topo, "hash_queries"):
            qh = fence(stages.hash_queries(idx.family, queries))
        with _obs_stage(topo, "probe"):
            cand, _ = fence(stages.probe(idx, queries, qh, p))
        return cand

    if index.store.exact:
        use_k = stages.resolve_use_kernel(p.use_gather_kernel, index.device)

        def run(idx, queries):
            cand = front(idx, queries)
            if stages.fused_verify(idx.store, metric, use_k):
                with _obs_stage(topo, "gather"):  # scan + top-k, one kernel
                    return fence(stages.exact_topk(idx.store, queries, cand, cand, p.k,
                                                   metric, use_k))
            with _obs_stage(topo, "gather"):
                dist = fence(idx.store.gather_dist(cand, queries, metric=metric,
                                                   use_kernel=use_k))
            with _obs_stage(topo, "merge"):
                return fence(stages.topk_ids(dist, cand, p.k))

        return run

    disk = has_disk_tail(index)

    def run(idx, queries):
        cand = front(idx, queries)
        with _obs_stage(topo, "survivors"):
            surv, _ = fence(stages.survivors(idx.store, queries, cand, p, metric))
        with _obs_stage(topo, "gather"):
            rows = fence(_tail_rows(idx.tail_path, surv) if disk
                         else stages.gather_fp32(idx.store, idx.tail, surv))
        with _obs_stage(topo, "rerank"):
            return fence(stages.rerank_rows(rows, queries, surv, p.k, metric))

    return run


def _segmented_resolve(index, p: SearchParams) -> SearchParams:
    # `p.source` names the *per-segment* source; rewrite it onto the
    # registered "segmented" wrapper (source="segmented", inner=<source>).
    # SearchParams itself rejects inner="segmented" / "sharded" (recursion).
    if p.source != "segmented":
        with _suppress_width_warning():
            p = p.replace(source="segmented", inner=p.source)
    return _resolve_common(index, p)


register_topology("monolithic", resolve=_resolve_common, build=_monolithic_build,
                  build_instrumented=_monolithic_build_instrumented)
# a segmented index keeps its rerank tail resident (disk-lazy tails are a
# static-index feature), so it runs the plain monolithic body
register_topology("segmented", resolve=_segmented_resolve, build=_monolithic_build,
                  build_instrumented=_monolithic_build_instrumented)
