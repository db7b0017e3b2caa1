"""The staged query pipeline: pure, composable stage functions (PyTorch port
of `repro.exec.stages`, the stages the monolithic topology runs).

    embed/hash   hash_queries         query vectors -> (B, m) hash strings
    probe        probe                candidate source -> (B, lam) ids + LCPs
    gather       gather_fp32          candidate ids -> fp32 rows (tail or
                                      dequantized store reconstruction)
    verify       exact_topk           exact single-stage scan + nearest-k
                 survivors            stage 1 of the two-stage path: the
                                      approximate scan's best R = min(
                                      k*rerank_mult, lam) candidates
                 rerank_rows          stage 2: exact fp32 rerank of gathered
                                      rows
                 verify               the composed verification
    merge        merge_candidates     exact max-LCP merge of per-part
                                      candidate sets (the segmented and
                                      sharded fan-outs)
                 merge_topk           the global top-k of pooled per-shard
                                      result sets (`topk_ids`)
                 cut_survivors        a pooled survivor set cut back to the
                                      global stage-1 budget R
                 pad_candidates, local_to_global, mask_dead
                                      the id algebra around it

Every top-k here breaks ties toward the lower index, as `lax.top_k` does in
the reference, never through a raw `torch.topk`: with the gather kernels on
and a store that has the fused entry (fp32, int8), `exact_topk` and
`survivors` rank inside the gather kernel (`store.gather_topk`: each
candidate's (value, slot) key ranked, ties to the lower slot); every other
top-k here, and those two on any other route, is a stable sort.
"""
from __future__ import annotations

import os

import torch

ENV_GATHER_KERNEL = "REPRO_GATHER_KERNEL"
ENV_PROBE_KERNEL = "REPRO_PROBE_KERNEL"


# ---------------------------------------------------------------------------
# embed/hash + probe
# ---------------------------------------------------------------------------


def hash_queries(family, queries: torch.Tensor) -> torch.Tensor:
    """Hash stage: (B, d) float32 queries -> (B, m) int32 hash strings."""
    return family.hash(queries)


def probe(index, queries: torch.Tensor, qh: torch.Tensor, params):
    """Probe stage: dispatch to the registered candidate source named by
    `params.source`.  Returns (ids (B, lam), lcps (B, lam)), -1 padded."""
    from ..core.sources import get_source  # lazy: sources imports stages

    return get_source(params.source)(index, queries, qh, params)


# ---------------------------------------------------------------------------
# verify stages
# ---------------------------------------------------------------------------


def _resolve(flag: bool | None, env_name: str, device) -> bool:
    if flag is not None:
        return bool(flag)
    env = os.environ.get(env_name)
    if env is not None:
        return env.strip().lower() not in ("", "0", "false", "off")
    return device is not None and torch.device(device).type == "cuda"


def resolve_use_kernel(flag: bool | None, device=None) -> bool:
    """Tri-state resolution of `SearchParams.use_gather_kernel`: the flag
    when set, else the REPRO_GATHER_KERNEL env var when set, else on when the
    index lies on CUDA (`device`)."""
    return _resolve(flag, ENV_GATHER_KERNEL, device)


def resolve_use_probe_kernel(flag: bool | None, device=None) -> bool:
    """Tri-state resolution of `SearchParams.use_probe_kernel` (the fused CSA
    probe vs the legacy window path): same contract as
    `resolve_use_kernel`, with REPRO_PROBE_KERNEL."""
    return _resolve(flag, ENV_PROBE_KERNEL, device)


def check_store_kind(store, params) -> None:
    """Enforce the `SearchParams.store` pin against the index's store."""
    if params.store is not None and params.store != store.kind:
        raise ValueError(
            f"SearchParams(store={params.store!r}) does not match the index's "
            f"store {store.kind!r}; rebuild the index or drop the param"
        )


def _smallest(dist: torch.Tensor, k: int):
    """(values, indices) of the k smallest per row, ties to the lower index
    (== the reference's `lax.top_k(-dist, k)`)."""
    vals, idx = torch.sort(dist, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def topk_ids(dist: torch.Tensor, ids: torch.Tensor, k: int):
    """Nearest-k (ids, dists) with -1/inf padding."""
    kk = min(k, ids.shape[1])
    out_d, idx = _smallest(dist, kk)
    out_ids = torch.gather(ids, 1, idx)
    out_ids = torch.where(torch.isfinite(out_d), out_ids, torch.full_like(out_ids, -1))
    if kk < k:
        out_ids = torch.nn.functional.pad(out_ids, (0, k - kk), value=-1)
        out_d = torch.nn.functional.pad(out_d, (0, k - kk), value=float("inf"))
    return out_ids, out_d


merge_topk = topk_ids  # result-set merge: the same operation, read as a stage


def fused_verify(store, metric: str, use_kernel: bool) -> bool:
    """True when the verify's scan and top-k run as one gather kernel pass
    (`store.gather_topk`): the gather kernels are on, the store has the
    fused entry and the metric is one the kernels take."""
    from ..store.stores import KERNEL_METRICS

    return use_kernel and metric in KERNEL_METRICS and hasattr(store, "gather_topk")


def exact_topk(store, queries, cand_ids, report_ids, k: int, metric: str,
               use_kernel: bool):
    """Single-stage exact verification: scan `cand_ids` against `store` and
    return the nearest k of `report_ids`."""
    if fused_verify(store, metric, use_kernel):
        return store.gather_topk(cand_ids, queries, k, metric=metric, report_ids=report_ids)
    dist = store.gather_dist(cand_ids, queries, metric=metric, use_kernel=use_kernel)
    return topk_ids(dist, report_ids, k)


def survivor_budget(params, pool: int) -> int:
    """R, the stage-1 over-fetch budget: min(k * rerank_mult, lam, pool)."""
    return min(max(params.k * params.rerank_mult, params.k), params.lam, pool)


def survivors(store, queries, cand_ids, params, metric: str):
    """Stage 1 of the two-stage path: approximate scan + over-fetch.
    Returns (ids (B, R), approx dists (B, R)) with R = `survivor_budget`."""
    check_store_kind(store, params)
    use_kernel = resolve_use_kernel(params.use_gather_kernel, cand_ids.device)
    r = survivor_budget(params, cand_ids.shape[1])
    if fused_verify(store, metric, use_kernel):
        return store.gather_topk(cand_ids, queries, r, metric=metric, survivors=True)
    dist = store.gather_dist(cand_ids, queries, metric=metric, use_kernel=use_kernel)
    vals, idx = _smallest(dist, r)
    return torch.gather(cand_ids, 1, idx), vals


def gather_fp32(store, tail, ids: torch.Tensor) -> torch.Tensor:
    """Gather stage: (B, R) candidate ids -> (B, R, d) fp32 rows for the
    exact rerank -- the resident fp32 tail when one exists, else the store's
    (possibly dequantized) reconstruction."""
    if tail is not None:
        return tail[torch.clamp(ids, min=0).long()]
    return store.gather(ids)


def rerank_rows(rows: torch.Tensor, queries: torch.Tensor, cand_ids: torch.Tensor,
                k: int, metric: str):
    """Stage 2: exact distance + top-k over already-gathered rows."""
    from ..core.lsh import distance

    dist = distance(rows, queries[:, None, :], metric)
    dist = torch.where(cand_ids >= 0, dist, torch.full_like(dist, float("inf")))
    return topk_ids(dist, cand_ids, k)


def cut_survivors(ids: torch.Tensor, approx: torch.Tensor, rows: torch.Tensor, params):
    """Cut a pooled survivor set (the sharded fan-out's per-shard survivor
    sets, concatenated) back to the global stage-1 budget R by approximate
    distance, ties to the lower index.  Each part's local top-R is a
    superset of its members of the global top-R, so the cut reproduces the
    monolithic survivor set.  Returns (ids (B, R), rows (B, R, d))."""
    r = survivor_budget(params, ids.shape[1])
    _, sel = _smallest(approx, r)
    ids_sel = torch.gather(ids, 1, sel)
    rows_sel = torch.gather(rows, 1, sel[..., None].expand(-1, -1, rows.shape[2]))
    return ids_sel, rows_sel


def verify(store, tail, queries, cand_ids, params, metric: str):
    """The composed verification stage: single-stage `exact_topk` for exact
    stores, `survivors -> gather_fp32 -> rerank_rows` for quantized ones.
    tail=None on an inexact store reranks against the store's own
    dequantized rows."""
    check_store_kind(store, params)
    if store.exact:
        use_kernel = resolve_use_kernel(params.use_gather_kernel, cand_ids.device)
        return exact_topk(store, queries, cand_ids, cand_ids, params.k, metric, use_kernel)
    surv_ids, _ = survivors(store, queries, cand_ids, params, metric)
    rows = gather_fp32(store, tail, surv_ids)
    return rerank_rows(rows, queries, surv_ids, params.k, metric)


# ---------------------------------------------------------------------------
# merge stages + id algebra (segmented and sharded fan-outs)
# ---------------------------------------------------------------------------


def merge_candidates(ids: torch.Tensor, lcps: torch.Tensor, lam: int):
    """Candidate-set merge: max-LCP dedupe per id + global top-lambda over a
    concatenated (B, sum_parts) pool.  Exact because LCCS scoring is
    pointwise per object (the reference's vmapped `dedupe_topk`; the port's
    `dedupe_topk` is batched over rows already)."""
    from ..core.search import dedupe_topk  # lazy: core imports exec

    return dedupe_topk(ids, lcps, lam)


def pad_candidates(ids: torch.Tensor, vals: torch.Tensor, lam: int):
    """(B, j) -> (B, lam), -1 padded, for j <= lam (part-local top-k sets
    narrower than the merge width)."""
    j = ids.shape[1]
    if j < lam:
        ids = torch.nn.functional.pad(ids, (0, lam - j), value=-1)
        vals = torch.nn.functional.pad(vals, (0, lam - j), value=-1)
    return ids, vals


def local_to_global(local_ids: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """Map part-local candidate ids through a part's (rows,) global-id array;
    -1 padding (and padded rows, gid -1) stays -1."""
    rows = gid.shape[0]
    g = gid[torch.clamp(local_ids, 0, rows - 1).long()]
    return torch.where(local_ids >= 0, g, torch.full_like(g, -1))


def mask_dead(gids: torch.Tensor, vals: torch.Tensor, alive: torch.Tensor):
    """Tombstone mask: candidates whose global id is dead (or padding) are
    dropped from the merge (id -> -1, score -> -1)."""
    live = (gids >= 0) & alive[torch.clamp(gids, min=0).long()]
    return (torch.where(live, gids, torch.full_like(gids, -1)),
            torch.where(live, vals, torch.full_like(vals, -1)))
