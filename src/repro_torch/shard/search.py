"""Sharded query pipeline (PyTorch port of `repro.shard.search`): a loop
over the shards on one device in place of the reference's `shard_map`,
finished by the reference's exact global merge.

Every shard runs the same staged pipeline a monolithic `LCCSIndex` runs over
its rows -- the registered candidate source named by ``params.inner``
(``params.source`` is "sharded"), then the `repro_torch.exec.stages`
verification over the shard's own store slice -- so on a CUDA index each
shard's probe and verify launch the same kernels (`csa_probe`,
`pool_topk`, `gather_l2_topk` / `gather_q_topk`).  The probe/verify budget
is apportioned: each shard runs its source with lam_local = ceil(lam / S)
(and a ceil(W / S) window when the width is derived, `_local_params`).
The verification then splits:

  exact stores   `stages.exact_topk` per shard (global ids reported) ->
                 pooled (B, S*k) -> `stages.merge_topk`.  Identical to the
                 monolithic result over the union of per-shard candidates.
  inexact stores per-shard `stages.survivors` keeps the best
                 R = min(k * rerank_mult, lam_local) local survivors and
                 `stages.gather_fp32` fetches their rerank rows; the pooled
                 survivors are cut by `stages.cut_survivors` to the global
                 budget, and one `stages.rerank_rows` ranks them.

Each shard's payload is concatenated along axis 1 in shard order, the order
the reference's `all_gather(..., axis=1)` gives, so the merge sees the same
pool.  Global ids come from the per-shard `gid` arrays
(`stages.local_to_global`): padded rows carry gid -1 and are masked before
the merge.

Importing this module registers the "sharded" candidate source (candidate
generation alone, global ids merged by LCP) and the "sharded" topology
adapter, so `execute` serves a `ShardedLCCSIndex` through the plan cache.
"""
from __future__ import annotations

import torch

from ..core.params import SearchParams, _suppress_width_warning
from ..core.sources import get_source, register_source
from ..exec import register_topology, stages
from ..exec.topology import _resolve_common
from ..obs.trace import fence
from ..obs.trace import stage as _obs_stage
from .index import ShardedLCCSIndex


def _inner_name(params: SearchParams) -> str:
    return params.inner if params.source == "sharded" else params.source


def _local_params(params: SearchParams, shards: int) -> SearchParams:
    """Apportion the per-shard probe budget by the shard's row share.

    Each shard holds ~1/S of the rows, so its local candidate cut is
    top-ceil(lam/S), not top-lam: the candidate budget across shards equals
    the monolithic lam instead of S x lam.  When the window width is
    derived (width=None), the per-shard window likewise shrinks to
    max(4, ceil(W/S)).

    Exactness survives: complete coverage lam >= n implies ceil(lam/S) >=
    ceil(n/S) >= every padded shard's row count, and an *explicit* width is
    honoured unscaled.  The floor keeps lam_local >= k so each shard can
    always fill the merge's k slots."""
    if shards <= 1:
        return params
    lam_l = max(params.k, -(-params.lam // shards))
    with _suppress_width_warning():  # derived copy: the user's params warned
        width_l = (params.width if params.width is not None
                   else max(4, -(-params.resolved_width() // shards)))
        return params.replace(lam=lam_l, width=width_l)


def _probe_local(view, gid_l, queries, qh, params, shards):
    """Per-shard probe half: the inner source under the apportioned budget,
    local ids mapped to global and padded rows masked.  Returns
    (ids_l (B, lam_l) local ids, g (B, lam_l) global ids, lcps (B, lam_l)),
    each -1 on padded rows."""
    p_l = _local_params(params, shards)
    ids_l, lcps = get_source(_inner_name(p_l))(view, queries, qh, p_l)
    g = stages.local_to_global(ids_l, gid_l)
    pad = g < 0
    return ids_l.masked_fill(pad, -1), g, lcps.masked_fill(pad, -1)


def _verify_local(view, gid_l, ids_l, g, queries, params, metric, shards):
    """Per-shard verify half -> this shard's pre-merge payload: an exact
    store yields its local (ids_k, d_k) top-k with global ids, an inexact
    one its stage-1 (global survivor ids, approx dists, fp32 rerank rows)."""
    if view.store.exact:
        use_kernel = stages.resolve_use_kernel(params.use_gather_kernel, view.device)
        return stages.exact_topk(view.store, queries, ids_l, g, params.k, metric, use_kernel)
    p_l = _local_params(params, shards)
    surv_l, approx = stages.survivors(view.store, queries, ids_l, p_l, metric)
    g_surv = stages.local_to_global(surv_l, gid_l)
    rows_f = stages.gather_fp32(view.store, view.tail, surv_l)  # (B, R, d)
    return g_surv, approx, rows_f


def _pool(parts: list) -> tuple:
    """Per-shard payloads (each a tuple of (B, x, ...) tensors) pooled along
    axis 1 in shard order -- the reference's `all_gather(axis=1)` layout."""
    return tuple(torch.cat(xs, dim=1) for xs in zip(*parts))


def _merge_global(pooled, queries, params, metric, exact: bool):
    """Global merge over the pooled per-shard payloads.  The merge keeps the
    GLOBAL params: `cut_survivors` reproduces the monolithic
    min(k*rerank_mult, lam) stage-1 survivor set."""
    if exact:
        all_ids, all_d = pooled
        return stages.merge_topk(all_d, all_ids, params.k)
    all_ids, all_a, all_rows = pooled
    ids_sel, rows_sel = stages.cut_survivors(all_ids, all_a, all_rows, params)
    return stages.rerank_rows(rows_sel, queries, ids_sel, params.k, metric)


def _search_impl(index: ShardedLCCSIndex, queries: torch.Tensor, params: SearchParams):
    """The sharded pipeline body (no guards): hash once, probe and verify
    shard by shard, merge globally."""
    qh = stages.hash_queries(index.family, queries)
    metric = params.metric or index.metric
    parts = []
    for s in range(index.shards):
        view, gid_l = index.local_view(s)
        ids_l, g, _ = _probe_local(view, gid_l, queries, qh, params, index.shards)
        parts.append(_verify_local(view, gid_l, ids_l, g, queries, params, metric,
                                   index.shards))
    return _merge_global(_pool(parts), queries, params, metric, index.store.exact)


def search(index: ShardedLCCSIndex, queries, params: SearchParams):
    """Full sharded c-k-ANNS: hash -> per-shard source -> per-shard verify ->
    exact global top-k, with `params` used as given (no toggle pinning; use
    `index.search` for the plan-cached route)."""
    if not isinstance(index, ShardedLCCSIndex):
        raise TypeError(
            "repro_torch.shard.search needs a ShardedLCCSIndex; monolithic "
            "indexes use repro_torch.core.index.search"
        )
    queries = torch.as_tensor(queries, dtype=torch.float32).to(index.device)
    return _search_impl(index, queries, params)


# ---------------------------------------------------------------------------
# The "sharded" topology adapter (repro_torch.exec plan integration)
# ---------------------------------------------------------------------------


def _sharded_resolve(index, p: SearchParams) -> SearchParams:
    if p.source == "segmented":
        raise ValueError(
            "source='segmented' needs a SegmentedLCCSIndex; a sharded "
            "index runs per-shard sources ('lccs', 'bruteforce', ...)"
        )
    if p.source != "sharded":
        with _suppress_width_warning():  # derived copy: the user's params warned
            p = p.replace(source="sharded", inner=p.source)
    if p.shards is not None and p.shards != index.shards:
        raise ValueError(
            f"SearchParams(shards={p.shards}) does not match this index's "
            f"{index.shards} shards"
        )
    return _resolve_common(index, p)


def _sharded_build(index, p: SearchParams):
    return lambda idx, queries: _search_impl(idx, queries, p)


def _sharded_build_instrumented(index, p: SearchParams):
    """The staged variant of `_sharded_build`: the same calls, split at the
    reference's collective boundaries (hash_queries / probe / verify /
    merge), each fenced inside an `obs.stage` timer, so its bits equal the
    plain plan's."""
    metric = p.metric or index.metric
    exact = index.store.exact

    def run(idx, queries):
        S = idx.shards
        with _obs_stage("sharded", "hash_queries"):
            qh = fence(stages.hash_queries(idx.family, queries))
        views = [idx.local_view(s) for s in range(S)]
        with _obs_stage("sharded", "probe"):
            probed = [fence(_probe_local(v, g, queries, qh, p, S)) for v, g in views]
        with _obs_stage("sharded", "verify"):
            parts = [fence(_verify_local(v, g, ids_l, g_ids, queries, p, metric, S))
                     for (v, g), (ids_l, g_ids, _) in zip(views, probed)]
        with _obs_stage("sharded", "merge"):
            return fence(_merge_global(_pool(parts), queries, p, metric, exact))

    return run


register_topology("sharded", resolve=_sharded_resolve, build=_sharded_build,
                  build_instrumented=_sharded_build_instrumented)


# ---------------------------------------------------------------------------
# The "sharded" candidate source (registry integration)
# ---------------------------------------------------------------------------


@register_source("sharded")
def sharded_source(index, queries, qh, params):
    """Candidate generation over all shards: run `params.inner` per shard
    under the apportioned budget, map local ids to global via the per-shard
    gid arrays, and merge the per-shard top-lambda sets by LCP (exact --
    shards hold disjoint rows).  Returns (ids (B, lam), lcps (B, lam)) with
    global ids, like any source."""
    if not isinstance(index, ShardedLCCSIndex):
        raise TypeError(
            "source='sharded' needs a ShardedLCCSIndex; monolithic LCCSIndex "
            "callers should pick 'lccs'/'bruteforce'/'multiprobe-*'"
        )
    probed = [_probe_local(*index.local_view(s), queries, qh, params, index.shards)
              for s in range(index.shards)]
    _, all_g, all_l = _pool(probed)
    return stages.merge_candidates(all_g, all_l, params.lam)
