"""Plain PyTorch version of the fp32 gather + distance kernel (port of
`repro.kernels.gather_l2.ref`)."""
from __future__ import annotations

import torch


def gather_dist_ref(data: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
                    *, metric: str = "euclidean") -> torch.Tensor:
    """data (n, d) f32, ids (B, L) int32 (negatives read row 0), queries (B, d)
    f32 -> (B, L) f32: squared L2, or 1 - cos with unclamped norms (NaN on a
    zero row, as the kernel)."""
    cand = data[torch.clamp(ids, min=0).long()]  # (B, L, d)
    return _dist(cand, queries, metric)


def _dist(cand: torch.Tensor, queries: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "euclidean":
        return torch.sum((cand - queries[:, None, :]) ** 2, dim=-1)
    if metric == "angular":
        cn = cand / torch.linalg.vector_norm(cand, dim=-1, keepdim=True)
        qn = queries / torch.linalg.vector_norm(queries, dim=-1, keepdim=True)
        return 1.0 - torch.sum(cn * qn[:, None, :], dim=-1)
    raise ValueError(metric)


def rank_ref(dist: torch.Tensor, ids: torch.Tensor, k: int, *, metric: str,
             report_ids: torch.Tensor | None = None, survivors: bool = False):
    """The verify's epilogue over a scan's raw (B, L) output `dist`, as the
    unfused route composes it: ids < 0 -> +inf; Euclidean sqrt(clamp(d,
    min=0)), angular NaN -> 1; then the k smallest per row, ties to the
    lower slot (a stable sort: -0.0 equals +0.0, NaN after +inf), with
    their ids in `report_ids` (default `ids`).

    survivors=False: `topk_ids`' output, (ids, values) (B, k), id -1 where
    the value is not finite, -1 / +inf past L.  survivors=True: the first
    min(k, L) of `_smallest`, (ids, values), no id mapping."""
    inf = torch.full_like(dist, float("inf"))
    d = torch.where(ids >= 0, dist, inf)
    if metric == "euclidean":
        d = torch.sqrt(torch.clamp(d, min=0.0))
    else:
        d = torch.where(torch.isnan(d), torch.ones_like(d), d)
    d = torch.where(ids >= 0, d, inf)
    kk = min(k, ids.shape[1])
    vals, idx = torch.sort(d, dim=1, stable=True)
    vals, idx = vals[:, :kk], idx[:, :kk]
    out = torch.gather(ids if report_ids is None else report_ids, 1, idx)
    if survivors:
        return out, vals
    out = torch.where(torch.isfinite(vals), out, torch.full_like(out, -1))
    if kk < k:
        out = torch.nn.functional.pad(out, (0, k - kk), value=-1)
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=float("inf"))
    return out, vals


def gather_topk_ref(data, ids, queries, k: int, *, metric: str = "euclidean",
                    report_ids=None, survivors: bool = False):
    """Plain version of the fused fp32 verify: `gather_dist_ref`, then
    `rank_ref`."""
    return rank_ref(gather_dist_ref(data, ids, queries, metric=metric), ids, k,
                    metric=metric, report_ids=report_ids, survivors=survivors)
