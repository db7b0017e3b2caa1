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
