"""Plain PyTorch version of the int8 gather + dequantize + distance kernel
(port of `repro.kernels.gather_q.ref`)."""
from __future__ import annotations

import torch

from ..gather_l2.ref import _dist


def gather_dist_q_ref(codes: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor,
                      queries: torch.Tensor, *, metric: str = "euclidean") -> torch.Tensor:
    """codes (n, d) int8, scale (n,) f32, ids (B, L) int32 (negatives read
    row 0), queries (B, d) f32 -> (B, L) f32 on the dequantized rows."""
    safe = torch.clamp(ids, min=0).long()
    cand = codes[safe].to(torch.float32) * scale[safe][..., None]  # (B, L, d)
    return _dist(cand, queries, metric)
