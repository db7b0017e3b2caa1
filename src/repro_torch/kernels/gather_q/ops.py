"""Public wrapper for quantized candidate verification (port of
`repro.kernels.gather_q.ops`): the hand-written kernel (`csrc/gather.cu`,
`gather_q_launch`) on CUDA tensors, its plain version
(`ref.gather_dist_q_ref`) on CPU tensors."""
from __future__ import annotations

import torch

from .. import common
from ..gather_l2.ops import METRICS
from .ref import gather_dist_q_ref


def gather_dist_q_kernel(codes, scale, ids, queries, *,
                         metric: str = "euclidean") -> torch.Tensor:
    """The kernel's own output: (B, L) f32, negative ids read row 0 (no mask)."""
    if codes.device.type == "cpu":
        return gather_dist_q_ref(codes, scale, ids, queries, metric=metric)
    if codes.device.type != "cuda":
        raise ValueError(f"gather_q: unsupported device {codes.device}")
    if metric not in METRICS:
        raise ValueError(f"gather_q: metric {metric!r} not in {METRICS}")
    n, d = codes.shape
    B, Lc = ids.shape
    dev = codes.device
    common.check("codes", codes, device=dev, dtype=torch.int8, shape=(n, d))
    common.check("scale", scale, device=dev, dtype=torch.float32, shape=(n,))
    common.check("ids", ids, device=dev, dtype=torch.int32, shape=(B, Lc))
    common.check("queries", queries, device=dev, dtype=torch.float32, shape=(B, d))
    out = torch.empty((B, Lc), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    common.launch("gather_q", "gather_q_launch", codes.data_ptr(), scale.data_ptr(),
                  ids.data_ptr(), queries.data_ptr(), out.data_ptr(), n, d, B, Lc,
                  int(metric == "angular"))
    return out


def gather_dist_q(codes, scale, ids, queries, *, metric: str = "euclidean") -> torch.Tensor:
    """Dequantized distances of int8 candidates `ids` to `queries`; masked
    (id < 0) slots -> +inf.  Euclidean distances are *squared*."""
    d = gather_dist_q_kernel(codes, scale, ids, queries, metric=metric)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))
