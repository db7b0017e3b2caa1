"""Public wrapper for fp32 candidate verification (port of
`repro.kernels.gather_l2.ops`): the hand-written kernel
(`csrc/gather.cu`, `gather_l2_launch`) on CUDA tensors, its plain version
(`ref.gather_dist_ref`) on CPU tensors."""
from __future__ import annotations

import torch

from .. import common
from .ref import gather_dist_ref

METRICS = ("euclidean", "angular")


def gather_dist_kernel(data, ids, queries, *, metric: str = "euclidean") -> torch.Tensor:
    """The kernel's own output: (B, L) f32, negative ids read row 0 (no mask)."""
    if data.device.type == "cpu":
        return gather_dist_ref(data, ids, queries, metric=metric)
    if data.device.type != "cuda":
        raise ValueError(f"gather_l2: unsupported device {data.device}")
    if metric not in METRICS:
        raise ValueError(f"gather_l2: metric {metric!r} not in {METRICS}")
    n, d = data.shape
    B, Lc = ids.shape
    dev = data.device
    common.check("data", data, device=dev, dtype=torch.float32, shape=(n, d))
    common.check("ids", ids, device=dev, dtype=torch.int32, shape=(B, Lc))
    common.check("queries", queries, device=dev, dtype=torch.float32, shape=(B, d))
    out = torch.empty((B, Lc), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    common.launch("gather_l2", "gather_l2_launch", data.data_ptr(), ids.data_ptr(),
                  queries.data_ptr(), out.data_ptr(), n, d, B, Lc, int(metric == "angular"))
    return out


def gather_dist(data, ids, queries, *, metric: str = "euclidean") -> torch.Tensor:
    """Distances of candidates `ids` to `queries`; masked (id < 0) slots ->
    +inf.  Euclidean distances are *squared*."""
    d = gather_dist_kernel(data, ids, queries, metric=metric)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))
