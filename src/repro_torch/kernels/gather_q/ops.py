"""Public wrappers for quantized candidate verification (port of
`repro.kernels.gather_q.ops`, and of the `lax.top_k` behind it in
`repro.exec.stages.survivors`): the hand-written kernels (`csrc/gather.cu`,
`gather_q_launch` and `gather_q_topk_launch`) on CUDA tensors, their plain
versions (`ref.gather_dist_q_ref`, `ref.gather_topk_q_ref`) on CPU
tensors."""
from __future__ import annotations

import torch

from .. import common
from ..gather_l2.ops import METRICS, topk_launch
from .ref import gather_dist_q_ref, gather_topk_q_ref


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


def gather_topk_q(codes, scale, ids, queries, k: int, *, metric: str = "euclidean",
                  report_ids=None, survivors: bool = False):
    """The int8 verify scan in one pass with its top-k: as
    `gather_l2.ops.gather_topk` on the dequantized rows (`ref.rank_ref` over
    `gather_dist_q_kernel`'s output, bit for bit on the card)."""
    if codes.device.type == "cpu":
        return gather_topk_q_ref(codes, scale, ids, queries, k, metric=metric,
                                 report_ids=report_ids, survivors=survivors)
    if codes.device.type != "cuda":
        raise ValueError(f"gather_q_topk: unsupported device {codes.device}")
    n, d = codes.shape
    dev = codes.device
    common.check("codes", codes, device=dev, dtype=torch.int8, shape=(n, d))
    common.check("scale", scale, device=dev, dtype=torch.float32, shape=(n,))
    return topk_launch("gather_q_topk", "gather_q_topk_launch", (codes, scale), ids, queries,
                       k, metric=metric, report_ids=report_ids, survivors=survivors)
