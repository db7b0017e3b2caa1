"""Public wrappers for fp32 candidate verification (port of
`repro.kernels.gather_l2.ops`, and of the `lax.top_k` behind it in
`repro.exec.stages`): the hand-written kernels (`csrc/gather.cu`,
`gather_l2_launch` and `gather_l2_topk_launch`) on CUDA tensors, their plain
versions (`ref.gather_dist_ref`, `ref.gather_topk_ref`) on CPU tensors."""
from __future__ import annotations

import torch

from .. import common
from .ref import gather_dist_ref, gather_topk_ref

METRICS = ("euclidean", "angular")
# keys one block of the fused entries sorts (csrc/gather.cu, kMaxTile): a
# longer candidate row is sorted in tiles of this many and merged
TOPK_TILE = 8192


def _check_metric(kernel: str, metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"{kernel}: metric {metric!r} not in {METRICS}")


def gather_dist_kernel(data, ids, queries, *, metric: str = "euclidean") -> torch.Tensor:
    """The kernel's own output: (B, L) f32, negative ids read row 0 (no mask)."""
    if data.device.type == "cpu":
        return gather_dist_ref(data, ids, queries, metric=metric)
    if data.device.type != "cuda":
        raise ValueError(f"gather_l2: unsupported device {data.device}")
    _check_metric("gather_l2", metric)
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


def topk_launch(kernel: str, entry: str, rows: tuple, ids, queries, k: int, *, metric: str,
                report_ids, survivors: bool):
    """Check the fused entries' common arguments, allocate their outputs,
    and launch `entry` over the store's `rows` pointers (fp32 data, or int8
    codes and scales): the (B, k) ids and values of `ref.rank_ref`, with
    min(k, L) columns in survivors mode.  No launch without a column or a
    candidate to rank."""
    _check_metric(kernel, metric)
    B, L = ids.shape
    n, d = rows[0].shape
    dev = ids.device
    report = ids if report_ids is None else report_ids
    common.check("ids", ids, device=dev, dtype=torch.int32, shape=(B, L))
    if report is not ids:
        common.check("report_ids", report, device=dev, dtype=torch.int32, shape=(B, L))
    common.check("queries", queries, device=dev, dtype=torch.float32, shape=(B, d))
    if k < 0:
        raise ValueError(f"{kernel}: k must be >= 0, got {k}")
    cols = min(k, L) if survivors else k
    if B == 0 or L == 0 or cols == 0:
        return (torch.full((B, cols), -1, dtype=torch.int32, device=dev),
                torch.full((B, cols), float("inf"), dtype=torch.float32, device=dev))
    out_ids = torch.empty((B, cols), dtype=torch.int32, device=dev)
    out_vals = torch.empty((B, cols), dtype=torch.float32, device=dev)
    lp = 1 << (L - 1).bit_length()
    keys = torch.empty((B, lp), dtype=torch.int64, device=dev) if lp > TOPK_TILE else None
    common.launch(kernel, entry, *(t.data_ptr() for t in rows), ids.data_ptr(),
                  report.data_ptr(), queries.data_ptr(), out_ids.data_ptr(),
                  out_vals.data_ptr(), None if keys is None else keys.data_ptr(), n, d, B, L,
                  cols, TOPK_TILE, int(metric == "angular"), int(not survivors))
    return out_ids, out_vals


def gather_topk(data, ids, queries, k: int, *, metric: str = "euclidean", report_ids=None,
                survivors: bool = False):
    """The fp32 verify in one pass: the scan of `gather_dist_kernel`, its
    mask and the store's epilogue, then the k nearest per query, as
    `ref.rank_ref` defines them (`exec.stages.topk_ids`' output over
    `report_ids`, or with survivors=True `stages.survivors`' (ids, values)).
    On CUDA tensors one launch for a row of up to TOPK_TILE candidates;
    the output equals `gather_dist_kernel` + the plain epilogue bit for
    bit."""
    if data.device.type == "cpu":
        return gather_topk_ref(data, ids, queries, k, metric=metric, report_ids=report_ids,
                               survivors=survivors)
    if data.device.type != "cuda":
        raise ValueError(f"gather_l2_topk: unsupported device {data.device}")
    n, d = data.shape
    common.check("data", data, device=data.device, dtype=torch.float32, shape=(n, d))
    return topk_launch("gather_l2_topk", "gather_l2_topk_launch", (data,), ids, queries, k,
                       metric=metric, report_ids=report_ids, survivors=survivors)
