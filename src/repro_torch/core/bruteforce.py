"""Brute-force LCCS scoring: longest circular run of matches per row
(PyTorch port of `repro.core.bruteforce`).

|LCCS(T, Q)| equals the longest circular run of 1s in the element-wise match
vector (T == Q).  Queries are scored one at a time: a batched form would hold
a (B, n, 2m) transient.
"""
from __future__ import annotations

import torch

from .lsh import topk_largest
from .search import _pad_lam


def circ_run_lengths(h: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """h: (n, m) int32, q: (m,) int32 -> (n,) int32 LCCS lengths."""
    n, m = h.shape
    e = h == q[None, :]
    ee = torch.cat([e, e], dim=1)  # (n, 2m)
    j = torch.arange(1, 2 * m + 1, dtype=torch.int32, device=h.device)
    # run length ending at j is j - (position of the most recent mismatch)
    blockers = torch.where(ee, torch.zeros_like(j), j)
    last_block = torch.cummax(blockers, dim=1).values
    runs = j[None, :] - last_block
    return torch.clamp(runs.amax(dim=1), max=m).to(torch.int32)


def bruteforce_topk(h: torch.Tensor, q_hash: torch.Tensor, lam: int):
    """Score every database string against each query; return top-lam
    ids/lcps (B, lam) int32, ties to the lower id, -1 padded past n."""
    n = h.shape[0]
    k = min(lam, n)
    ids, vals = [], []
    for q in q_hash:
        v, i = topk_largest(circ_run_lengths(h, q), k)
        ids.append(i.to(torch.int32))
        vals.append(v)
    return _pad_lam(torch.stack(ids), torch.stack(vals), lam)
