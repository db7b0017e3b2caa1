"""Brute-force LCCS scoring: longest circular run of matches per row
(PyTorch port of `repro.core.bruteforce`).

|LCCS(T, Q)| equals the longest circular run of 1s in the element-wise match
vector (T == Q).  Scoring and ranking go through `circrun_topk`: on a CUDA
tensor the hand-written scorer and select kernels, which never write the
(B, n) lengths; on a CPU tensor its plain version (`circrun_ref` +
`topk_largest_lcp`), in chunks of queries that bound the (Bc, n) int32
lengths to 256 MB.
"""
from __future__ import annotations

import torch

from ..kernels.circrun import circrun, circrun_topk
from .search import _pad_lam

# (queries, rows) lengths one chunk of the CPU route may hold: 256 MB of
# int32, and twice that in the int64 ranking keys of `topk_largest_lcp`
_LENS_ELEMS = 1 << 26


def circ_run_lengths(h: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """h: (n, m) int32, q: (m,) int32 -> (n,) int32 LCCS lengths: the
    `circrun` kernel on a CUDA tensor, its plain version on a CPU tensor."""
    return circrun(h, q)


def circ_topk(h: torch.Tensor, q_hash: torch.Tensor, k: int, ok: torch.Tensor | None = None):
    """Top-k LCCS lengths of the rows of h per query, ties to the lower row
    (the `lax.top_k` contract).  Rows where `ok` is False score -1.
    Returns (vals, rows): (B, k) int32 each, k <= n."""
    if h.device.type != "cpu":  # the kernels chunk the queries themselves
        return circrun_topk(h, q_hash, k, ok)
    n = h.shape[0]
    B = q_hash.shape[0]
    vals = torch.empty((B, k), dtype=torch.int32)
    rows = torch.empty((B, k), dtype=torch.int32)
    step = max(1, _LENS_ELEMS // max(1, n))
    for lo in range(0, B, step):
        vals[lo:lo + step], rows[lo:lo + step] = circrun_topk(h, q_hash[lo:lo + step], k, ok)
    return vals, rows


def bruteforce_topk(h: torch.Tensor, q_hash: torch.Tensor, lam: int):
    """Score every database string against each query; return top-lam
    ids/lcps (B, lam) int32, ties to the lower id, -1 padded past n."""
    vals, ids = circ_topk(h, q_hash, min(lam, h.shape[0]))
    return _pad_lam(ids, vals, lam)
