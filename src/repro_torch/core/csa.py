"""Circular Shift Array (CSA) -- the paper's data structure (Algorithm 1),
PyTorch port of `repro.core.csa` (monolithic build only).

For every circular shift i the n hash strings are sorted; the build is a
prefix-doubling rank construction over the (n, m) hash matrix:

  R^(0)[:, i]   = dense rank of column i
  R^(l+1)[:, i] = dense rank of the pair (R^(l)[:, i], R^(l)[:, (i + 2^l) % m])

After at most ceil(log2 m) rounds R[:, i] orders the circular strings
starting at position i.  All m columns are ranked in one batched sort per
round.

Outputs (all int32, the reference's layout):
  I (m, n): I[i] = stable argsort of shift-i strings (ties by row id)
  P (m, n): P[i, t] = position of string t in I[i]
  Hd (n, 2m): doubled hash matrix for O(1) circular slicing
  L (m, n): adjacent-LCP table: L[i, p] = |lcp| of the sorted neighbours at
            positions p and p+1 of I[i] (L[i, n-1] = 0)

Given the same `h` the tables are bit-identical to the reference's: dense
ranks depend only on values, and the final per-shift argsort is stable.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class CSA:
    I: torch.Tensor  # (m, n) int32 sorted order per shift
    P: torch.Tensor  # (m, n) int32 position of each string per shift
    Hd: torch.Tensor  # (n, 2m) int32 doubled hash strings
    # (m, n) int32 adjacent-LCP per shift; None only for artifacts saved
    # before the table existed (the fused probe then falls back to the
    # legacy window path)
    L: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.I.shape[1]

    @property
    def m(self) -> int:
        return self.I.shape[0]

    def tables(self) -> list:
        """[I, P, Hd, L] in the reference's pickle order."""
        return [self.I, self.P, self.Hd, self.L]


def _dense_rank(keys: torch.Tensor) -> torch.Tensor:
    """Column-wise dense rank (ties share rank) of an (n, c) integer array."""
    order = torch.argsort(keys, dim=0, stable=True)
    sv = torch.gather(keys, 0, order)
    new = torch.zeros_like(sv, dtype=torch.int64)
    new[1:] = (sv[1:] != sv[:-1]).to(torch.int64)
    dense = torch.cumsum(new, dim=0)
    return torch.empty_like(dense).scatter_(0, order, dense)


def _dense_rank_1key(col: torch.Tensor) -> torch.Tensor:
    """Dense rank of each column of an (n, c) int array."""
    return _dense_rank(col).to(torch.int32)


def _dense_rank_2key(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense rank of (a, b) pairs (a primary), column-wise.  Both are dense
    ranks in [0, n), so one int64 key a * 2^32 + b orders the pairs exactly;
    a dense rank does not depend on how equal keys are ordered, so this
    equals the reference's two stable sorts."""
    key = (a.to(torch.int64) << 32) | b.to(torch.int64)
    return _dense_rank(key).to(torch.int32)


def _ranks_distinct(r: torch.Tensor) -> bool:
    """True when every rank column is already a permutation: every further
    doubling round is then a no-op."""
    return int(r.max(dim=0).values.min()) == r.shape[0] - 1


def circular_ranks(h: torch.Tensor) -> torch.Tensor:
    """(n, m) hash matrix -> (n, m) int32 R with R[:, i] the dense rank of the
    circular string starting at position i.  At most ceil(log2 m) doubling
    rounds, exiting early once ranks are distinct."""
    m = h.shape[1]
    r = _dense_rank_1key(h)
    span = 1
    while span < m and not _ranks_distinct(r):
        r2 = torch.roll(r, -span, dims=1)  # r2[:, i] = r[:, (i + span) % m]
        r = _dense_rank_2key(r, r2)
        span *= 2
    return r


def build_csa(h: torch.Tensor) -> CSA:
    """Algorithm 1, vectorised.  h: (n, m) int32 hash strings."""
    h = h.to(torch.int32)
    n, m = h.shape
    r = circular_ranks(h)
    I = torch.argsort(r.t(), dim=1, stable=True)  # (m, n) int64
    pos = torch.arange(n, dtype=torch.int32, device=h.device).expand(m, n)
    P = torch.empty((m, n), dtype=torch.int32, device=h.device).scatter_(1, I, pos)
    I = I.to(torch.int32)
    Hd = torch.cat([h, h], dim=1).contiguous()
    L = _adjacent_lcp(Hd, I)
    return CSA(I=I.contiguous(), P=P, Hd=Hd, L=L)


def first_mismatch(neq: torch.Tensor, m: int) -> torch.Tensor:
    """Index of the first True along the last axis, or m when there is none
    (the reference's `where(any(neq), argmax(neq), m)`), as int32."""
    cols = torch.arange(neq.shape[-1], dtype=torch.int32, device=neq.device)
    big = torch.full((), m, dtype=torch.int32, device=neq.device)
    return torch.where(neq, cols, big).amin(dim=-1).to(torch.int32)


def _adjacent_lcp(Hd: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """L[i, p] = |lcp| (capped at m) of the shift-i circular strings at sorted
    positions p and p+1 of I[i]; L[i, n-1] = 0.  One (n, m) slab per shift."""
    m, n = I.shape
    L = torch.empty((m, n), dtype=torch.int32, device=Hd.device)
    for i in range(m):
        a = Hd[I[i].long(), i:i + m]  # sorted shift-i view
        neq = a != torch.roll(a, -1, dims=0)
        lcp = first_mismatch(neq, m)
        lcp[n - 1] = 0  # roll wraps; last position has no successor
        L[i] = lcp
    return L
