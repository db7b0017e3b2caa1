"""Circular Shift Array (CSA) -- the paper's data structure (Algorithm 1),
PyTorch port of `repro.core.csa`: the monolithic build and the out-of-core
one.

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

Out-of-core construction (`build_csa_chunked`, `csa_from_chunk_ranks`):
the rows are ranked per chunk on the device (`circular_ranks` of a
(chunk, m) slab), and the per-chunk sorted orders are merged on the host,
per shift, by a stable packed-prefix radix pass whose ties are finished
from the chunk ranks -- numpy, the reference's code.  Both builds realise
the unique stable lexicographic sort of the circular strings (ties by row
id), so the chunked tables are bit-identical to `build_csa`'s for every
chunk size.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..obs.trace import fence, span
from .device import resolve_device


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


# ---------------------------------------------------------------------------
# Out-of-core construction: per-chunk device ranks + host merge
# ---------------------------------------------------------------------------

# symbols compared per host LCP round: the first mismatch is found within
# the first window for random hashes, and the slab stays O(n * 16)
_LCP_WINDOW = 16


def _pack_window(h: np.ndarray, rows, i: int, depth: int, pack: int,
                 vmin: int, bits: int) -> np.ndarray:
    """uint64 keys packing `pack` symbols of the shift-i circular strings,
    starting `depth` symbols in, for the given rows (None = all rows).
    Comparing packed keys == comparing those symbols lexicographically."""
    m = h.shape[1]
    cols = (i + depth + np.arange(pack)) % m
    sym = h[:, cols] if rows is None else h[np.ix_(rows, cols)]
    key = np.zeros(sym.shape[0], np.uint64)
    shift = np.uint64(bits)
    for t in range(pack):
        key = (key << shift) | (sym[:, t].astype(np.int64) - vmin).astype(np.uint64)
    return key


def _merge_shift(h: np.ndarray, rank_i: np.ndarray, chunk_of: np.ndarray,
                 i: int, vmin: int, bits: int, pack: int) -> np.ndarray:
    """Merge the per-chunk sorted orders of shift i into the global stable
    lexicographic order (id tie-break) -- equal to the stable argsort of
    `circular_ranks(h)[:, i]` over the whole array.

    One stable radix pass over packed symbol prefixes, then tie-block
    refinement: a tie block wholly inside one chunk is finished from the
    chunk ranks (`rank_i`: within a chunk the dense rank orders full
    circular strings, and equal ranks mean equal strings, whose ascending
    ids the stable sort keeps); a cross-chunk block extends the comparison
    by `pack` more symbols until it resolves or the depth reaches m, where
    its strings are equal and the kept id order is the monolithic one.
    Every step is a stable refinement of the same key, so the permutation
    is unique."""
    n, m = h.shape
    key0 = _pack_window(h, None, i, 0, pack, vmin, bits)
    order = np.argsort(key0, kind="stable")
    sk = key0[order]
    blk = np.cumsum(np.r_[True, sk[1:] != sk[:-1]]) - 1
    counts = np.bincount(blk)
    active = counts[blk] > 1
    del key0, sk, counts
    depth = pack
    while active.any() and depth < m:
        pos = np.flatnonzero(active)  # ascending => blk[pos] non-decreasing
        b = blk[pos]
        rows = order[pos]
        c = chunk_of[rows]
        starts = np.flatnonzero(np.r_[True, b[1:] != b[:-1]])
        block_idx = np.cumsum(np.r_[True, b[1:] != b[:-1]]) - 1
        same = (np.minimum.reduceat(c, starts)
                == np.maximum.reduceat(c, starts))[block_idx]
        if same.any():
            sp = pos[same]
            rws = rows[same]
            # stable by (block, chunk rank): finishes the block exactly
            perm = np.lexsort((rank_i[rws], b[same]))
            order[sp] = rws[perm]
            active[sp] = False
        rem = ~same
        if not rem.any():
            break
        pos, b, rows = pos[rem], b[rem], rows[rem]
        sec = _pack_window(h, rows, i, depth, pack, vmin, bits)
        perm = np.lexsort((sec, b))  # b non-decreasing: permutes within blocks
        rows = rows[perm]
        sec = sec[perm]
        order[pos] = rows
        split = np.r_[True, (b[1:] != b[:-1]) | (sec[1:] != sec[:-1])]
        nb = np.cumsum(split) - 1
        ncounts = np.bincount(nb)
        blk[pos] = nb
        active[pos] = ncounts[nb] > 1
        depth += pack
    return order.astype(np.int32)


def _adjacent_lcp_host(h: np.ndarray, order: np.ndarray, i: int) -> np.ndarray:
    """Host equivalent of one `_adjacent_lcp` shift: L[p] = |lcp| (capped at
    m) of the shift-i strings at sorted positions p, p+1; L[n-1] = 0.
    Round-based with a shrinking active set -- the transient is one
    (active, window) symbol slab, never an (n, m) gather."""
    n, m = h.shape
    lcp = np.full(n, m, np.int32)
    lcp[n - 1] = 0
    act = np.arange(n - 1)
    depth = 0
    while act.size and depth < m:
        w = min(_LCP_WINDOW, m - depth)
        cols = (i + depth + np.arange(w)) % m
        sa = h[np.ix_(order[act], cols)]
        sb = h[np.ix_(order[act + 1], cols)]
        neq = sa != sb
        hit = neq.any(axis=1)
        lcp[act[hit]] = depth + np.argmax(neq[hit], axis=1)
        act = act[~hit]
        depth += w
    return lcp


def csa_from_chunk_ranks(h: np.ndarray, chunk_sizes: list[int], chunk_ranks: list,
                         *, device) -> CSA:
    """Assemble the global CSA on `device` from per-chunk `circular_ranks`
    outputs.

    `h` is the full (n, m) int32 hash matrix on the host; `chunk_ranks[c]`
    (numpy, (size_c, m)) is `circular_ranks` of rows [sum(sizes[:c]),
    sum(sizes[:c+1])) *alone*.  Per shift the chunk orders are merged by
    `_merge_shift` (one chunk: a stable argsort of its ranks) and the
    adjacent-LCP row is built by `_adjacent_lcp_host`.

    Peak memory: the ranks are consumed one (n,) column a shift, never
    concatenated into an (n, m) matrix; `chunk_ranks` is cleared after the
    last shift, before the upload; P is not built on the host (each I row
    is a permutation, so P, its inverse, is scattered on the device); and
    the host tables go to the device one at a time.  The merge and the
    upload are traced as spans `csa.merge` and `csa.upload`
    (`repro_torch.obs.trace`)."""
    h = np.ascontiguousarray(np.asarray(h, np.int32))
    n, m = h.shape
    if n == 0 or sum(chunk_sizes) != n:
        raise ValueError(f"chunk sizes {chunk_sizes} do not cover n={n} rows")
    single = len(chunk_sizes) == 1
    chunk_of = None
    if not single:
        chunk_of = np.repeat(np.arange(len(chunk_sizes), dtype=np.int32), chunk_sizes)
    vmin = int(h.min())
    bits = max(1, int(int(h.max()) - vmin).bit_length())
    pack = max(1, min(m, 64 // bits))
    I = np.empty((m, n), np.int32)
    L = np.empty((m, n), np.int32)
    with span("csa.merge", n=n, chunks=len(chunk_sizes)):
        for i in range(m):
            if single:
                rank_i = np.asarray(chunk_ranks[0], np.int32)[:, i]
                order = np.argsort(rank_i, kind="stable").astype(np.int32)
            else:
                rank_i = np.concatenate(
                    [np.ascontiguousarray(np.asarray(r, np.int32)[:, i]) for r in chunk_ranks]
                )
                order = _merge_shift(h, rank_i, chunk_of, i, vmin, bits, pack)
            I[i] = order
            L[i] = _adjacent_lcp_host(h, order, i)
    if isinstance(chunk_ranks, list):
        chunk_ranks.clear()
    with span("csa.upload"):
        It = torch.from_numpy(I).to(device)
        del I
        pos = torch.arange(n, dtype=torch.int32, device=device).expand(m, n)
        Pt = torch.empty((m, n), dtype=torch.int32, device=device).scatter_(1, It.long(), pos)
        Lt = torch.from_numpy(L).to(device)
        del L
        ht = torch.from_numpy(h).to(device)
        Hd = fence(torch.cat([ht, ht], dim=1).contiguous())
        del ht
    return CSA(I=It, P=Pt, Hd=Hd, L=Lt)


def build_csa_chunked(h, *, chunk_rows: int, device=None) -> CSA:
    """`build_csa`, out of core: rank `chunk_rows`-sized row blocks on
    `device` (None: h's device when h is a tensor, else CUDA) and merge
    the chunk orders on the host.  Bit-identical to `build_csa(h)` for
    every chunk size."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    if isinstance(h, torch.Tensor):
        device = h.device if device is None else device
        h = h.cpu().numpy()
    dev = resolve_device(device)
    h_host = np.ascontiguousarray(np.asarray(h, np.int32))
    n = h_host.shape[0]
    sizes, ranks = [], []
    for s in range(0, n, chunk_rows):
        e = min(s + chunk_rows, n)
        sizes.append(e - s)
        ranks.append(circular_ranks(torch.from_numpy(h_host[s:e]).to(dev)).cpu().numpy())
    return csa_from_chunk_ranks(h_host, sizes, ranks, device=dev)
