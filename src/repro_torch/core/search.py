"""k-LCCS search over a CSA (paper Algorithm 2): the legacy window path,
PyTorch port of `repro.core.search`.

Two modes:

  * "parallel"  -- all m binary searches run independently (a batch of
                   B * m (query, shift) rows).
  * "narrowed"  -- paper-faithful Corollary 3.2 narrowing: a loop over shifts
                   carries the previous shift's bounds and restricts the next
                   binary search through the next-links P.

Both gather a fixed 2W window around each insertion point, recompute every
window slot's LCP from the doubled hash rows, dedupe by max-LCP per id and
take a global top-lambda (ties to the lower id).  The fused probe
(`repro_torch.kernels.csa_probe`) returns bit-identical results from the
adjacent-LCP table instead.

Functions here are batched over rows: a "row" is one (probe string, shift)
pair, `qd` holds doubled probe strings (R, 2m) and `i` the shifts (R,).
"""
from __future__ import annotations

import torch

from .csa import CSA, first_mismatch
from .lsh import topk_largest

# elements of the (rows, 2W, m) window slab gathered per chunk of rows
_WINDOW_SLAB = 1 << 25


def doubled(q_hash: torch.Tensor) -> torch.Tensor:
    """(R, m) hash strings -> (R, 2m) int32 doubled strings."""
    return torch.cat([q_hash, q_hash], dim=1).to(torch.int32)


def _shift_cols(i: torch.Tensor, m: int) -> torch.Tensor:
    """(R,) shifts -> (R, m) int64 column indices i .. i+m-1 into a doubled row."""
    return i.long()[:, None] + torch.arange(m, device=i.device)


def _lcp_and_less(a: torch.Tensor, b: torch.Tensor, m: int):
    """Compare shift-aligned strings row by row: a, b (R, m) data / query
    symbols.  Returns (lcp (R,) int32, data_less_than_query (R,) bool)."""
    neq = a != b
    lcp = first_mismatch(neq, m)
    f = torch.clamp(lcp, max=m - 1).long()[:, None]  # first mismatch (any if none)
    less = (lcp < m) & (torch.gather(a, 1, f) < torch.gather(b, 1, f))[:, 0]
    return lcp, less


def _row_lcp_less(csa: CSA, t: torch.Tensor, qd: torch.Tensor, i: torch.Tensor):
    """(lcp, less) of data rows t (R,) against the doubled probes qd at shifts i."""
    m = csa.m
    cols = _shift_cols(i, m)
    a = csa.Hd[t.long()[:, None], cols]
    b = torch.gather(qd, 1, cols)
    return _lcp_and_less(a, b, m)


def _insertion_pos(csa: CSA, qd: torch.Tensor, i: torch.Tensor,
                   lo0: torch.Tensor, hi0: torch.Tensor) -> torch.Tensor:
    """Lower-bound binary search: #strings (within [lo0, hi0)) whose shift-i
    circular string sorts strictly before the query's.  Fixed bit_length(n)
    steps, as the reference."""
    n = csa.n
    steps = max(1, n.bit_length())
    lo, hi = lo0.to(torch.int32), hi0.to(torch.int32)
    il = i.long()
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        t = csa.I[il, torch.clamp(mid, 0, n - 1).long()]
        _, less = _row_lcp_less(csa, t, qd, i)
        take = (mid < hi) & less
        lo = torch.where(take, mid + 1, lo)
        hi = torch.where(take, hi, torch.minimum(hi, mid))
    return lo


def _window(csa: CSA, qd: torch.Tensor, i: torch.Tensor, pos: torch.Tensor, width: int):
    """Gather the 2*width window of sorted positions around insertion point
    `pos` in I_i and compute each candidate's LCP with the shift-i query.
    Returns (ids (R, 2W), lcps (R, 2W)) int32."""
    n, m = csa.n, csa.m
    offs = torch.arange(-width, width, dtype=torch.int32, device=qd.device)
    ps = torch.clamp(pos[:, None] + offs, 0, n - 1).long()  # (R, 2W)
    ids = csa.I[i.long()[:, None], ps]  # (R, 2W)
    cols = _shift_cols(i, m)  # (R, m)
    rows = csa.Hd[ids.long()[:, :, None], cols[:, None, :]]  # (R, 2W, m)
    b = torch.gather(qd, 1, cols)[:, None, :]
    lcps = first_mismatch(rows != b, m)
    # clipped duplicate window slots (pos at array edges) are deduped later
    return ids, lcps


def _chunks(R: int, width: int, m: int):
    step = max(1, _WINDOW_SLAB // max(1, 2 * width * m))
    for lo in range(0, R, step):
        yield slice(lo, min(lo + step, R))


def _search_rows(csa: CSA, qd: torch.Tensor, i: torch.Tensor, width: int):
    """Insertion search + window over a full-range worklist of rows."""
    R = qd.shape[0]
    ids = torch.empty((R, 2 * width), dtype=torch.int32, device=qd.device)
    lcps = torch.empty_like(ids)
    for s in _chunks(R, width, csa.m):
        zero = torch.zeros_like(i[s], dtype=torch.int32)
        pos = _insertion_pos(csa, qd[s], i[s], zero, zero + csa.n)
        ids[s], lcps[s] = _window(csa, qd[s], i[s], pos, width)
    return ids, lcps


def dedupe_topk(ids: torch.Tensor, lcps: torch.Tensor, lam: int):
    """Max-LCP per id, then global top-lam, per row of (B, pool) arrays.
    Two stable sorts, as the reference; ties go to the lower id."""
    p1 = torch.argsort(-lcps, dim=1, stable=True)
    p2 = torch.argsort(torch.gather(ids, 1, p1), dim=1, stable=True)
    order = torch.gather(p1, 1, p2)
    si, sl = torch.gather(ids, 1, order), torch.gather(lcps, 1, order)
    first = torch.ones_like(si, dtype=torch.bool)
    first[:, 1:] = si[:, 1:] != si[:, :-1]
    score = torch.where(first & (si >= 0), sl, torch.full_like(sl, -1))
    k = min(lam, score.shape[1])
    vals, idxs = topk_largest(score, k)
    out_ids = torch.where(vals >= 0, torch.gather(si, 1, idxs), torch.full_like(vals, -1))
    return _pad_lam(out_ids.to(torch.int32), vals.to(torch.int32), lam)


def _pad_lam(ids: torch.Tensor, vals: torch.Tensor, lam: int):
    k = ids.shape[1]
    if k < lam:  # pad to lam
        pad = (0, lam - k)
        ids = torch.nn.functional.pad(ids, pad, value=-1)
        vals = torch.nn.functional.pad(vals, pad, value=-1)
    return ids, vals


def _all_shifts(B: int, m: int, device):
    """Worklist of every (query, shift) pair, query-major: (qidx, shifts)."""
    shifts = torch.arange(m, dtype=torch.int32, device=device).repeat(B)
    qidx = torch.arange(B, dtype=torch.int64, device=device).repeat_interleave(m)
    return qidx, shifts


def _parallel_windows(csa: CSA, q_hash: torch.Tensor, width: int):
    B, m = q_hash.shape
    qd = doubled(q_hash)
    qidx, shifts = _all_shifts(B, m, q_hash.device)
    ids, lcps = _search_rows(csa, qd[qidx], shifts, width)
    return ids.reshape(B, m, -1), lcps.reshape(B, m, -1)


def _search_narrowed(csa: CSA, q_hash: torch.Tensor, lam: int, width: int):
    n, m = csa.n, csa.m
    B = q_hash.shape[0]
    dev = q_hash.device
    qd = doubled(q_hash)
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    pos, len_l, len_u = zero, zero, zero
    out_ids, out_lcps = [], []
    for i in range(m):
        ii = torch.full((B,), i, dtype=torch.int32, device=dev)
        # Corollary 3.2 narrowing (see the reference for the tie caveat)
        ok = (len_l >= 1) & (len_u >= 1) & (i > 0) & (pos > 0) & (pos < n)
        prev = (i - 1) % m
        t_l = csa.I[prev, torch.clamp(pos - 1, 0, n - 1).long()]
        t_u = csa.I[prev, torch.clamp(pos, 0, n - 1).long()]
        lo0 = torch.where(ok, csa.P[i, t_l.long()], zero)
        hi0 = torch.where(ok, csa.P[i, t_u.long()] + 1, zero + n)
        new_pos = _insertion_pos(csa, qd, ii, lo0, hi0)
        len_l, _ = _row_lcp_less(csa, csa.I[i, torch.clamp(new_pos - 1, 0, n - 1).long()], qd, ii)
        len_u, _ = _row_lcp_less(csa, csa.I[i, torch.clamp(new_pos, 0, n - 1).long()], qd, ii)
        ids, lcps = _window(csa, qd, ii, new_pos, width)
        out_ids.append(ids)
        out_lcps.append(lcps)
        pos = new_pos
    ids = torch.stack(out_ids, dim=1).reshape(B, -1)
    lcps = torch.stack(out_lcps, dim=1).reshape(B, -1)
    return dedupe_topk(ids, lcps, lam)


def klccs_search(csa: CSA, q_hash: torch.Tensor, lam: int, width: int = 16,
                 mode: str = "parallel"):
    """Batched k-LCCS search.  q_hash: (B, m) int32.  Returns (ids, lcps):
    (B, lam) int32 each; ids are -1-padded when fewer than lam distinct
    candidates exist."""
    if mode != "parallel":
        return _search_narrowed(csa, q_hash, lam, width)
    ids, lcps = _parallel_windows(csa, q_hash, width)
    B = q_hash.shape[0]
    return dedupe_topk(ids.reshape(B, -1), lcps.reshape(B, -1), lam)


def klccs_search_with_lens(csa: CSA, q_hash: torch.Tensor, lam: int, width: int = 16):
    """Batched parallel search returning (ids, lcps, per-shift max LCP (B, m)).
    The len array feeds the §4.2 skip-unaffected-positions probe pruning."""
    ids, lcps = _parallel_windows(csa, q_hash, width)
    B = q_hash.shape[0]
    maxlen = lcps.amax(dim=2)
    out_ids, out_lcps = dedupe_topk(ids.reshape(B, -1), lcps.reshape(B, -1), lam)
    return out_ids, out_lcps, maxlen


def klccs_search_pairs(csa: CSA, probe_hashes: torch.Tensor, shifts: torch.Tensor,
                       valid: torch.Tensor, width: int = 16):
    """Search ONE shift per (probe, shift) pair -- the worklist form of
    MP-LCCS-LSH with unaffected positions skipped (paper §4.2).
    Returns (ids (R, 2W), lcps (R, 2W)), invalid rows masked to -1."""
    ids, lcps = _search_rows(csa, doubled(probe_hashes), shifts.to(torch.int32), width)
    keep = valid[:, None]
    return (torch.where(keep, ids, torch.full_like(ids, -1)),
            torch.where(keep, lcps, torch.full_like(lcps, -1)))
