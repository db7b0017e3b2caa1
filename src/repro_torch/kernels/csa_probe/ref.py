"""Plain PyTorch version of the fused CSA probe (port of
`repro.kernels.csa_probe.ref`).

The legacy window path (`repro_torch.core.search._window`) gathers 2W full
doubled hash rows per (query, shift) and recomputes every candidate's LCP.
The fused form uses the sorted-order identity

    lcp(a, c) = min(lcp(a, b), lcp(b, c))      for a <= b <= c

over the CSA's adjacent-LCP table ``L``: only the two *boundary* candidates
at the insertion position are compared with the query; every other window
slot's LCP is a running min of ``L`` entries walking away from the boundary.
The output is bit-identical to `_window`.

`csa_probe_plain` is the CUDA kernel's plain version (same arguments, same
outputs); the kernel wrapper calls it for CPU tensors, and the on-card
checks hold the kernel against it.

`pool_topk_plain` is the plain version of the pool top-lam kernel
(`csrc/pool_topk.cu`): max-LCP per id, then the top lam with ties to the
smaller id, over the probe pool only, tile by tile as the kernel does it.
`dedupe_topk_scatter` is the counterpart of the reference's function of that
name: a scatter-max into an (n,)-slot buffer per query, then one top-lam.
All three forms match `core.search.dedupe_topk` exactly (ids, values and
order).
"""
from __future__ import annotations

import torch

from ...core.csa import CSA
from ...core.lsh import topk_largest_lcp
from ...core.search import _insertion_pos, _pad_lam, _row_lcp_less, dedupe_topk

# worklist rows per chunk of the plain probe (bounds its transients)
_ROWS = 1 << 16
# buffer entries per chunk of the scatter-max dedupe
_BUF = 1 << 27
# pool entries of one tile of the pool top-lam, or half as many where ids
# reach 2^23 and take 8-byte keys; a tile is widened to 2k entries where k =
# min(lam, n) is larger.  The kernel holds a tile in registers and dedupes
# only the entries whose lcp can reach its top k into a table sized for
# them, so a tile of 16,384 entries fits (the table's capacity, for a tile
# whose cut lies at lcp 0, is 1.25 x its entries: 80 KB of 4-byte keys).
# One launch for the lccs pool (12,800 entries at m 64, W 100) and the
# serving pool (4,096 at m 32, W 64); a tile pass and one merge for a
# multiprobe-skip pool (106,496 entries at 17 probes, W 64: 7 tiles).
POOL_TILE = 16384
WIDE_IDS = 1 << 23


def window_from_adjacent(csa: CSA, qd_r: torch.Tensor, i: torch.Tensor,
                         pos: torch.Tensor, width: int):
    """LCPs of the 2W-slot window around insertion positions `pos` (R,) in
    I[i], from the adjacent-LCP table.  qd_r: (R, 2m) doubled probe strings.
    Returns (ids (R, 2W), lcps (R, 2W)) == `core.search._window`."""
    n, m = csa.n, csa.m
    dev = qd_r.device
    il = i.long()[:, None]
    pos_c = pos[:, None]
    offs = torch.arange(-width, width, dtype=torch.int32, device=dev)
    ps = torch.clamp(pos_c + offs, 0, n - 1)  # (R, 2W) window sorted positions
    ids = csa.I[il, ps.long()]

    # boundary LCPs: the only two full string comparisons of the window
    t_l = csa.I[i.long(), torch.clamp(pos - 1, 0, n - 1).long()]
    t_u = csa.I[i.long(), torch.clamp(pos, 0, n - 1).long()]
    lcp_l, _ = _row_lcp_less(csa, t_l, qd_r, i)
    lcp_u, _ = _row_lcp_less(csa, t_u, qd_r, i)

    jj = torch.arange(width, dtype=torch.int32, device=dev)
    big = torch.full((), m, dtype=torch.int32, device=dev)
    # down chain: lcp(q, sorted[pos-1-j]) = min(lcp_l, L[pos-2], .., L[pos-1-j])
    p_down = pos_c - 2 - jj
    adj_down = torch.where(p_down >= 0, csa.L[il, torch.clamp(p_down, 0, n - 1).long()], big)
    # up chain: lcp(q, sorted[pos+j]) = min(lcp_u, L[pos], .., L[pos+j-1])
    p_up = pos_c + jj
    adj_up = torch.where(p_up <= n - 2, csa.L[il, torch.clamp(p_up, 0, n - 1).long()], big)
    down = torch.minimum(lcp_l[:, None], _exclusive_min(adj_down, m))
    up = torch.minimum(lcp_u[:, None], _exclusive_min(adj_up, m))
    lcps = torch.where(
        ps >= pos_c,
        torch.gather(up, 1, torch.clamp(ps - pos_c, 0, width - 1).long()),
        torch.gather(down, 1, torch.clamp(pos_c - 1 - ps, 0, width - 1).long()),
    ).to(torch.int32)
    return ids, lcps


def _exclusive_min(adj: torch.Tensor, m: int) -> torch.Tensor:
    """out[:, 0] = m, out[:, j] = min(adj[:, :j])."""
    run = torch.cummin(adj, dim=1).values
    return torch.cat([torch.full_like(run[:, :1], m), run[:, :-1]], dim=1)


def probe_pairs_ref(csa: CSA, qd: torch.Tensor, shifts: torch.Tensor, width: int):
    """Worklist form: one (probe string, shift) pair per row.
    qd: (R, 2m) doubled probe strings; shifts: (R,).
    Returns (ids (R, 2W), lcps (R, 2W)) int32."""
    R = qd.shape[0]
    ids = torch.empty((R, 2 * width), dtype=torch.int32, device=qd.device)
    lcps = torch.empty_like(ids)
    shifts = shifts.to(torch.int32)
    for lo in range(0, R, _ROWS):
        s = slice(lo, min(lo + _ROWS, R))
        zero = torch.zeros_like(shifts[s])
        pos = _insertion_pos(csa, qd[s], shifts[s], zero, zero + csa.n)
        ids[s], lcps[s] = window_from_adjacent(csa, qd[s], shifts[s], pos, width)
    return ids, lcps


def csa_probe_plain(I, L, Hd, qd, shifts, qidx, width: int):
    """The kernel's plain version: row r searches shift `shifts[r]` for probe
    string `qd[qidx[r]]`.  Returns (ids (R, 2W), lcps (R, 2W)) int32."""
    csa = CSA(I=I, P=None, Hd=Hd, L=L)  # the probe never reads P
    return probe_pairs_ref(csa, qd[qidx.long()], shifts, width)


def search_windows_ref(csa: CSA, qd: torch.Tensor, width: int):
    """Full-shift form: all m shifts of every query.
    qd: (B, 2m).  Returns (ids (B, m, 2W), lcps (B, m, 2W))."""
    B, m = qd.shape[0], csa.m
    shifts = torch.arange(m, dtype=torch.int32, device=qd.device).repeat(B)
    rows = qd.repeat_interleave(m, dim=0)
    ids, lcps = probe_pairs_ref(csa, rows, shifts, width)
    return ids.reshape(B, m, -1), lcps.reshape(B, m, -1)


def dedupe_topk_scatter(ids: torch.Tensor, lcps: torch.Tensor, n: int, lam: int):
    """Max-LCP per id + global top-lam via scatter-max into an (n,) buffer
    per query.  Bit-identical to `core.search.dedupe_topk` (set, values and
    order).  ids/lcps: (B, pool); -1-padded slots are dropped.

    Top-lam ties must go to the lower id (the buffer is full of ties), which
    `torch.topk` does not promise: `topk_largest_lcp` ranks unique keys."""
    B = ids.shape[0]
    k = min(lam, n)
    dev = ids.device
    out_ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    vals = torch.empty((B, k), dtype=torch.int32, device=dev)
    step = max(1, _BUF // (n + 1))
    for lo in range(0, B, step):
        s = slice(lo, min(lo + step, B))
        idc = ids[s].long()
        safe = torch.where(idc >= 0, idc, n)  # -1 padding -> slot n -> dropped
        buf = torch.full((idc.shape[0], n + 1), -1, dtype=torch.int32, device=dev)
        buf.scatter_reduce_(1, safe, lcps[s].to(torch.int32), reduce="amax")
        v, idx = topk_largest_lcp(buf[:, :n], k)
        del buf
        out_ids[s] = torch.where(v >= 0, idx, torch.full_like(idx, -1))
        vals[s] = v
    return _pad_lam(out_ids, vals, lam)


def pool_chunk(k: int, n: int, tile: int | None = None) -> int:
    """Pool entries of one tile of the pool top-k over ids in [0, n): `tile`
    (default POOL_TILE, half that for n > WIDE_IDS), widened to 2k so that
    each merge at least halves the pool."""
    if tile is None:
        tile = POOL_TILE if n <= WIDE_IDS else POOL_TILE // 2
    return max(tile, 2 * k)


def pool_levels(pool: int, k: int, n: int, tile: int | None = None) -> list:
    """Pool lengths of the successive tile passes of the pool top-k: each
    pass cuts its pool into tiles of `pool_chunk(k, n, tile)` entries and
    keeps each tile's top k, until one tile holds the pool.  Its length is
    the number of kernel launches (for a non-empty batch and pool)."""
    chunk = pool_chunk(k, n, tile)
    out = [pool]
    while pool > chunk:
        pool = -(-pool // chunk) * k
        out.append(pool)
    return out


def pool_cut_stats(ids: torch.Tensor, lcps: torch.Tensor, n: int, lam: int):
    """What the pool top-lam kernel's band filter rests on, per row of a
    (B, pool) probe pool with k = min(lam, n): the cut lcp c* (the max lcp of
    the last id the row's top k holds, -1 for a row without an id), the
    distinct ids with max lcp >= c*, the entries with lcp >= c*, and the
    row's distinct ids.  Entries whose id or lcp is < 0 are dropped, lcps
    above 256 count as 256.  Returns four (B,) int64 tensors."""
    B = ids.shape[0]
    k = min(lam, n)
    live = (ids >= 0) & (lcps >= 0)
    lcp = torch.clamp(lcps.long(), max=256)
    key = torch.where(live, ids.long() * 512 + lcp, torch.full_like(lcp, -1))
    key = key.sort(dim=1).values  # an id's entries together, its max lcp last
    nxt = torch.cat([key[:, 1:] >> 9, torch.full_like(key[:, :1], -1)], dim=1)
    last = (key >= 0) & ((key >> 9) != nxt)
    best = torch.where(last, key & 511, torch.full_like(key, -1))  # an id's max lcp
    distinct = last.sum(dim=1)
    if key.shape[1] == 0 or k < 1:
        cut = torch.full((B,), -1, dtype=torch.long, device=ids.device)
    else:
        top = torch.topk(best, min(k, key.shape[1]), dim=1).values
        cut = torch.gather(top, 1, (torch.clamp(distinct, 1, top.shape[1]) - 1)[:, None])[:, 0]
    above = (best >= cut[:, None]) & last
    entries = (live & (lcp >= cut[:, None])).sum(dim=1)
    return cut, above.sum(dim=1), entries, distinct


def pool_topk_plain(ids: torch.Tensor, lcps: torch.Tensor, n: int, lam: int,
                    tile: int | None = None):
    """The pool top-lam kernel's plain version: max-LCP per id, then the
    first k = min(lam, n) ids by (lcp descending, id ascending), over the
    (B, pool) probe pool only.  Entries whose id or lcp is < 0 are dropped.
    Tile by tile, as the kernel: each tile of `pool_chunk(k, n, tile)` entries
    keeps its own deduped top k (two stable sorts, `dedupe_topk`), and the
    tiles' lists are merged the same way until one tile holds them.  Exact,
    since an id of a row's top k is in the top k of the tile that holds its
    max lcp.  Returns (ids, lcps) (B, lam) int32, -1-padded."""
    B = ids.shape[0]
    k = min(lam, n)
    if k < 1:
        full = torch.full((B, lam), -1, dtype=torch.int32, device=ids.device)
        return full, full.clone()
    chunk = pool_chunk(k, n, tile)
    ids, lcps = ids.to(torch.int32), lcps.to(torch.int32)
    for pool in pool_levels(ids.shape[1], k, n, tile)[1:]:
        tiles = pool // k
        pad = (0, tiles * chunk - ids.shape[1])
        t_ids = torch.nn.functional.pad(ids, pad, value=-1).reshape(B * tiles, chunk)
        t_lcps = torch.nn.functional.pad(lcps, pad, value=-1).reshape(B * tiles, chunk)
        t_ids, t_lcps = dedupe_topk(t_ids, t_lcps, k)
        ids, lcps = t_ids.reshape(B, pool), t_lcps.reshape(B, pool)
    out_ids, vals = dedupe_topk(ids, lcps, k)
    return _pad_lam(out_ids, vals, lam)
