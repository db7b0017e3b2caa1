"""Public wrappers of the fused CSA probe (port of
`repro.kernels.csa_probe.ops`).

Drop-in fused counterparts of the three `repro_torch.core.search` probe
entry points, selected by `SearchParams.use_probe_kernel` /
REPRO_PROBE_KERNEL (resolved in `repro_torch.exec.stages`):

  csa_probe_search            == klccs_search           (mode="parallel")
  csa_probe_search_with_lens  == klccs_search_with_lens
  csa_probe_pairs             == klccs_search_pairs

Every form reduces to one worklist of (probe string, shift) rows handed to
`csa_probe`: on CUDA tensors the hand-written kernel (`csrc/csa_probe.cu`),
on CPU tensors its plain version (`ref.csa_probe_plain`).  The searches
dedupe the windows' pool with `pool_topk`: on CUDA tensors the hand-written
kernel (`csrc/pool_topk.cu`), on CPU tensors `ref.pool_topk_plain`.
Requires a CSA built with the adjacent-LCP table (`csa.L`); `supports(csa)`
gates that.  The kernel's contract is a CSA from `core.csa.build_csa`: its
search skips the prefix the rows around a step share with the probe, which
holds only because each I[i] is sorted by the shift-i strings of Hd (the
plain version needs no such order).
"""
from __future__ import annotations

import torch

from ...core.search import doubled
from .. import common
from .ref import csa_probe_plain, pool_chunk, pool_levels, pool_topk_plain

# the pool top-k kernel keeps at most this many ids a tile
POOL_MAX_K = 4096


def supports(csa) -> bool:
    """True when `csa` carries the adjacent-LCP table the fused path needs
    (absent only on artifacts saved before the table existed)."""
    return csa is not None and csa.L is not None


def csa_probe(I, L, Hd, qd, shifts, qidx, width: int):
    """Fused probe over an (R,) worklist: row r searches shift `shifts[r]`
    for probe string `qd[qidx[r]]`.  I, L: (m, n) int32; Hd: (n, 2m) int32;
    qd: (B, 2m) int32; shifts, qidx: (R,) int32.
    Returns (ids (R, 2W), lcps (R, 2W)) int32.  On CUDA the tables must be
    a CSA's (`core.csa.build_csa`; see the module docstring)."""
    if qd.device.type == "cpu":
        return csa_probe_plain(I, L, Hd, qd, shifts, qidx, width)
    if qd.device.type != "cuda":
        raise ValueError(f"csa_probe: unsupported device {qd.device}")
    m, n = I.shape
    B, R = qd.shape[0], shifts.shape[0]
    dev = qd.device
    i32 = torch.int32
    common.check("I", I, device=dev, dtype=i32, shape=(m, n))
    common.check("L", L, device=dev, dtype=i32, shape=(m, n))
    common.check("Hd", Hd, device=dev, dtype=i32, shape=(n, 2 * m))
    common.check("qd", qd, device=dev, dtype=i32, shape=(B, 2 * m))
    common.check("shifts", shifts, device=dev, dtype=i32, shape=(R,))
    common.check("qidx", qidx, device=dev, dtype=i32, shape=(R,))
    if not 1 <= m <= 256:
        raise ValueError(f"csa_probe: the kernel takes 1 <= m <= 256, got m={m}")
    if width < 1:
        raise ValueError(f"csa_probe: width must be >= 1, got {width}")
    ids = torch.empty((R, 2 * width), dtype=i32, device=dev)
    lcps = torch.empty((R, 2 * width), dtype=i32, device=dev)
    if R == 0:
        return ids, lcps
    common.launch("csa_probe", "csa_probe_launch", I.data_ptr(), L.data_ptr(),
                  Hd.data_ptr(), qd.data_ptr(), shifts.data_ptr(), qidx.data_ptr(),
                  ids.data_ptr(), lcps.data_ptr(), n, m, R, width)
    return ids, lcps


def pool_topk(ids, lcps, n: int, lam: int):
    """Max-LCP per id, then the first k = min(lam, n) ids by (lcp
    descending, id ascending), over a (B, pool) probe pool; entries whose id
    or lcp is < 0 are dropped.  ids, lcps: (B, pool) int32, ids in [-1, n),
    lcps <= 256.  Returns (ids, lcps) (B, lam) int32, -1-padded, equal to
    `ref.dedupe_topk_scatter` and `core.search.dedupe_topk`.

    On CUDA tensors: one launch of the kernel a tile pass of
    `ref.pool_levels`, k <= POOL_MAX_K; no host sync.  A tile holds up to
    `ref.POOL_TILE` = 16,384 entries (8,192 where ids reach 2^23): the
    kernel keeps a tile in registers and dedupes only the entries whose lcp
    can reach its top k, into a table sized for them, so one launch takes
    the lccs pool (12,800 entries at m 64, W 100) and the serving pool
    (4,096), and a tile pass plus one merge a multiprobe pool.  The tiles
    are `ref.pool_topk_plain`'s."""
    if ids.device.type == "cpu":
        return pool_topk_plain(ids, lcps, n, lam)
    if ids.device.type != "cuda":
        raise ValueError(f"pool_topk: unsupported device {ids.device}")
    B, pool = ids.shape
    dev = ids.device
    common.check("ids", ids, device=dev, dtype=torch.int32, shape=(B, pool))
    common.check("lcps", lcps, device=dev, dtype=torch.int32, shape=(B, pool))
    k = min(lam, n)
    if k > POOL_MAX_K:
        raise ValueError(f"pool_topk: the kernel takes k = min(lam, n) <= {POOL_MAX_K}, got {k}")
    if B == 0 or pool == 0 or k < 1:  # no id to rank: nothing to launch
        full = torch.full((B, lam), -1, dtype=torch.int32, device=dev)
        return full, full.clone()
    chunk = pool_chunk(k, n)
    levels = pool_levels(pool, k, n)
    for i, p in enumerate(levels):
        last = i == len(levels) - 1
        cols = lam if last else k
        shape = (B, cols) if last else (B, levels[i + 1])
        out_ids = torch.empty(shape, dtype=torch.int32, device=dev)
        out_vals = torch.empty(shape, dtype=torch.int32, device=dev)
        common.launch("pool_topk", "pool_topk_launch", ids.data_ptr(), lcps.data_ptr(),
                      out_ids.data_ptr(), out_vals.data_ptr(), B, p, n, chunk, k, cols)
        ids, lcps = out_ids, out_vals
    return ids, lcps


def csa_probe_windows(csa, q_hash, width: int = 16):
    """Raw fused windows of every (query, shift) pair -- the undeduped pool
    the multiprobe sources merge in one `pool_topk` pass.
    q_hash: (B, m) int32.  Returns (ids (B, m, 2W), lcps (B, m, 2W))."""
    B, m = q_hash.shape
    dev = q_hash.device
    shifts = torch.arange(m, dtype=torch.int32, device=dev).repeat(B)
    qidx = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(m)
    ids, lcps = csa_probe(csa.I, csa.L, csa.Hd, doubled(q_hash), shifts, qidx, width)
    return ids.reshape(B, m, -1), lcps.reshape(B, m, -1)


def csa_probe_search(csa, q_hash, lam: int, width: int = 16):
    """Fused batched k-LCCS search: == `klccs_search(mode="parallel")`.
    q_hash: (B, m) int32.  Returns (ids (B, lam), lcps (B, lam))."""
    B = q_hash.shape[0]
    ids, lcps = csa_probe_windows(csa, q_hash, width)
    return pool_topk(ids.reshape(B, -1), lcps.reshape(B, -1), csa.n, lam)


def csa_probe_search_with_lens(csa, q_hash, lam: int, width: int = 16):
    """Fused batched search + per-shift best LCP (the §4.2 len bound):
    == `klccs_search_with_lens`.  Returns (ids, lcps, maxlen (B, m))."""
    B = q_hash.shape[0]
    ids, lcps = csa_probe_windows(csa, q_hash, width)
    maxlen = lcps.amax(dim=2)
    out_ids, out_lcps = pool_topk(ids.reshape(B, -1), lcps.reshape(B, -1), csa.n, lam)
    return out_ids, out_lcps, maxlen


def csa_probe_pairs(csa, probe_hashes, shifts, valid, width: int = 16):
    """Fused worklist probe: == `klccs_search_pairs`.
    probe_hashes: (R, m); shifts/valid: (R,).  Returns (ids, lcps) (R, 2W),
    invalid rows masked to -1."""
    R = probe_hashes.shape[0]
    qidx = torch.arange(R, dtype=torch.int32, device=probe_hashes.device)
    ids, lcps = csa_probe(csa.I, csa.L, csa.Hd, doubled(probe_hashes),
                          shifts.to(torch.int32).contiguous(), qidx, width)
    keep = valid[:, None]
    return (torch.where(keep, ids, torch.full_like(ids, -1)),
            torch.where(keep, lcps, torch.full_like(lcps, -1)))
