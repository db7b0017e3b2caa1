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
on CPU tensors its plain version (`ref.csa_probe_plain`).  Requires a CSA
built with the adjacent-LCP table (`csa.L`); `supports(csa)` gates that.
"""
from __future__ import annotations

import torch

from ...core.search import doubled
from .. import common
from .ref import csa_probe_plain, dedupe_topk_scatter


def supports(csa) -> bool:
    """True when `csa` carries the adjacent-LCP table the fused path needs
    (absent only on artifacts saved before the table existed)."""
    return csa is not None and csa.L is not None


def csa_probe(I, L, Hd, qd, shifts, qidx, width: int):
    """Fused probe over an (R,) worklist: row r searches shift `shifts[r]`
    for probe string `qd[qidx[r]]`.  I, L: (m, n) int32; Hd: (n, 2m) int32;
    qd: (B, 2m) int32; shifts, qidx: (R,) int32.
    Returns (ids (R, 2W), lcps (R, 2W)) int32."""
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


def csa_probe_windows(csa, q_hash, width: int = 16):
    """Raw fused windows of every (query, shift) pair -- the undeduped pool
    the multiprobe sources merge in one scatter pass.
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
    return dedupe_topk_scatter(ids.reshape(B, -1), lcps.reshape(B, -1), csa.n, lam)


def csa_probe_search_with_lens(csa, q_hash, lam: int, width: int = 16):
    """Fused batched search + per-shift best LCP (the §4.2 len bound):
    == `klccs_search_with_lens`.  Returns (ids, lcps, maxlen (B, m))."""
    B = q_hash.shape[0]
    ids, lcps = csa_probe_windows(csa, q_hash, width)
    maxlen = lcps.amax(dim=2)
    out_ids, out_lcps = dedupe_topk_scatter(
        ids.reshape(B, -1), lcps.reshape(B, -1), csa.n, lam
    )
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
