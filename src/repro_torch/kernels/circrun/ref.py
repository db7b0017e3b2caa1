"""Plain PyTorch versions of the circular-run LCCS scorer (port of
`repro.kernels.circrun.ref`, batched over queries) and of the top-k behind
it (the `lax.top_k` after the scorer in the reference's `bruteforce_topk`
and `_buffer_topk`)."""
from __future__ import annotations

import torch

from ...core.lsh import topk_largest_lcp

# (queries, rows, 2m) elements one chunk may hold: the int32 blockers and
# cummax's int32 values and int64 indices, about 2 GB
_CHUNK_ELEMS = 1 << 27


def circrun_ref(h: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """h: (n, m) int32, q: (B, m) int32 -> (B, n) int32: the longest circular
    run of positions where h[i] == q[b] (i.e. |LCCS(h[i], q[b])|).

    The reference's formulation: double the match vector, take the running
    maximum of the mismatch positions, and the longest run ending anywhere,
    capped at m.  Queries go in chunks that bound the (Bc, n, 2m) transient."""
    n, m = h.shape
    B = q.shape[0]
    out = torch.empty((B, n), dtype=torch.int32, device=h.device)
    j = torch.arange(1, 2 * m + 1, dtype=torch.int32, device=h.device)
    step = max(1, _CHUNK_ELEMS // max(1, n * 2 * m))
    for lo in range(0, B, step):
        e = h[None, :, :] == q[lo:lo + step, None, :]  # (Bc, n, m)
        ee = torch.cat([e, e], dim=2)
        del e
        # run length ending at j is j - (position of the most recent mismatch)
        blockers = torch.where(ee, torch.zeros_like(j), j)
        del ee
        last_block = torch.cummax(blockers, dim=2).values
        runs = j - last_block
        out[lo:lo + step] = torch.clamp(runs.amax(dim=2), max=m).to(torch.int32)
    return out


def circrun_topk_plain(h: torch.Tensor, q: torch.Tensor, k: int,
                       ok: torch.Tensor | None = None):
    """The fused route's plain version: every length (`circrun_ref`), -1
    where `ok` is False, then the first k rows by (length descending, row
    ascending) -- the `lax.top_k` contract (`topk_largest_lcp`).
    h: (n, m), q: (B, m) int32; ok: (n,) bool or None; k <= n.
    Returns (vals, rows), (B, k) int32 each."""
    lens = circrun_ref(h, q)
    if ok is not None:
        lens = torch.where(ok, lens, torch.full_like(lens, -1))
    return topk_largest_lcp(lens, k)
