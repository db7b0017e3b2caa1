"""Public wrappers for the circular-run LCCS scorer (port of
`repro.kernels.circrun.ops`) and the top-k behind it.  On CUDA tensors they
launch the hand-written kernels of `csrc/circrun.cu`; on CPU tensors they run
the plain versions of `ref.py`.  Both routes are exact: the kernels equal
the plain versions bit for bit.

  circrun       (B, n) int32 lengths (`circrun_launch`)
  circrun_topk  each query's k rows by (length descending, row ascending):
                per chunk of queries the scorer (`circrun_score_launch`,
                counted under "circrun") stores each length + 1 in a byte
                (two above m = 254) with a histogram a query, and the select
                kernel (`circrun_topk_launch`, counted under "circrun_topk")
                cuts the histogram and walks the row.  No (B, n) int32
                lengths or int64 ranking keys are written.
"""
from __future__ import annotations

import torch

from .. import common
from .ref import circrun_ref, circrun_topk_plain

# the scorer stages a block's queries and two 32-row windows of strings in
# shared memory (at most 227 KB a block)
MAX_M = 512
# rows the select kernel keeps a query (its keys sort in 32 KB of shared memory)
MAX_K = 4096
# m up to which a stored length + 1 fits a byte (else two)
NARROW_M = 254
# stored lengths one chunk of queries may hold on the card: 256 MB, no more
# than the CPU route's int32 lengths a chunk (`core.bruteforce._LENS_ELEMS`)
NARROW_BYTES = 1 << 28


def circrun(h, q) -> torch.Tensor:
    """LCCS lengths of every database string vs each query.  h: (n, m) int32;
    q: (m,) or (B, m) int32.  Returns (n,) for a single query or (B, n) for a
    batch, int32."""
    single = q.dim() == 1
    qb = q[None, :] if single else q
    if h.device.type == "cpu":
        out = circrun_ref(h, qb)
    elif h.device.type != "cuda":
        raise ValueError(f"circrun: unsupported device {h.device}")
    else:
        out = _launch(h, qb.contiguous())
    return out[0] if single else out


def _launch(h, q) -> torch.Tensor:
    n, m = h.shape
    B = q.shape[0]
    dev = h.device
    common.check("h", h, device=dev, dtype=torch.int32, shape=(n, m))
    common.check("q", q, device=dev, dtype=torch.int32, shape=(B, m))
    if not 1 <= m <= MAX_M:
        raise ValueError(f"circrun: the kernel takes 1 <= m <= {MAX_M}, got m={m}")
    out = torch.empty((B, n), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    common.launch("circrun", "circrun_launch", h.data_ptr(), q.data_ptr(), out.data_ptr(),
                  n, m, B)
    return out


def stored_layout(n: int, m: int) -> tuple[torch.dtype, int, int]:
    """The card route's stored lengths for n rows: (dtype, row stride in
    elements, queries a chunk).  The stride pads n to a multiple of 32; a
    chunk holds at most NARROW_BYTES, in whole groups of 32 queries where
    more than 32 fit."""
    dtype = torch.uint8 if m <= NARROW_M else torch.int16
    ld = -(-n // 32) * 32
    step = max(1, NARROW_BYTES // (ld * dtype.itemsize))
    return dtype, ld, step - step % 32 if step >= 32 else step


def circrun_topk(h, q, k: int, ok=None):
    """The k largest circular-run lengths of the rows of h for each query,
    ranked by (length descending, row ascending) -- the `lax.top_k`
    contract; rows where `ok` is False score -1.  h: (n, m), q: (B, m) int32;
    ok: (n,) bool or None; 0 <= k <= n (on CUDA tensors also k <= MAX_K).
    Returns (vals, rows), (B, k) int32 each.

    On CUDA tensors: two launches a chunk of `stored_layout(n, m)[2]`
    queries (one "circrun", one "circrun_topk"), no host sync."""
    if h.device.type == "cpu":
        return circrun_topk_plain(h, q, k, ok)
    if h.device.type != "cuda":
        raise ValueError(f"circrun_topk: unsupported device {h.device}")
    n, m = h.shape
    B = q.shape[0]
    dev = h.device
    q = q.contiguous()
    common.check("h", h, device=dev, dtype=torch.int32, shape=(n, m))
    common.check("q", q, device=dev, dtype=torch.int32, shape=(B, m))
    if ok is not None:
        common.check("ok", ok, device=dev, dtype=torch.bool, shape=(n,))
    if not 1 <= m <= MAX_M:
        raise ValueError(f"circrun_topk: the kernel takes 1 <= m <= {MAX_M}, got m={m}")
    if not 0 <= k <= n:
        raise ValueError(f"circrun_topk: k must lie in [0, n = {n}], got k={k}")
    if k > MAX_K:
        raise ValueError(f"circrun_topk: the kernel takes k <= {MAX_K}, got k={k}")
    vals = torch.empty((B, k), dtype=torch.int32, device=dev)
    rows = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0 or k == 0:
        return vals, rows
    dtype, ld, step = stored_layout(n, m)
    lens = torch.empty((min(step, B), ld), dtype=dtype, device=dev)
    hist = torch.empty((min(step, B), m + 2), dtype=torch.int32, device=dev)
    ok_ptr = None if ok is None else ok.data_ptr()
    for lo in range(0, B, step):
        bc = min(step, B - lo)
        hist.zero_()
        common.launch("circrun", "circrun_score_launch", h.data_ptr(), q[lo].data_ptr(), ok_ptr,
                      lens.data_ptr(), hist.data_ptr(), n, m, bc, ld)
        common.launch("circrun_topk", "circrun_topk_launch", lens.data_ptr(), hist.data_ptr(),
                      vals[lo].data_ptr(), rows[lo].data_ptr(), n, m, bc, k, ld)
    return vals, rows
