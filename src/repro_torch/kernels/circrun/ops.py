"""Public wrapper for the circular-run LCCS scorer (port of
`repro.kernels.circrun.ops`): the hand-written kernel (`csrc/circrun.cu`,
`circrun_launch`) on CUDA tensors, its plain version (`ref.circrun_ref`) on
CPU tensors.  Both are exact: the kernel equals the plain version bit for
bit."""
from __future__ import annotations

import torch

from .. import common
from .ref import circrun_ref

# the kernel stages a (64, m) row tile and a (32, m) query tile in shared
# memory (at most 227 KB a block)
MAX_M = 512


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
