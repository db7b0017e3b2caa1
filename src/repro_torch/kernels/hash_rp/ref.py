"""Plain PyTorch version of random-projection hashing (port of
`repro.kernels.hash_rp.ref`)."""
from __future__ import annotations

import torch

from ..common import no_tf32


def hash_rp_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, w: float) -> torch.Tensor:
    """floor((x @ a + b) / w) -> int32.  x: (n, d), a: (d, m), b: (m,).

    A full float32 matmul (TF32 off): TF32 keeps ~10 mantissa bits and would
    move projections across bucket boundaries.  The division is a division,
    not a multiply by 1/w, as in the reference."""
    no_tf32()
    proj = x.to(torch.float32) @ a.to(torch.float32) + b
    return torch.floor(proj / w).to(torch.int32)
