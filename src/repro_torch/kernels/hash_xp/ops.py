"""Public wrapper for cross-polytope hashing with a gaussian rotation (port
of `repro.kernels.hash_xp.ops`): the hand-written kernel (`csrc/hash_xp.cu`,
`hash_xp_launch`) on CUDA tensors, its plain version (`ref.hash_xp_ref`) on
CPU tensors.

The kernel sums each rotated coordinate in another order than cuBLAS, so
the two may pick different vertices where the two largest signed values are
within rounding of each other; nowhere else."""
from __future__ import annotations

import torch

from .. import common
from .ref import hash_xp_ref


def hash_xp(x, rot) -> torch.Tensor:
    """argmax of cat([x @ rot[j], -(x @ rot[j])]) per function j -> (n, m)
    int32 in [0, 2 dr).  x: (n, d) f32, rot: (m, d, dr) f32, contiguous."""
    if x.device.type == "cpu":
        return hash_xp_ref(x, rot)
    if x.device.type != "cuda":
        raise ValueError(f"hash_xp: unsupported device {x.device}")
    n, d = x.shape
    m, _, dr = rot.shape
    dev = x.device
    common.check("x", x, device=dev, dtype=torch.float32, shape=(n, d))
    common.check("rot", rot, device=dev, dtype=torch.float32, shape=(m, d, dr))
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    common.launch("hash_xp", "hash_xp_launch", x.data_ptr(), rot.data_ptr(), out.data_ptr(),
                  n, d, m, dr)
    return out
