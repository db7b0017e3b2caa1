"""Public wrapper for random-projection hashing (port of
`repro.kernels.hash_rp.ops`): the hand-written kernel (`csrc/hash_rp.cu`,
`hash_rp_launch`) on CUDA tensors, its plain version (`ref.hash_rp_ref`) on
CPU tensors.

The kernel sums each projection in another order than cuBLAS, so the two
may differ by one bucket where a projection lies on a boundary to the last
bits; nowhere else."""
from __future__ import annotations

import torch

from .. import common
from .ref import hash_rp_ref


def hash_rp(x, a, b, *, w: float) -> torch.Tensor:
    """floor((x @ a + b) / w) -> (n, m) int32.  x: (n, d) f32, a: (d, m) f32,
    b: (m,) f32, all contiguous on one device."""
    if x.device.type == "cpu":
        return hash_rp_ref(x, a, b, w=w)
    if x.device.type != "cuda":
        raise ValueError(f"hash_rp: unsupported device {x.device}")
    if not w > 0:
        raise ValueError(f"hash_rp: bucket width must be > 0, got {w}")
    n, d = x.shape
    m = a.shape[1]
    dev = x.device
    f32 = torch.float32
    common.check("x", x, device=dev, dtype=f32, shape=(n, d))
    common.check("a", a, device=dev, dtype=f32, shape=(d, m))
    common.check("b", b, device=dev, dtype=f32, shape=(m,))
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    common.launch("hash_rp", "hash_rp_launch", x.data_ptr(), a.data_ptr(), b.data_ptr(),
                  out.data_ptr(), n, d, m, float(w))
    return out
