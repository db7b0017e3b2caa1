"""Plain PyTorch version of cross-polytope hashing with a gaussian rotation
(port of `repro.kernels.hash_xp.ref`)."""
from __future__ import annotations

import torch

from ..common import no_tf32

# float32 elements one chunk of rows may hold: y (rows, m, dr) and its signed
# copy (rows, m, 2 dr), about 2 GB
_CHUNK_ELEMS = 1 << 29


def hash_xp_ref(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """x: (n, d), rot: (m, d, dr) -> (n, m) int32 hash in [0, 2 dr): the
    argmax of cat([y, -y]) with y = x @ rot[j], first index on ties (index i
    is +e_i, dr + i is -e_i).  Rows go in chunks, so that y and its signed
    copy never hold more than about 2 GB."""
    no_tf32()
    x = x.to(torch.float32)
    rot = rot.to(torch.float32)
    n = x.shape[0]
    m, _, dr = rot.shape
    out = torch.empty((n, m), dtype=torch.int32, device=x.device)
    step = max(1, _CHUNK_ELEMS // (3 * m * dr))
    for lo in range(0, n, step):
        y = torch.einsum("nd,mde->nme", x[lo:lo + step], rot)
        both = torch.cat([y, -y], dim=-1)  # (rows, m, 2 dr)
        del y
        out[lo:lo + step] = torch.argmax(both, dim=-1).to(torch.int32)  # first maximum
    return out
