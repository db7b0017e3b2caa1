"""LSH function families (PyTorch port of `repro.core.lsh`).

LCCS-LSH only consumes the (n, m) int32 matrix of hash values.  Each family
provides:

  hash(X: (n, d) float) -> (n, m) int32           batched hashing
  alternatives(X: (B, d)) -> (vals, scores)       batched multi-probe
      vals:   (B, m, n_alt) int32  -- alternative hash values per position,
      scores: (B, m, n_alt) float  -- ascending penalty per alternative
                                      (consumed by MP-LCCS-LSH, Algorithm 3).
  query_alternatives(q: (d,)) -> (vals, scores)    single-query numpy wrapper
                                                   around `alternatives`.
  collision_prob(tau) -> float                     the family's closed-form
                                                   per-function collision
                                                   probability (`theory`).

Families are dataclasses holding tensors; `create` draws new parameters from
a `torch.Generator` seeded with `seed` (on the CPU, then moved to `device`,
so a seed gives the same family on every device).  The draws differ from
the JAX package's `jax.random` draws: to compare the two packages, build a
family from the reference's arrays (`LCCSIndex.load` does this).

Hashing goes through the kernels of `repro_torch.kernels`: `hash_rp` for
the random-projection family and `hash_xp` for the cross-polytope family
with a gaussian rotation (the hand-written CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor).  The pseudo rotation stays plain torch: the
reference has no kernel for it.

Hash boundaries: ``floor(((x @ a) + b) / w)`` keeps the reference's op
order (a division, not a multiply by 1/w), and hashing switches TF32 off
for matmuls and cuDNN (`kernels.common.no_tf32`): a bucket boundary flips
on the last bit of the projection, and with it the hash string and the
whole CSA.  The kernels sum in another order than cuBLAS, so on the card
`alternatives` takes the base bucket or vertex from `hash` itself: no
alternative ever equals the base string's symbol, as in the reference,
where both come from one projection.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.common import no_tf32
from ..kernels.hash_rp import hash_rp
from ..kernels.hash_xp import hash_xp
from . import theory


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def _query_alternatives(family, q: np.ndarray, n_alt: int):
    """`family.alternatives` of one query: (d,) numpy in, (m, n_alt) numpy
    vals and scores out, computed on the family's device."""
    x = torch.as_tensor(np.asarray(q), device=family.device)[None, :]
    vals, scores = family.alternatives(x, n_alt)
    return vals[0].cpu().numpy(), scores[0].cpu().numpy()


def _generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(int(seed))


def topk_largest(x: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest entries along `dim`, ties to the
    lower index -- the `lax.top_k` contract, which `torch.topk` does not
    promise.  A stable descending sort keeps equal entries in index order."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def topk_largest_lcp(lcp: torch.Tensor, k: int):
    """`topk_largest` along the last dim for integer LCP scores >= -1 over
    fewer than 2^32 entries, without a full sort: each entry is ranked by the
    unique int64 key (lcp + 1) * 2^32 + (n - 1 - index), so `torch.topk`
    has no tie to break.  Returns (values, indices), int32 each.  The rows
    of the dedupe buffer and of the circrun lengths are full of ties and
    10^6 wide, where a stable sort of the whole row costs more."""
    n = lcp.shape[-1]
    tie = (n - 1) - torch.arange(n, dtype=torch.int64, device=lcp.device)
    top = torch.topk(((lcp.to(torch.int64) + 1) << 32) | tie, k, dim=-1).values
    return ((top >> 32) - 1).to(torch.int32), ((n - 1) - (top & 0xFFFFFFFF)).to(torch.int32)


# ---------------------------------------------------------------------------
# Random projection family (Euclidean)
# ---------------------------------------------------------------------------


@dataclass
class RandomProjectionLSH:
    """h(o) = floor((a . o + b) / w)   (paper Eq. 1)."""

    a: torch.Tensor  # (d, m) float32
    b: torch.Tensor  # (m,) float32
    w: float
    metric: str = field(default="euclidean")

    @staticmethod
    def create(seed: int, d: int, m: int, w: float, device="cpu") -> "RandomProjectionLSH":
        g = _generator(seed)
        a = torch.randn((d, m), generator=g, dtype=torch.float32)
        b = torch.rand((m,), generator=g, dtype=torch.float32) * float(w)
        return RandomProjectionLSH(a=a.to(device), b=b.to(device), w=float(w))

    @property
    def m(self) -> int:
        return self.a.shape[1]

    @property
    def d(self) -> int:
        return self.a.shape[0]

    @property
    def device(self) -> torch.device:
        return self.a.device

    def projections(self, x: torch.Tensor) -> torch.Tensor:
        no_tf32()
        return x.to(torch.float32) @ self.a + self.b

    def hash(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32).contiguous()
        return hash_rp(x, self.a.contiguous(), self.b.contiguous(), w=self.w)

    def collision_prob(self, tau: float) -> float:
        return theory.rp_collision_prob(tau, self.w)

    def alternatives(self, x: torch.Tensor, n_alt: int = 4):
        """Multi-Probe LSH (Lv et al. 2007) alternatives: h +- j, scored by
        the squared distance of the projection to the boundary.  The base
        bucket h is `hash`'s own (on the CPU it equals floor(proj / w) bit
        for bit), so no alternative equals the base symbol."""
        n_alt = max(2, n_alt)
        proj = self.projections(x)  # (B, m)
        h = self.hash(x).to(torch.float32)
        f = proj - h * self.w  # in-bucket offset, [0, w)
        js = torch.arange(1, n_alt // 2 + 1, dtype=torch.float32, device=proj.device)
        up = ((js - 1.0) * self.w + (self.w - f[..., None])) ** 2  # (B, m, J)
        dn = ((js - 1.0) * self.w + f[..., None]) ** 2
        vals = torch.stack([h[..., None] + js, h[..., None] - js], dim=-1)
        scores = torch.stack([up, dn], dim=-1)
        vals = vals.reshape(*proj.shape, -1)  # (B, m, 2J): [h+1, h-1, h+2, ...]
        scores = scores.reshape(*proj.shape, -1)
        order = torch.argsort(scores, dim=-1, stable=True)
        return (
            torch.gather(vals, -1, order).to(torch.int32),
            torch.gather(scores, -1, order),
        )

    def query_alternatives(self, q: np.ndarray, n_alt: int = 4):
        return _query_alternatives(self, q, n_alt)


# ---------------------------------------------------------------------------
# Cross-polytope family (Angular)
# ---------------------------------------------------------------------------


def _hadamard_transform(x: torch.Tensor) -> torch.Tensor:
    """Fast Walsh-Hadamard transform over the last axis (length = power of 2),
    in the reference's butterfly order (same adds in the same order, so the
    result is bit-identical)."""
    d = x.shape[-1]
    h = 1
    while h < d:
        x = x.reshape(x.shape[:-1] + (d // (2 * h), 2, h))
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = torch.cat([a + b, a - b], dim=-1).reshape(x.shape[:-3] + (d,))
        h *= 2
    return x


@dataclass
class CrossPolytopeLSH:
    """h(o) = index of the closest signed basis vector of the rotated o (Eq. 3).

    Hash value in [0, 2*dr): index i for +e_i, dr + i for -e_i.
    """

    signs: torch.Tensor  # pseudo: (m, 3, dr) +-1; gaussian: (m, 0, 0) unused
    rot: torch.Tensor | None  # gaussian: (m, d, dr); pseudo: None
    d: int
    dr: int  # rotated dimension (power of two for pseudo)
    rotation: str = field(default="pseudo")
    metric: str = field(default="angular")

    @staticmethod
    def create(seed: int, d: int, m: int, rotation: str = "pseudo",
               device="cpu") -> "CrossPolytopeLSH":
        g = _generator(seed)
        if rotation == "pseudo":
            dr = _next_pow2(d)
            bits = torch.randint(0, 2, (m, 3, dr), generator=g)
            signs = (bits * 2 - 1).to(torch.float32)
            return CrossPolytopeLSH(signs=signs.to(device), rot=None, d=d, dr=dr,
                                    rotation=rotation)
        if rotation == "gaussian":
            rot = torch.randn((m, d, d), generator=g, dtype=torch.float32) / math.sqrt(d)
            return CrossPolytopeLSH(
                signs=torch.zeros((m, 0, 0), device=device), rot=rot.to(device),
                d=d, dr=d, rotation=rotation,
            )
        raise ValueError(f"unknown rotation {rotation!r}")

    @property
    def m(self) -> int:
        return self.signs.shape[0] if self.rotation == "pseudo" else self.rot.shape[0]

    @property
    def device(self) -> torch.device:
        return self.signs.device if self.rot is None else self.rot.device

    def rotations(self, x: torch.Tensor) -> torch.Tensor:
        """(n, d) -> (n, m, dr) rotated copies."""
        no_tf32()
        x = x.to(torch.float32)
        if self.rotation == "gaussian":
            return torch.einsum("nd,mde->nme", x, self.rot)
        xp = torch.nn.functional.pad(x, (0, self.dr - self.d))
        y = xp[:, None, :] * self.signs[None, :, 0, :]  # (n, m, dr)
        y = _hadamard_transform(y)
        y = y * self.signs[None, :, 1, :]
        y = _hadamard_transform(y)
        y = y * self.signs[None, :, 2, :]
        y = _hadamard_transform(y)
        return y / torch.sqrt(torch.tensor(float(self.dr), dtype=torch.float32))

    def hash(self, x: torch.Tensor) -> torch.Tensor:
        if self.rotation == "gaussian":
            return hash_xp(x.to(torch.float32).contiguous(), self.rot.contiguous())
        y = self.rotations(x)  # (n, m, dr)
        idx = torch.argmax(torch.abs(y), dim=-1)  # first maximum, as jnp.argmax
        sgn = torch.gather(y, -1, idx[..., None])[..., 0] < 0
        return (idx + torch.where(sgn, self.dr, 0)).to(torch.int32)

    def collision_prob(self, tau: float) -> float:
        return theory.xp_collision_prob(tau, self.dr)

    def alternatives(self, x: torch.Tensor, n_alt: int = 4):
        """FALCONN-style alternatives: other cross-polytope vertices ranked by
        margin (|y_top| - |y_j|)^2.  Of the n_alt + 1 best vertices, the one
        `hash` chose is dropped (the top one, unless the kernel resolved a
        near tie the other way), so no alternative equals the base symbol."""
        n_alt = min(n_alt, self.dr - 1)
        y = self.rotations(x)  # (B, m, dr)
        top_vals, top_idx = topk_largest(torch.abs(y), n_alt + 1)  # best first
        sgn = torch.gather(y, -1, top_idx) < 0
        verts = (top_idx + torch.where(sgn, self.dr, 0)).to(torch.int32)
        is_base = (verts == self.hash(x)[..., None]).to(torch.int8)
        keep = torch.argsort(is_base, dim=-1, stable=True)[..., :n_alt]  # (B, m, n_alt)
        vals = torch.gather(verts, -1, keep)
        scores = (top_vals[..., :1] - torch.gather(top_vals, -1, keep)) ** 2
        return vals, scores

    def query_alternatives(self, q: np.ndarray, n_alt: int = 4):
        return _query_alternatives(self, q, n_alt)


# ---------------------------------------------------------------------------
# Bit sampling family (Hamming)
# ---------------------------------------------------------------------------


@dataclass
class BitSamplingLSH:
    """h_i(o) = o[idx_i] for binary vectors (Indyk & Motwani 1998)."""

    idx: torch.Tensor  # (m,) int32
    d: int
    metric: str = field(default="hamming")

    @staticmethod
    def create(seed: int, d: int, m: int, device="cpu") -> "BitSamplingLSH":
        idx = torch.randint(0, d, (m,), generator=_generator(seed), dtype=torch.int32)
        return BitSamplingLSH(idx=idx.to(device), d=d)

    @property
    def m(self) -> int:
        return self.idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def hash(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, self.idx.long()].to(torch.int32)

    def collision_prob(self, tau: float) -> float:
        # tau = Hamming distance; p = 1 - tau/d
        return max(0.0, 1.0 - tau / self.d)

    def alternatives(self, x: torch.Tensor, n_alt: int = 1):
        """Only one alternative per bit: flip it.  x: (B, d) binary."""
        qv = x[:, self.idx.long()].to(torch.int32)  # (B, m)
        vals = (1 - qv)[..., None]
        scores = torch.ones(vals.shape, dtype=torch.float32, device=x.device)
        return vals, scores

    def query_alternatives(self, q: np.ndarray, n_alt: int = 1):
        return _query_alternatives(self, q, n_alt)


FAMILIES = {
    "RandomProjectionLSH": RandomProjectionLSH,
    "CrossPolytopeLSH": CrossPolytopeLSH,
    "BitSamplingLSH": BitSamplingLSH,
}


def family_from_arrays(family_cls: str, fields: dict, device):
    """A family rebuilt from plain arrays on `device`: `family_cls` is its
    class name (a key of `FAMILIES`), `fields` its dataclass fields as numpy
    arrays and Python scalars (the reference's pickle fields, or a JAX
    family's arrays through `np.asarray`).  This is how a family crosses from
    the reference to the port; `LCCSIndex.load` uses it."""
    return FAMILIES[family_cls](**{
        k: torch.from_numpy(np.array(v)).to(device) if isinstance(v, np.ndarray) else v
        for k, v in fields.items()
    })


def make_family(kind: str, seed: int, d: int, m: int, device="cpu", **kw):
    if kind in ("rp", "euclidean", "random_projection"):
        return RandomProjectionLSH.create(seed, d, m, w=kw.get("w", 4.0), device=device)
    if kind in ("xp", "angular", "cross_polytope"):
        return CrossPolytopeLSH.create(seed, d, m, rotation=kw.get("rotation", "pseudo"),
                                       device=device)
    if kind in ("bits", "hamming", "bit_sampling"):
        return BitSamplingLSH.create(seed, d, m, device=device)
    raise ValueError(f"unknown LSH family {kind!r}")


def distance(x: torch.Tensor, y: torch.Tensor, metric: str) -> torch.Tensor:
    """Distance between matching rows of x and y (broadcasting ok)."""
    if metric == "euclidean":
        return torch.sqrt(torch.clamp(torch.sum((x - y) ** 2, dim=-1), min=0.0))
    if metric == "angular":
        # clamp norms: a zero vector must yield a finite (maximal) distance,
        # not NaN-poisoned verification
        xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
        yn = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-12)
        return 1.0 - torch.sum(xn * yn, dim=-1)  # monotone in angle
    if metric == "hamming":
        return torch.sum(x != y, dim=-1).to(torch.float32)
    raise ValueError(f"unknown metric {metric!r}")
