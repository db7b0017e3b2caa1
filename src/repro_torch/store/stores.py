"""Built-in vector stores: fp32 (exact), bf16 and int8 (quantized); PyTorch
port of `repro.store.stores`.

Memory per row of dimension d:

  Fp32Store   4d bytes            exact
  Bf16Store   2d bytes            ~3 significand decimal digits
  Int8Store   d + 4 bytes         per-row symmetric scale (zero-point == 0)

`Int8Store` quantizes symmetrically per row: ``scale = max|row| / 127``,
``q = round(row / scale)`` (round half to even, as the reference) clipped to
[-127, 127]; dequantization is one multiply, which the `gather_q` kernel
does in registers.

Distance scanning (`gather_dist`) dispatches per store:

  fp32   `kernels.gather_l2` (use_kernel=True) or the dense torch gather
  int8   `kernels.gather_q` (use_kernel=True) or the dense torch gather
  bf16   dense torch gather on upcast rows (no dedicated kernel)

With use_kernel=True the kernel wrappers launch the CUDA kernel for CUDA
tensors and run its plain version for CPU tensors.

`gather_topk` (fp32 and int8 only, metrics in KERNEL_METRICS) is the verify
in one kernel pass: the scan, the same epilogue as `gather_dist`'s, and the
k nearest per query (`kernels.gather_l2.ref.rank_ref`); `exec.stages` takes
it for `exact_topk` and `survivors` when the gather kernels are on.

`set_rows` writes the new rows IN PLACE and returns the store itself (the
reference's functional update copies the whole array); `padded_to` returns a
new, larger store.  The dynamic index owns its store, so nothing else sees
the write.  All stores return
*ranking-consistent* distances (sqrt'd Euclidean / 1-cos angular, +inf on
id < 0 padding).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .base import register_store


def _dist_rows(rows: torch.Tensor, queries: torch.Tensor, metric: str) -> torch.Tensor:
    """(B, L, d) rows x (B, d) queries -> (B, L) distances (clamped norms)."""
    from ..core.lsh import distance

    return distance(rows, queries[:, None, :], metric)


def _mask_pad(ids: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    return torch.where(ids >= 0, dist, torch.full_like(dist, float("inf")))


# the gather kernels implement exactly these; any other metric must take the
# reference path, not be mis-scored
KERNEL_METRICS = ("euclidean", "angular")


def _fix_kernel_dist(d: torch.Tensor, metric: str) -> torch.Tensor:
    """Reconcile the gather kernels with the reference semantics: euclidean
    kernels return squared L2 (sqrt here -- monotone, same ranks), and
    angular kernels divide by unclamped norms, so a zero vector yields NaN
    where `lsh.distance`'s clamped norms yield 1.0 -- map NaN to 1.0."""
    if metric == "euclidean":
        return torch.sqrt(torch.clamp(d, min=0.0))
    return torch.where(torch.isnan(d), torch.ones_like(d), d)


def _safe(ids: torch.Tensor) -> torch.Tensor:
    return torch.clamp(ids, min=0).long()


@dataclass
class Fp32Store:
    """Exact float32 rows."""

    rows: torch.Tensor  # (n, d) float32

    kind = "fp32"
    exact = True

    @staticmethod
    def from_dense(x) -> "Fp32Store":
        return Fp32Store(rows=x.to(torch.float32).contiguous())

    def dense(self) -> torch.Tensor:
        return self.rows

    def gather(self, ids: torch.Tensor) -> torch.Tensor:
        return self.rows[_safe(ids)]

    def gather_dist(self, ids, queries, *, metric: str, use_kernel: bool = False):
        if use_kernel and metric in KERNEL_METRICS:
            from ..kernels.gather_l2.ops import gather_dist

            d = gather_dist(self.rows, ids, queries, metric=metric)
            return _mask_pad(ids, _fix_kernel_dist(d, metric))
        return _mask_pad(ids, _dist_rows(self.gather(ids), queries, metric))

    def gather_topk(self, ids, queries, k: int, *, metric: str, report_ids=None,
                    survivors: bool = False):
        from ..kernels.gather_l2.ops import gather_topk

        return gather_topk(self.rows, ids, queries, k, metric=metric, report_ids=report_ids,
                           survivors=survivors)

    def set_rows(self, rows: torch.Tensor, x) -> "Fp32Store":
        """Write rows `rows` (in place) from (len(rows), d) float rows."""
        self.rows[rows.long()] = x.to(torch.float32)
        return self

    def padded_to(self, cap: int) -> "Fp32Store":
        n, d = self.rows.shape
        if cap <= n:
            return self
        return Fp32Store(rows=torch.cat([self.rows, self.rows.new_zeros((cap - n, d))]))

    def nbytes(self) -> int:
        return self.rows.numel() * 4

    @property
    def n(self) -> int:
        return self.rows.shape[0]

    @property
    def d(self) -> int:
        return self.rows.shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.rows.shape)


@dataclass
class Bf16Store:
    """bfloat16 rows: 2x smaller, ~2-3 significand digits, no code layout."""

    rows: torch.Tensor  # (n, d) bfloat16

    kind = "bf16"
    exact = False

    @staticmethod
    def from_dense(x) -> "Bf16Store":
        return Bf16Store(rows=x.to(torch.float32).to(torch.bfloat16).contiguous())

    def dense(self) -> torch.Tensor:
        return self.rows.to(torch.float32)

    def gather(self, ids: torch.Tensor) -> torch.Tensor:
        return self.rows[_safe(ids)].to(torch.float32)

    def gather_dist(self, ids, queries, *, metric: str, use_kernel: bool = False):
        del use_kernel  # a bf16 gather is a cast away from the fp32 path
        return _mask_pad(ids, _dist_rows(self.gather(ids), queries, metric))

    def set_rows(self, rows: torch.Tensor, x) -> "Bf16Store":
        """Write rows `rows` (in place), rounded to bfloat16 on ingest."""
        self.rows[rows.long()] = x.to(torch.float32).to(torch.bfloat16)
        return self

    def padded_to(self, cap: int) -> "Bf16Store":
        n, d = self.rows.shape
        if cap <= n:
            return self
        return Bf16Store(rows=torch.cat([self.rows, self.rows.new_zeros((cap - n, d))]))

    def nbytes(self) -> int:
        return self.rows.numel() * 2

    @property
    def n(self) -> int:
        return self.rows.shape[0]

    @property
    def d(self) -> int:
        return self.rows.shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.rows.shape)


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: q = round(x / scale), scale = max|row|/127.
    Zero rows get scale 0 (and q 0), so dequantization stays a multiply."""
    x = x.to(torch.float32)
    amax = torch.amax(torch.abs(x), dim=-1)
    scale = amax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


@dataclass
class Int8Store:
    """Symmetric per-row int8 quantization: ~3.9x smaller than fp32 at d=128.
    Approximate by construction -- pair it with the two-stage verify path
    (`SearchParams.rerank_mult`)."""

    q: torch.Tensor  # (n, d) int8 codes
    scale: torch.Tensor  # (n,) float32 per-row scale (zero-point == 0)

    kind = "int8"
    exact = False

    @staticmethod
    def from_dense(x) -> "Int8Store":
        q, scale = _quantize_rows(x)
        return Int8Store(q=q.contiguous(), scale=scale.contiguous())

    def dense(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.scale[:, None]

    def gather(self, ids: torch.Tensor) -> torch.Tensor:
        safe = _safe(ids)
        return self.q[safe].to(torch.float32) * self.scale[safe][..., None]

    def gather_dist(self, ids, queries, *, metric: str, use_kernel: bool = False):
        if use_kernel and metric in KERNEL_METRICS:
            from ..kernels.gather_q.ops import gather_dist_q

            d = gather_dist_q(self.q, self.scale, ids, queries, metric=metric)
            return _mask_pad(ids, _fix_kernel_dist(d, metric))
        return _mask_pad(ids, _dist_rows(self.gather(ids), queries, metric))

    def gather_topk(self, ids, queries, k: int, *, metric: str, report_ids=None,
                    survivors: bool = False):
        from ..kernels.gather_q.ops import gather_topk_q

        return gather_topk_q(self.q, self.scale, ids, queries, k, metric=metric,
                             report_ids=report_ids, survivors=survivors)

    def set_rows(self, rows: torch.Tensor, x) -> "Int8Store":
        """Write rows `rows` (in place), quantized on ingest exactly as
        `from_dense` quantizes."""
        q, scale = _quantize_rows(x)
        r = rows.long()
        self.q[r] = q
        self.scale[r] = scale
        return self

    def padded_to(self, cap: int) -> "Int8Store":
        n, d = self.q.shape
        if cap <= n:
            return self
        return Int8Store(q=torch.cat([self.q, self.q.new_zeros((cap - n, d))]),
                         scale=torch.cat([self.scale, self.scale.new_zeros((cap - n,))]))

    def nbytes(self) -> int:
        return self.q.numel() * 1 + self.scale.numel() * 4

    @property
    def n(self) -> int:
        return self.q.shape[0]

    @property
    def d(self) -> int:
        return self.q.shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.q.shape)


for _cls in (Fp32Store, Bf16Store, Int8Store):
    register_store(_cls)


def concat_stores(parts):
    """Concatenate same-kind stores along the row axis.

    Every built-in store keeps all its tensors n-leading (rows, codes,
    per-row scales), so concatenating each field along axis 0 is exact, and
    per-row quantization makes the result bit-identical to quantizing the
    concatenated rows in one go -- what `LCCSIndex.build_streaming` relies
    on.  Mixed kinds raise."""
    parts = list(parts)
    if not parts:
        raise ValueError("concat_stores needs at least one store")
    kinds = {p.kind for p in parts}
    if len(kinds) != 1:
        raise ValueError(f"cannot concatenate mixed store kinds: {sorted(kinds)}")
    if len(parts) == 1:
        return parts[0]
    return type(parts[0])(**{
        f.name: torch.cat([getattr(p, f.name) for p in parts], dim=0)
        for f in dataclasses.fields(parts[0])
    })
