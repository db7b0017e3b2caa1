"""VectorStore protocol + registry: pluggable corpus-vector layouts (PyTorch
port of `repro.store.base`).

A *vector store* owns how corpus vectors are laid out in device memory, how
they are (de)quantized, and how candidate distances are scanned against
them.  Protocol:

  from_dense(x)                  build from (n, d) float32 rows
  dense()                        (n, d) float32 reconstruction (dequantized)
  gather(ids)                    (B, L, d) float32 rows for id matrix `ids`
  gather_dist(ids, queries, metric=..., use_kernel=...)
                                 (B, L) distances of gathered rows to queries
  set_rows(rows, x)              write rows `rows` from float rows (quantize
                                 on ingest); in place, returns the store
  padded_to(cap)                 grow to `cap` rows (zero padding), a new store
  nbytes()                       resident bytes of this representation
  n / d / shape                  row count, dimensionality, (n, d)

Class attributes:
  kind   registry name ("fp32" | "bf16" | "int8" | ...)
  exact  True when gather_dist returns exact fp32 distances; False for
         quantized stores, which the two-stage verify path over-fetches by
         `SearchParams.rerank_mult` and reranks in fp32.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch


@runtime_checkable
class VectorStore(Protocol):
    kind: str
    exact: bool

    def dense(self) -> torch.Tensor: ...

    def gather(self, ids: torch.Tensor) -> torch.Tensor: ...

    def gather_dist(
        self, ids: torch.Tensor, queries: torch.Tensor, *, metric: str,
        use_kernel: bool = False,
    ) -> torch.Tensor: ...

    def set_rows(self, rows: torch.Tensor, x: torch.Tensor) -> "VectorStore": ...

    def padded_to(self, cap: int) -> "VectorStore": ...

    def nbytes(self) -> int: ...

    @property
    def n(self) -> int: ...

    @property
    def d(self) -> int: ...

    @property
    def shape(self) -> tuple[int, int]: ...


_REGISTRY: dict[str, type] = {}


def register_store(cls: type | None = None, *, name: str | None = None):
    """Register a VectorStore implementation (decorator or direct call).
    The registry key defaults to the class's `kind` attribute."""

    def deco(c: type) -> type:
        _REGISTRY[name or c.kind] = c
        return c

    return deco(cls) if cls is not None else deco


def get_store_cls(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown vector store {name!r}; available: {available_stores()}"
        ) from None


def available_stores() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_store(name: str, x: torch.Tensor) -> VectorStore:
    """Quantize/lay out dense (n, d) float32 rows as the named store."""
    return get_store_cls(name).from_dense(x)
