"""ShardedLCCSIndex -- the monolithic LCCS-LSH index partitioned into row
shards (PyTorch port of `repro.shard.index`).

The paper's query phase (Algorithm 2) is pointwise per object: candidates are
proposed per database string and verified by a per-row distance.  Shard-local
search plus a global top-k merge is therefore exact with respect to the
union of the per-shard candidate sets.

Layout (the reference's): corpus rows are split contiguously into S equal
blocks; the last block is padded with sentinel hash strings (int32 max) and
gid -1, so n does not have to divide by S.  Every tensor gains a leading
shard axis:

  h     (S, rows, m)   per-shard hash strings, sentinel-padded
  csa   CSA with tables (S, m, rows) / (S, rows, 2m) -- one CSA per shard,
        built from the shard's rows, NOT a split of the global CSA
  gid   (S, rows)      global row ids, -1 on padding
  store the vector store with every tensor (S, rows, ...)
  tail  (S, rows, d)   per-shard fp32 rerank rows (inexact stores)

The LSH family is one, shared: hash strings are comparable across shards,
and queries are hashed once.  The reference places the shards on a device
mesh and searches them under `shard_map`; the port has no mesh: all S
shards live on the index's device, and `repro_torch.shard.search` walks
them in order, each through the same kernels a monolithic index launches,
before the reference's exact global merge.

    from repro_torch.shard import ShardedLCCSIndex

    index = ShardedLCCSIndex.build(X, shards=4, m=64, family="euclidean")  # CUDA
    ids, dists = index.search(Q, SearchParams(k=10, lam=200))

    # or partition an existing monolithic index (per-shard CSAs are rebuilt):
    index = LCCSIndex.build(X, m=64).shard(4)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from ..core.csa import CSA, build_csa
from ..core.index import LCCSIndex
from ..core.params import SearchParams
from ..core.segments import _PAD_HASH  # the sentinel hash value of padded rows
from ..exec import execute


def _stack_rows(t: torch.Tensor, S: int, rows: int) -> torch.Tensor:
    """Pad a tensor's leading (row) axis with zeros to S*rows and fold it
    into a leading shard axis: (n, ...) -> (S, rows, ...)."""
    n = t.shape[0]
    if n < S * rows:
        t = torch.cat([t, t.new_zeros((S * rows - n,) + tuple(t.shape[1:]))])
    return t.reshape((S, rows) + tuple(t.shape[1:]))


def _map_store(store, fn):
    """The store with `fn` applied to each of its tensors (every built-in
    store keeps all its tensors row-leading)."""
    return type(store)(**{f.name: fn(getattr(store, f.name))
                          for f in dataclasses.fields(store)})


@dataclass
class ShardedLCCSIndex:
    """LCCS-LSH index with its rows partitioned into `shards` row shards on
    one device (see the module docstring for the layout)."""

    family: Any  # shared LSH family
    store: Any  # vector store with a leading shard axis on every tensor
    h: torch.Tensor  # (S, rows, m) int32, sentinel-padded
    csa: CSA | None  # per-shard CSAs, stacked; None for bruteforce-only
    gid: torch.Tensor  # (S, rows) int32 global ids, -1 on padding
    metric: str
    n_rows: int  # true (unpadded) corpus size
    tail: torch.Tensor | None = None  # (S, rows, d) fp32 rerank rows

    # class marker so repro_torch.core can guard without importing this package
    sharded = True
    tail_path = None  # disk-lazy tails are a monolithic-index feature
    # topology marker read by the `repro_torch.exec` dispatch (the adapter
    # itself is registered by repro_torch.shard.search)
    topology = "sharded"

    # -- construction -------------------------------------------------------

    @staticmethod
    def build(
        data,
        *,
        shards: int,
        m: int = 64,
        family: str = "euclidean",
        seed: int = 0,
        build_csa_structure: bool = True,
        store: str = "fp32",
        chunk_rows: int | None = None,
        device=None,
        **family_kw,
    ) -> "ShardedLCCSIndex":
        """Hash + per-shard CSA build over `data` on `device` (None = CUDA),
        rows partitioned into `shards` shards.  The same family construction
        (and so the same hash functions) as `LCCSIndex.build`, so a sharded
        index is search-equivalent to the monolithic one built from the same
        arguments.  `chunk_rows` hashes and quantizes through the
        out-of-core build first."""
        mono = LCCSIndex.build(
            data, m=m, family=family, seed=seed, build_csa_structure=False,
            store=store, chunk_rows=chunk_rows, device=device, **family_kw,
        )
        return shard_index(mono, shards, build_csa_structure=build_csa_structure)

    # -- introspection ------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.h.device

    @property
    def shards(self) -> int:
        return self.h.shape[0]

    @property
    def rows_per_shard(self) -> int:
        return self.h.shape[1]

    @property
    def n(self) -> int:
        return self.n_rows

    @property
    def m(self) -> int:
        return self.h.shape[2]

    def index_bytes(self) -> int:
        """CSA + hash strings footprint, summed over shards (padding
        included)."""
        tot = self.h.numel() * 4
        if self.csa is not None:
            tot += sum(t.numel() * 4 for t in self.csa.tables() if t is not None)
        return tot

    def store_bytes(self) -> int:
        tot = self.store.nbytes()
        if self.tail is not None:
            tot += self.tail.numel() * 4
        return tot

    def total_bytes(self) -> int:
        return self.index_bytes() + self.store_bytes()

    def local_view(self, s: int) -> tuple[LCCSIndex, torch.Tensor]:
        """Shard `s` as a plain `LCCSIndex` over its own rows (views, no
        copies: a leading-axis slice of a contiguous tensor is contiguous),
        and its (rows,) global ids."""
        csa = None if self.csa is None else CSA(
            *(None if t is None else t[s] for t in self.csa.tables()))
        view = LCCSIndex(family=self.family, store=_map_store(self.store, lambda t: t[s]),
                         h=self.h[s], csa=csa, metric=self.metric,
                         tail=None if self.tail is None else self.tail[s])
        return view, self.gid[s]

    # -- search -------------------------------------------------------------

    def search(self, queries, params: SearchParams | None = None):
        """c-k-ANNS over all shards through the plan cache
        (`repro_torch.exec`).  `params.source` names the per-shard candidate
        source; the "sharded" topology adapter (`repro_torch.shard.search`)
        rewrites it onto the "sharded" source (source="sharded",
        inner=<source>), pins the kernel toggles and checks the
        `params.shards` pin."""
        return execute(self, queries, params)


def shard_index(index: LCCSIndex, shards: int, *,
                build_csa_structure: bool | None = None) -> ShardedLCCSIndex:
    """Partition a monolithic `LCCSIndex` into `shards` row shards on its
    device.

    Rows are split contiguously into S equal blocks (the last padded with
    sentinel strings / gid -1 when n does not divide evenly -- padded rows
    are masked out of every candidate set, so uneven corpora are handled
    exactly).  Per-shard CSAs are rebuilt from the shard's rows
    (`build_csa_structure=None` keeps a CSA iff the source index had one);
    the family, store contents and tail are reused as they are."""
    if index.tail_path:
        raise ValueError(
            "disk-lazy rerank tails (tail_path=) are not supported by the "
            "sharded index; rebuild with an in-memory tail"
        )
    S = int(shards)
    if S < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    n, m = index.h.shape
    dev = index.device
    rows = -(-n // S)  # ceil: every shard gets an equal, padded block
    h = torch.full((S * rows, m), _PAD_HASH, dtype=torch.int32, device=dev)
    h[:n] = index.h
    h = h.reshape(S, rows, m)
    gid = torch.full((S * rows,), -1, dtype=torch.int32, device=dev)
    gid[:n] = torch.arange(n, dtype=torch.int32, device=dev)
    if build_csa_structure is None:
        build_csa_structure = index.csa is not None
    csa = None
    if build_csa_structure:
        per = [build_csa(h[s]) for s in range(S)]
        csa = CSA(*(torch.stack(ts) for ts in zip(*(c.tables() for c in per))))
        del per
    return ShardedLCCSIndex(
        family=index.family,
        store=_map_store(index.store, lambda t: _stack_rows(t, S, rows)),
        h=h,
        csa=csa,
        gid=gid.reshape(S, rows),
        metric=index.metric,
        n_rows=n,
        tail=None if index.tail is None else _stack_rows(index.tail, S, rows),
    )
