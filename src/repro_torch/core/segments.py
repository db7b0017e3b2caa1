"""Segmented dynamic LCCS index: online insert/delete over an LSM-style
segment stack (PyTorch port of `repro.core.segments`).

LCCS candidate scoring is pointwise per object, so per-segment top-lambda
candidate sets merge exactly.  That makes a mutable corpus an LSM problem:

  * a small append-only *delta buffer* holds the newest hash strings and is
    scored brute-force through `circrun_topk` (exact LCCS lengths, ranked
    by the circrun kernels on the card),
  * a stack of immutable CSA *segments* (each built with `build_csa`)
    answers lambda-LCCS searches through any registered candidate source,
    sharing ONE LSH family so hash strings are comparable everywhere,
  * a *tombstone* mask over global ids makes `delete` an O(batch) write;
    dead rows are filtered at candidate time and their hash strings are
    dropped at the next compaction (the vector store is global-id
    addressed, so its rows are reclaimed only by `vacuum()`, which
    renumbers ids),
  * `compact()` is a size-tiered merge: the buffer plus every segment no
    larger than the running merge total is rebuilt into one new segment,
  * `ingest_chunks` is the out-of-core bulk load: row blocks are written
    like `insert` batches, but their hash strings bypass the buffer into
    one new segment built by the chunked CSA merge
    (`csa.build_csa_chunked`).

Segment sizes and the buffer capacity follow the reference's power-of-two
schedule; padded rows hold the int32-max sentinel string and gid -1.  All
tables stay on the index's device: `compact` and `vacuum` select and move
rows with tensor ops, with no host round trip.  Unlike the reference, the
port writes new rows into the store, tail, tombstones and buffer in place,
and keeps the two counters (`n_alloc`, `buf_fill`) as Python ints.

Usage::

    from repro_torch.core import SegmentedLCCSIndex, SearchParams

    index = SegmentedLCCSIndex.create(d=128, m=64, family="euclidean", w=4.0)  # CUDA
    ids = index.insert(X0)                  # global ids, O(batch)
    index.delete(ids[:10])                  # tombstones, O(batch)
    index.compact()                         # size-tiered merge -> CSA segment
    out_ids, dists = index.search(Q, SearchParams(k=10, lam=200))

`params.source` names the *per-segment* source ("lccs", "bruteforce",
"multiprobe-*"); `search` rewrites it to the registered "segmented" source
with `inner=<source>`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..exec import execute as _execute
from ..exec import stages as exec_stages
from ..store import make_store
from . import lsh as lsh_mod
from .bruteforce import circ_topk
from .csa import CSA, build_csa, build_csa_chunked
from .index import LCCSIndex, _reblock, resolve_device, rows_on
from .params import SearchParams
from .sources import get_source, register_source

_PAD_HASH = torch.iinfo(torch.int32).max  # sentinel hash value for padded rows
_MIN_CAP = 8


def _pow2_at_least(x: int) -> int:
    return max(_MIN_CAP, 1 << max(0, int(x) - 1).bit_length())


def _pad_hash(rows: int, m: int, device) -> torch.Tensor:
    return torch.full((rows, m), _PAD_HASH, dtype=torch.int32, device=device)


def _no_gids(rows: int, device) -> torch.Tensor:
    return torch.full((rows,), -1, dtype=torch.int32, device=device)


@dataclass
class Segment:
    """One immutable CSA segment.  Rows are padded to a power-of-two size
    with sentinel hash strings (gid = -1); padded rows sort past every real
    string and are masked out of the merged candidate set by gid."""

    h: torch.Tensor  # (cap_i, m) int32, sentinel-padded
    csa: CSA
    gid: torch.Tensor  # (cap_i,) int32 global ids, -1 on padded rows

    @property
    def cap(self) -> int:
        return self.h.shape[0]

    @staticmethod
    def build(h_rows: torch.Tensor, gids: torch.Tensor, *,
              chunk_rows: int | None = None) -> "Segment":
        """Pad (n, m) hash rows and their gids to the next power of two, and
        build the CSA over the padded strings, on the rows' device.
        `chunk_rows` routes the CSA through the out-of-core chunked merge
        (`build_csa_chunked`, bit-identical to the monolithic build -- the
        sentinel pad rows are just maximal strings)."""
        n, m = h_rows.shape
        cap = _pow2_at_least(n)
        h = _pad_hash(cap, m, h_rows.device)
        h[:n] = h_rows
        g = _no_gids(cap, h_rows.device)
        g[:n] = gids
        csa = build_csa(h) if chunk_rows is None else build_csa_chunked(h, chunk_rows=chunk_rows)
        return Segment(h=h, csa=csa, gid=g)


@dataclass
class SegmentedLCCSIndex:
    """Dynamic LCCS-LSH index: CSA segments + delta buffer + tombstones.

      family    shared LSH family
      store     `repro_torch.store` vector store over all vectors ever
                inserted, indexed by global id (quantized stores quantize on
                ingest)
      tail      (cap_n, d) fp32 rerank rows when the store is inexact; None
                for fp32 stores (kept in memory: disk-lazy tails are a
                static-index feature)
      alive     (cap_n,) bool tombstone mask (False = deleted or unallocated)
      segments  tuple of immutable `Segment`s, largest capacity first
      buf_h     (cap_b, m) delta-buffer hash strings, sentinel-padded
      buf_gid   (cap_b,) delta-buffer global ids, -1 on free slots
      n_alloc   number of allocated global ids
      buf_fill  used delta-buffer slots
    """

    family: Any
    store: Any
    alive: torch.Tensor
    segments: tuple[Segment, ...]
    buf_h: torch.Tensor
    buf_gid: torch.Tensor
    n_alloc: int
    buf_fill: int
    metric: str
    tail: torch.Tensor | None = None

    # a disk-lazy tail is a static-index feature; the attribute exists so the
    # shared verify stage treats both index classes alike
    tail_path = None
    # topology marker read by the `repro_torch.exec` dispatch
    topology = "segmented"

    # -- construction -------------------------------------------------------

    @staticmethod
    def create(
        d: int,
        *,
        m: int = 64,
        family: str = "euclidean",
        seed: int = 0,
        store: str = "fp32",
        device=None,
        **family_kw,
    ) -> "SegmentedLCCSIndex":
        """An empty dynamic index over R^d on `device` (None = CUDA), with the
        same family construction -- and therefore the same hash functions --
        as `LCCSIndex.build`.  Quantized stores ("bf16"/"int8") quantize each
        inserted batch on ingest and keep an in-memory fp32 tail for the
        exact rerank stage."""
        dev = resolve_device(device)
        fam = lsh_mod.make_family(family, seed, d, m, device=dev, **family_kw)
        zeros = torch.zeros((_MIN_CAP, d), dtype=torch.float32, device=dev)
        vstore = make_store(store, zeros)
        return SegmentedLCCSIndex(
            family=fam,
            store=vstore,
            alive=torch.zeros((_MIN_CAP,), dtype=torch.bool, device=dev),
            segments=(),
            buf_h=_pad_hash(_MIN_CAP, m, dev),
            buf_gid=_no_gids(_MIN_CAP, dev),
            n_alloc=0,
            buf_fill=0,
            metric=fam.metric,
            tail=None if vstore.exact else zeros.clone(),
        )

    @staticmethod
    def build(
        data,
        *,
        m: int = 64,
        family: str = "euclidean",
        seed: int = 0,
        compact: bool = True,
        store: str = "fp32",
        device=None,
        **family_kw,
    ) -> "SegmentedLCCSIndex":
        """Bulk-load: create + insert; `compact=True` immediately rolls the
        buffer into one CSA segment (the static-index layout)."""
        idx = SegmentedLCCSIndex.create(
            data.shape[1], m=m, family=family, seed=seed, store=store, device=device,
            **family_kw,
        )
        idx.insert(data)
        if compact:
            idx.compact(full=True)
        return idx

    # -- introspection ------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.buf_h.device

    @property
    def data(self) -> torch.Tensor:
        """(cap_n, d) fp32 view of the vector store (the exact tail when the
        store is quantized)."""
        return self.tail if self.tail is not None else self.store.dense()

    @property
    def d(self) -> int:
        return self.store.d

    @property
    def m(self) -> int:
        return self.buf_h.shape[1]

    @property
    def n_ids(self) -> int:
        return self.n_alloc

    @property
    def n_live(self) -> int:
        return int(self.alive.sum())

    @property
    def buffer_count(self) -> int:
        return self.buf_fill

    def segment_sizes(self) -> list[int]:
        """Live row count per segment (largest first by construction)."""
        return [int(self.alive[s.gid[s.gid >= 0].long()].sum()) for s in self.segments]

    def index_bytes(self) -> int:
        tot = self.buf_h.numel() * 4
        for s in self.segments:
            tot += s.h.numel() * 4 + sum(t.numel() * 4 for t in s.csa.tables() if t is not None)
        return tot

    def store_bytes(self) -> int:
        """Resident vector bytes: store + in-memory fp32 tail (if inexact)."""
        tot = self.store.nbytes()
        if self.tail is not None:
            tot += self.tail.numel() * 4
        return tot

    def total_bytes(self) -> int:
        """Full serving footprint: search structure + resident vectors."""
        return self.index_bytes() + self.store_bytes()

    # -- mutation -------------------------------------------------------------

    def _rows(self, X) -> torch.Tensor:
        X = rows_on(X, self.device)
        return X[None, :] if X.dim() == 1 else X

    def _write(self, X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The writer `insert` and `ingest_chunks` share: hash a batch,
        allocate its global ids, write its rows into the store (quantized on
        ingest) and the tail, and mark them alive.  Returns (hash strings,
        gids), both on the device."""
        b = X.shape[0]
        h = self.family.hash(X)
        n_ids = self.n_alloc
        self._grow_store(n_ids + b)
        rows = torch.arange(n_ids, n_ids + b, dtype=torch.int32, device=self.device)
        self.store = self.store.set_rows(rows, X)  # quantize on ingest
        if self.tail is not None:
            self.tail[n_ids:n_ids + b] = X
        self.alive[n_ids:n_ids + b] = True
        self.n_alloc = n_ids + b
        return h, rows

    def insert(self, X) -> np.ndarray:
        """Append a batch of vectors; returns their assigned global ids.
        O(batch) buffer appends -- no CSA work until `compact()`."""
        X = self._rows(X)
        b = X.shape[0]
        if b == 0:
            return np.zeros((0,), np.int32)
        n_ids, fill = self.n_alloc, self.buf_fill
        h, rows = self._write(X)
        self._grow_buffer(fill + b)
        self.buf_h[fill:fill + b] = h
        self.buf_gid[fill:fill + b] = rows
        self.buf_fill = fill + b
        return np.arange(n_ids, n_ids + b, dtype=np.int32)

    def ingest_chunks(self, chunks, *, chunk_rows: int | None = None,
                      compact: bool = True) -> np.ndarray:
        """Bulk streaming ingest -- the out-of-core fast path.

        Each chunk goes through the same writer as one `insert` batch (hash
        on the device, quantize into the store, tail and tombstone
        bookkeeping), but with `compact=True` (default) the hash strings
        bypass the delta buffer: they stay on the host and are rolled into
        ONE new CSA segment built by the chunked merge
        (`Segment.build(chunk_rows=)`, at the largest chunk's size), so
        neither the buffer nor the CSA construction holds an O(n)-row
        device transient.  Equivalent to `insert(chunk) for chunk in
        chunks; compact()` -- same gids, store and search results.
        `compact=False` lands the chunks as plain `insert` batches.

        `chunk_rows` re-blocks the incoming stream (and so sizes the merge
        chunks).  Returns the assigned global ids."""
        if chunk_rows is not None:
            chunks = _reblock(chunks, chunk_rows)
        if not compact:
            parts = [self.insert(chunk) for chunk in chunks]
            return np.concatenate(parts) if parts else np.zeros((0,), np.int32)
        h_parts: list[np.ndarray] = []
        gid_parts: list[np.ndarray] = []
        max_chunk = 0
        for chunk in chunks:
            X = self._rows(chunk)
            if X.shape[0] == 0:
                continue
            h, rows = self._write(X)
            h_parts.append(h.cpu().numpy())
            gid_parts.append(rows.cpu().numpy())
            max_chunk = max(max_chunk, X.shape[0])
            del X, h
        if not h_parts:
            return np.zeros((0,), np.int32)
        gids = np.concatenate(gid_parts)
        seg = Segment.build(torch.from_numpy(np.concatenate(h_parts)).to(self.device),
                            torch.from_numpy(gids).to(self.device), chunk_rows=max_chunk)
        self.segments = tuple(sorted(self.segments + (seg,), key=lambda sg: -sg.cap))
        return gids

    def delete(self, ids) -> int:
        """Tombstone a batch of global ids (idempotent); returns the number
        of rows that were live.  Physical removal happens at `compact()`."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.unique(np.atleast_1d(np.asarray(ids)).astype(np.int64))
        if ids.size == 0:
            return 0
        if (ids < 0).any() or (ids >= self.n_ids).any():
            raise IndexError(
                f"delete ids must be in [0, {self.n_ids}), got [{ids.min()}, {ids.max()}]"
            )
        t = torch.from_numpy(ids).to(self.device)
        was_live = int(self.alive[t].sum())
        self.alive[t] = False
        return was_live

    def _live(self, gid: torch.Tensor) -> torch.Tensor:
        return (gid >= 0) & self.alive[torch.clamp(gid, min=0).long()]

    def compact(self, *, full: bool = False) -> int:
        """Size-tiered merge (LSM style): roll the live delta-buffer rows,
        plus every segment no larger than the running merge total (smallest
        first), into one new CSA segment; drop tombstoned rows physically.
        `full=True` merges everything into a single segment.  Returns the
        number of rows in the new segment (0 = nothing to merge)."""
        fill = self.buf_fill
        bg = self.buf_gid[:fill]
        buf_mask = self._live(bg)
        h_rows, gid_rows = [self.buf_h[:fill][buf_mask]], [bg[buf_mask]]
        total = h_rows[0].shape[0]
        keep: list[Segment] = []
        # smallest-first cascade: a segment joins the merge while its live
        # size is <= the rows already being merged (tiering invariant), so
        # big segments are rewritten only when the merge has grown to match
        for seg in sorted(self.segments, key=lambda s: s.cap):
            live = self._live(seg.gid)
            n_live = int(live.sum())
            if full or n_live == 0 or n_live <= max(total, 1):
                h_rows.append(seg.h[live])
                gid_rows.append(seg.gid[live])
                total += n_live
            else:
                keep.append(seg)
        if total:
            keep.append(Segment.build(torch.cat(h_rows), torch.cat(gid_rows)))
        del h_rows, gid_rows
        self.segments = tuple(sorted(keep, key=lambda s: -s.cap))
        self.buf_h = _pad_hash(_MIN_CAP, self.m, self.device)
        self.buf_gid = _no_gids(_MIN_CAP, self.device)
        self.buf_fill = 0
        return total

    def vacuum(self) -> np.ndarray:
        """Reclaim the vector store: drop tombstoned rows (which `compact`
        cannot touch -- global ids are store addresses) and renumber the live
        rows densely in insertion order, rebuilding one CSA segment.  Returns
        the old->new id map, -1 for dead ids; previously handed-out gids are
        invalid afterwards."""
        n_ids = self.n_ids
        old = self.alive[:n_ids].nonzero()[:, 0]
        remap = np.full((n_ids,), -1, np.int32)
        remap[old.cpu().numpy()] = np.arange(old.numel(), dtype=np.int32)
        # rebuild from the exact tail when present; requantization of already
        # dequantized rows is lossless for the symmetric int8 layout
        live_vecs = self.data[old]
        dev, d = self.device, self.d
        zeros = torch.zeros((_MIN_CAP, d), dtype=torch.float32, device=dev)
        self.store = make_store(self.store.kind, zeros)
        if self.tail is not None:
            self.tail = zeros.clone()
        self.alive = torch.zeros((_MIN_CAP,), dtype=torch.bool, device=dev)
        self.buf_h = _pad_hash(_MIN_CAP, self.m, dev)
        self.buf_gid = _no_gids(_MIN_CAP, dev)
        self.n_alloc = 0
        self.buf_fill = 0
        self.segments = ()
        if old.numel():
            self.insert(live_vecs)  # same family -> identical hash strings
            self.compact(full=True)
        return remap

    def _grow_store(self, need: int) -> None:
        cap = self.store.n
        if need <= cap:
            return
        new_cap = _pow2_at_least(need)
        self.store = self.store.padded_to(new_cap)
        if self.tail is not None:
            self.tail = torch.cat([self.tail, self.tail.new_zeros((new_cap - cap, self.d))])
        self.alive = torch.cat([self.alive, self.alive.new_zeros((new_cap - cap,))])

    def _grow_buffer(self, need: int) -> None:
        cap = self.buf_h.shape[0]
        if need <= cap:
            return
        new_cap = _pow2_at_least(need)
        self.buf_h = torch.cat([self.buf_h, _pad_hash(new_cap - cap, self.m, self.device)])
        self.buf_gid = torch.cat([self.buf_gid, _no_gids(new_cap - cap, self.device)])

    # -- search -------------------------------------------------------------

    def search(self, queries, params: SearchParams | None = None):
        """c-k-ANNS over the live corpus on the index's device.
        `params.source` picks the per-segment candidate source; the segmented
        topology adapter rewrites it onto the "segmented" source
        (source="segmented", inner=<source>)."""
        return _execute(self, queries, params)


# ---------------------------------------------------------------------------
# The "segmented" candidate source
# ---------------------------------------------------------------------------


def _buffer_topk(index: SegmentedLCCSIndex, qh: torch.Tensor, lam: int):
    """Exact LCCS scoring of the delta buffer (`circ_topk`: the circrun
    scorer and top-k kernels on the card); dead and free slots score -1 and
    are dropped."""
    ok = index._live(index.buf_gid)
    vals, slot = circ_topk(index.buf_h, qh, min(lam, index.buf_h.shape[0]), ok)
    hit = vals >= 0
    ids = torch.where(hit, index.buf_gid[slot.long()], torch.full_like(slot, -1))
    return exec_stages.pad_candidates(ids, torch.where(hit, vals, torch.full_like(vals, -1)), lam)


@register_source("segmented")
def segmented_source(index, queries, qh, params):
    """Per-segment `params.inner` search + delta-buffer scorer: local ids map
    to global ids (`local_to_global`), tombstones are masked (`mask_dead`),
    and the per-part top-lambda sets merge exactly (`merge_candidates` --
    LCCS scoring is pointwise)."""
    if not isinstance(index, SegmentedLCCSIndex):
        raise TypeError(
            "source='segmented' needs a SegmentedLCCSIndex; monolithic "
            "LCCSIndex callers should pick 'lccs'/'bruteforce'/'multiprobe-*'"
        )
    inner = get_source(params.inner)
    parts_ids, parts_lcps = [], []
    for seg in index.segments:
        view = LCCSIndex(family=index.family, store=index.store, h=seg.h, csa=seg.csa,
                         metric=index.metric, tail=index.tail)
        local_ids, lcps = inner(view, queries, qh, params)
        g = exec_stages.local_to_global(local_ids, seg.gid)
        g, lcps = exec_stages.mask_dead(g, lcps, index.alive)
        parts_ids.append(g)
        parts_lcps.append(lcps)
    b_ids, b_lcps = _buffer_topk(index, qh, params.lam)
    parts_ids.append(b_ids)
    parts_lcps.append(b_lcps)
    return exec_stages.merge_candidates(torch.cat(parts_ids, dim=1),
                                        torch.cat(parts_lcps, dim=1), params.lam)
