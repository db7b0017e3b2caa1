"""LCCSIndex -- the public API of the paper's scheme (PyTorch port of
`repro.core.index`).

Indexing phase (§4.1): hash every object with m i.i.d. LSH functions into a
hash string; build the CSA.  Query phase: a *candidate source* proposes
lambda candidates, true distances are verified, and the nearest k are
returned.

Canonical usage::

    from repro_torch.core import LCCSIndex, SearchParams

    index = LCCSIndex.build(X, m=64, family="euclidean", w=4.0)   # on CUDA
    params = SearchParams(k=10, lam=200, source="multiprobe-skip", probes=17)
    ids, dists = index.search(Q, params)

`build` and `load` place the index on CUDA unless the caller passes
`device="cpu"`; without CUDA they raise instead of falling back.
`build(chunk_rows=)` and `build_streaming` are the out-of-core build: row
blocks are hashed, quantized and ranked one at a time on the device and the
CSA is merged on the host (`csa.csa_from_chunk_ranks`), bit-identical to
the monolithic build.  `shard(S)` partitions an index into S row shards
on its device (`repro_torch.shard`).  `search`
runs on the index's device: on CUDA the probe and verify stages launch the
hand-written kernels in `repro_torch.kernels`, on the CPU their plain
versions run.

Persistence: `save` writes the reference's pickle schema (numpy arrays and
Python scalars, the same `family_cls` / `store_kind` names), so each
package loads the other's indexes.
"""
from __future__ import annotations

import dataclasses
import pickle
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..exec import execute as _execute
from ..exec import stages as exec_stages
from ..obs.trace import span as _span
from ..store import concat_stores, get_store_cls, make_store
from ..store import stores as store_mod
from ..store import tail as tail_mod
from . import lsh as lsh_mod
from .csa import CSA, build_csa, circular_ranks, csa_from_chunk_ranks
from .device import resolve_device
from .params import SearchParams


def iter_row_blocks(data, chunk_rows: int):
    """Slice `data` into (<=chunk_rows, d) row blocks without materialising
    the whole array: plain `__getitem__` slicing, so an `np.memmap` (or any
    lazily-indexed source) is read one block at a time."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    n = data.shape[0]
    for lo in range(0, n, chunk_rows):
        yield data[lo : min(lo + chunk_rows, n)]


def _reblock(chunks, chunk_rows: int):
    """Re-block a chunk stream (numpy arrays or tensors) to exactly
    `chunk_rows` rows per yielded block (the last may be short).  Buffers at
    most one outgoing block plus one incoming chunk -- still O(chunk)
    memory."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")

    def joined(parts):
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts) if isinstance(parts[0], torch.Tensor) else np.concatenate(parts)

    buf: list = []
    fill = 0
    for chunk in chunks:
        if not isinstance(chunk, torch.Tensor):
            chunk = np.asarray(chunk)
        lo, n = 0, chunk.shape[0]
        while lo < n:
            take = min(chunk_rows - fill, n - lo)
            buf.append(chunk[lo : lo + take])
            fill += take
            lo += take
            if fill == chunk_rows:
                yield joined(buf)
                buf, fill = [], 0
    if fill:
        yield joined(buf)


def rows_on(x, dev: torch.device) -> torch.Tensor:
    """A row block (numpy, memmap or tensor) as a contiguous float32 tensor
    on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32).contiguous()
    a = np.ascontiguousarray(x, np.float32)
    if not a.flags.writeable:  # a read-only memmap block: the tensor must not alias it
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def _to_numpy(t):
    """Tensor -> numpy for the pickle (bf16 as ml_dtypes.bfloat16, the dtype
    the reference's arrays carry)."""
    if not isinstance(t, torch.Tensor):
        return t
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the dtype of bf16 arrays in the reference's pickles

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _to_tensor(a, device):
    """numpy -> tensor on `device` (ml_dtypes bfloat16 arrays included)."""
    if not isinstance(a, np.ndarray):
        return a
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclass
class LCCSIndex:
    """Static (build-once) LCCS-LSH index: hash strings + CSA snapshot.

    Vectors live in a pluggable `repro_torch.store` store (`store` field);
    inexact (quantized) stores pair with an fp32 `tail` for the exact rerank
    stage -- a tensor when in memory, or `tail_path` when disk-lazy."""

    family: Any  # LSH family (lsh.py)
    store: Any  # VectorStore holding the (n, d) corpus vectors
    h: torch.Tensor  # (n, m) int32 hash strings
    csa: CSA | None  # None for bruteforce-only indexes
    metric: str
    tail: torch.Tensor | None = None  # (n, d) fp32 rerank rows (inexact stores)
    tail_path: str | None = field(default=None)  # disk-lazy rerank target

    topology = "monolithic"

    # -- construction -------------------------------------------------------

    @staticmethod
    def build(
        data,
        *,
        m: int = 64,
        family: str = "euclidean",
        seed: int = 0,
        build_csa_structure: bool = True,
        store: str = "fp32",
        tail_path: str | Path | None = None,
        chunk_rows: int | None = None,
        device=None,
        **family_kw,
    ) -> "LCCSIndex":
        """Hash + CSA build over `data` (n, d) on `device` (None = CUDA),
        stored as the named vector store.  Quantized stores ("bf16",
        "int8") verify in two stages; their fp32 rerank tail is held in
        memory unless `tail_path` is given (then it is written as .npy and
        gathered lazily per batch).

        `chunk_rows` switches to the out-of-core path (`build_streaming`
        over row slices of `data`, read one block at a time): the result is
        bit-identical to the monolithic build for every chunk size."""
        if chunk_rows is not None:
            return LCCSIndex.build_streaming(
                iter_row_blocks(data, chunk_rows), m=m, family=family, seed=seed,
                build_csa_structure=build_csa_structure, store=store,
                tail_path=tail_path, device=device, **family_kw,
            )
        dev = resolve_device(device)
        data = rows_on(data, dev)
        n, d = data.shape
        fam = lsh_mod.make_family(family, seed, d, m, device=dev, **family_kw)
        h = fam.hash(data)
        csa = build_csa(h) if build_csa_structure else None
        vstore = make_store(store, data)
        tail = None
        tail_p = None
        if not vstore.exact:
            if tail_path is not None:
                tail_p = tail_mod.write_tail(tail_path, data.cpu().numpy())
            else:
                tail = data
        return LCCSIndex(family=fam, store=vstore, h=h, csa=csa,
                         metric=fam.metric, tail=tail, tail_path=tail_p)

    @staticmethod
    def build_streaming(
        chunks,
        *,
        m: int = 64,
        family: str = "euclidean",
        seed: int = 0,
        build_csa_structure: bool = True,
        store: str = "fp32",
        tail_path: str | Path | None = None,
        chunk_rows: int | None = None,
        device=None,
        **family_kw,
    ) -> "LCCSIndex":
        """Out-of-core `build` on `device` (None = CUDA): consume an
        iterator of (c_i, d) row blocks (numpy, memmap or tensor).

        Per block: hash on the device, quantize into a per-chunk store
        (per-row quantization makes the chunk-wise quantize bit-identical to
        the monolithic one), stream the fp32 rows to the disk tail
        (`tail_path`) when the store is inexact, and run `circular_ranks` on
        the chunk alone -- the device transients are O(chunk, m).  The
        per-chunk sorted orders are then merged into the global CSA on the
        host (`csa_from_chunk_ranks`), bit-identical to
        `build(concat(chunks))` for every chunking of the same rows.

        `chunk_rows` re-blocks the incoming stream to that block size; by
        default each yielded chunk is one CSA chunk.  The fp32 corpus is
        never resident on the device whole unless the store needs an
        in-memory tail (inexact store, `tail_path=None`) or is the fp32
        store itself."""
        dev = resolve_device(device)
        if chunk_rows is not None:
            chunks = _reblock(chunks, chunk_rows)
        fam = None
        writer: tail_mod.TailWriter | None = None
        h_parts: list[np.ndarray] = []
        sizes: list[int] = []
        ranks: list[np.ndarray] = []
        store_parts: list[Any] = []
        tail_parts: list[torch.Tensor] = []
        with _span("build.chunks"):
            for chunk in chunks:
                rows = rows_on(chunk, dev)
                if rows.dim() != 2 or rows.shape[0] == 0:
                    raise ValueError(f"chunks must be non-empty (c, d) blocks, "
                                     f"got shape {tuple(rows.shape)}")
                if fam is None:
                    fam = lsh_mod.make_family(family, seed, rows.shape[1], m, device=dev,
                                              **family_kw)
                with _span("build.hash"):
                    hc = fam.hash(rows)
                    h_parts.append(hc.cpu().numpy())
                sizes.append(rows.shape[0])
                if build_csa_structure:
                    with _span("build.ranks"):
                        ranks.append(circular_ranks(hc).cpu().numpy())
                part = make_store(store, rows)
                store_parts.append(part)
                if not part.exact:
                    if tail_path is not None:
                        if writer is None:
                            writer = tail_mod.TailWriter(tail_path, rows.shape[1])
                        writer.append(rows.cpu().numpy())
                    else:
                        tail_parts.append(rows)
                del rows, hc
        if fam is None:
            raise ValueError("build_streaming needs at least one chunk")
        vstore = concat_stores(store_parts)
        del store_parts
        h_host = np.concatenate(h_parts) if len(h_parts) > 1 else h_parts[0]
        del h_parts
        csa = None
        if build_csa_structure:
            csa = csa_from_chunk_ranks(h_host, sizes, ranks, device=dev)
            del ranks
        h = torch.from_numpy(h_host).to(dev)
        del h_host
        tail = None
        tail_p = writer.finalize() if writer is not None else None
        if tail_parts:
            tail = torch.cat(tail_parts) if len(tail_parts) > 1 else tail_parts[0]
        return LCCSIndex(family=fam, store=vstore, h=h, csa=csa,
                         metric=fam.metric, tail=tail, tail_path=tail_p)

    @property
    def device(self) -> torch.device:
        return self.h.device

    @property
    def data(self) -> torch.Tensor:
        """(n, d) float32 corpus view: the exact tail when resident, else the
        store's (possibly dequantized) reconstruction."""
        return self.tail if self.tail is not None else self.store.dense()

    @property
    def n(self) -> int:
        return self.store.n

    @property
    def m(self) -> int:
        return self.h.shape[1]

    def index_bytes(self) -> int:
        """CSA + hash strings footprint (paper's 'index size'), int32 tables."""
        tot = self.h.numel() * 4
        if self.csa is not None:
            tot += self.csa.I.numel() * 4 + self.csa.P.numel() * 4 + self.csa.Hd.numel() * 4
            if self.csa.L is not None:
                tot += self.csa.L.numel() * 4
        return tot

    def store_bytes(self) -> int:
        """Resident vector bytes: the store itself + any in-memory fp32 tail."""
        tot = self.store.nbytes()
        if self.tail is not None:
            tot += self.tail.numel() * 4
        return tot

    def total_bytes(self) -> int:
        """Full serving footprint: search structure + resident vectors."""
        return self.index_bytes() + self.store_bytes()

    # -- search -------------------------------------------------------------

    def search(self, queries, params: SearchParams | None = None):
        """c-k-ANNS: candidate generation + true-distance verification on the
        index's device.  Returns (ids (B, k) int32, dists (B, k) float32)."""
        return _execute(self, queries, params)

    def shard(self, shards: int):
        """Partition this index's rows into `shards` contiguous shards on its
        device: one CSA and one vector-store slice a shard under the shared
        family.  Returns a `repro_torch.shard.ShardedLCCSIndex` serving the
        same SearchParams pipeline shard by shard, with an exact global
        top-k merge (uneven row counts are padded and masked)."""
        from ..shard import shard_index

        return shard_index(self, shards)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str | Path) -> None:
        """Write the reference's pickle schema (readable by
        `repro.core.index.LCCSIndex.load`)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        fam_fields = {
            f.name: _to_numpy(getattr(self.family, f.name))
            for f in dataclasses.fields(self.family)
        }
        store_fields = {
            f.name: _to_numpy(getattr(self.store, f.name))
            for f in dataclasses.fields(self.store)
        }
        # a disk-lazy tail is embedded so the pickle is self-contained
        tail_arr = None if self.tail is None else _to_numpy(self.tail)
        if tail_arr is None and self.tail_path:
            tail_arr = np.load(self.tail_path)
        blob = {
            "family_cls": type(self.family).__name__,
            "family_fields": fam_fields,
            "store_kind": self.store.kind,
            "store_fields": store_fields,
            "tail": tail_arr,
            "tail_in_memory": self.tail is not None,
            "tail_path": self.tail_path,
            "h": _to_numpy(self.h),
            "csa": None if self.csa is None else [
                None if x is None else _to_numpy(x) for x in self.csa.tables()
            ],
            "metric": self.metric,
        }
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(blob, f)
        tmp.rename(path)  # atomic

    @staticmethod
    def load(path: str | Path, device=None) -> "LCCSIndex":
        """Read a pickle written by either package's `save` onto `device`
        (None = CUDA).  Only load files this program or the reference wrote:
        unpickling runs code."""
        dev = resolve_device(device)
        with open(path, "rb") as f:
            blob = pickle.load(f)
        fam = lsh_mod.family_from_arrays(blob["family_cls"], blob["family_fields"], dev)
        csa = None if blob["csa"] is None else CSA(
            *[None if x is None else _to_tensor(x, dev) for x in blob["csa"]]
        )
        if "store_kind" in blob:
            store_cls = get_store_cls(blob["store_kind"])
            vstore = store_cls(**{k: _to_tensor(v, dev)
                                  for k, v in blob["store_fields"].items()})
            tail_path = blob["tail_path"]
            if blob["tail"] is not None and not blob.get("tail_in_memory", True):
                # disk-lazy index: the embedded tail is the truth -- always
                # re-materialise it
                tail_path = tail_mod.write_tail(tail_path, blob["tail"])
                tail = None
            else:
                tail = None if blob["tail"] is None else _to_tensor(blob["tail"], dev)
        else:  # pre-store pickles: raw fp32 "data" array
            vstore = store_mod.Fp32Store.from_dense(_to_tensor(blob["data"], dev))
            tail, tail_path = None, None
        return LCCSIndex(
            family=fam,
            store=vstore,
            h=_to_tensor(blob["h"], dev),
            csa=csa,
            metric=blob["metric"],
            tail=tail,
            tail_path=tail_path,
        )


def verify_candidates(data: torch.Tensor, queries: torch.Tensor, cand_ids: torch.Tensor,
                      k: int, metric: str):
    """True distances of the candidates `cand_ids` (B, lam) int32, -1 padded,
    over the rows of `data` (n, d) float32, and the nearest k per query.
    Returns (ids (B, k) int32, dists (B, k) float32); missing slots are
    id -1, dist inf.  The port's exact verify (`exec.stages.exact_topk`)
    over an fp32 store that wraps `data` without a copy: the fused
    `gather_l2_topk` kernel on CUDA tensors, its plain version on CPU
    tensors (Euclidean and angular; other metrics take the plain scan)."""
    store = store_mod.Fp32Store.from_dense(data)
    queries = queries.to(device=store.rows.device, dtype=torch.float32).contiguous()
    cand_ids = cand_ids.to(device=store.rows.device, dtype=torch.int32).contiguous()
    return exec_stages.exact_topk(store, queries, cand_ids, cand_ids, k, metric,
                                  use_kernel=True)


# ---------------------------------------------------------------------------
# Functional search API
# ---------------------------------------------------------------------------


def candidates(index: LCCSIndex, queries, params: SearchParams):
    """Candidate generation only: the hash + probe stages.  Returns
    (ids, lcps): (B, lam) int32 each, -1 padded."""
    if getattr(index, "sharded", False) and params.source != "sharded":
        raise TypeError(
            f"a ShardedLCCSIndex holds per-shard CSAs; source="
            f"{params.source!r} would read them as one flat index -- use "
            f"SearchParams(source='sharded', inner={params.source!r})"
        )
    queries = torch.as_tensor(queries, dtype=torch.float32).to(index.device)
    qh = exec_stages.hash_queries(index.family, queries)
    return exec_stages.probe(index, queries, qh, params)


def search(index: LCCSIndex, queries, params: SearchParams):
    """Full c-k-ANNS pipeline body (hash -> probe -> verify) with `params`
    used as given (no toggle pinning).  A disk-lazy tail needs the split
    plan: call `index.search` for that."""
    from ..exec.topology import search_pipeline

    if getattr(index, "sharded", False):
        raise TypeError(
            "a ShardedLCCSIndex verifies per shard before the global merge; "
            "call index.search(queries, params) or repro_torch.shard.search -- "
            "this monolithic pipeline would mis-gather its stacked store"
        )
    if not index.store.exact and index.tail is None and index.tail_path:
        raise ValueError(
            "this index's fp32 rerank tail is disk-lazy (tail_path="
            f"{index.tail_path!r}); call index.search(queries, params) instead"
        )
    queries = torch.as_tensor(queries, dtype=torch.float32).to(index.device)
    return search_pipeline(index, queries, params)
