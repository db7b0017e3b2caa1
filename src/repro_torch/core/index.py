"""LCCSIndex -- the public API of the paper's scheme (PyTorch port of
`repro.core.index`, monolithic build).

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
`device="cpu"`; without CUDA they raise instead of falling back.  `search`
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
from ..store import get_store_cls, make_store
from ..store import stores as store_mod
from ..store import tail as tail_mod
from . import lsh as lsh_mod
from .csa import CSA, build_csa
from .params import SearchParams


def resolve_device(device=None) -> torch.device:
    """None -> CUDA.  Raises when CUDA is asked for but absent: the port never
    drops to the CPU on its own (pass device="cpu" for that)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; pass device='cpu' to build "
            "or load an index on the CPU"
        )
    return dev


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
        device=None,
        **family_kw,
    ) -> "LCCSIndex":
        """Hash + CSA build over `data` (n, d) on `device` (None = CUDA),
        stored as the named vector store.  Quantized stores ("bf16",
        "int8") verify in two stages; their fp32 rerank tail is held in
        memory unless `tail_path` is given (then it is written as .npy and
        gathered lazily per batch)."""
        dev = resolve_device(device)
        if isinstance(data, torch.Tensor):
            data = data.to(device=dev, dtype=torch.float32)
        else:
            data = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(dev)
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

    # -- search -------------------------------------------------------------

    def search(self, queries, params: SearchParams | None = None):
        """c-k-ANNS: candidate generation + true-distance verification on the
        index's device.  Returns (ids (B, k) int32, dists (B, k) float32)."""
        return _execute(self, queries, params)

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
    queries = torch.as_tensor(queries, dtype=torch.float32).to(index.device)
    qh = exec_stages.hash_queries(index.family, queries)
    return exec_stages.probe(index, queries, qh, params)


def search(index: LCCSIndex, queries, params: SearchParams):
    """Full c-k-ANNS pipeline body (hash -> probe -> verify) with `params`
    used as given (no toggle pinning).  A disk-lazy tail needs the split
    plan: call `index.search` for that."""
    from ..exec.topology import search_pipeline

    if not index.store.exact and index.tail is None and index.tail_path:
        raise ValueError(
            "this index's fp32 rerank tail is disk-lazy (tail_path="
            f"{index.tail_path!r}); call index.search(queries, params) instead"
        )
    queries = torch.as_tensor(queries, dtype=torch.float32).to(index.device)
    return search_pipeline(index, queries, params)
