"""Baseline ANN methods (paper §6.3) sharing repro_torch.core's LSH families;
PyTorch port of `repro.baselines.methods`.

Where the work runs:

  * hashing on the method's device through the family (`hash_rp` /
    `hash_xp` kernels on CUDA, their plain versions on the CPU);
  * the static frameworks' bucket tables and their lookups on the host
    (numpy, as in the reference), one query at a time;
  * the verify on the device: candidate ids go there for
    `core.index.verify_candidates` (the fused `gather_l2_topk` on CUDA);
  * C2LSH's collision count and LinearScan's scan as plain torch on the
    device, in chunks of queries (and rows) that bound their temporaries.

Every ranking breaks ties toward the lower index, as `lax.top_k` does in
the reference.  Each `build` takes `family` as a name (the family is then
drawn from `seed`) or as a family object, for example one carried across
from the reference with `core.lsh.family_from_arrays`; the t1 coefficients
come from `np.random.default_rng(seed + 1)`, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core import lsh as lsh_mod
from ..core import multiprobe
from ..core.index import resolve_device, verify_candidates

_PRIME = (1 << 31) - 1  # classic E2LSH t1-hash modulus
# bytes of the (queries, rows, d) float32 temporaries of one LinearScan chunk
_SCAN_BYTES = 1 << 30
# (queries, rows) int64 ranking keys of one C2LSH chunk: 1 GiB
_COUNT_KEYS = 1 << 27


def _tensor(x, dev: torch.device) -> torch.Tensor:
    """Rows or queries as a contiguous float32 tensor on `dev`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return x.to(device=dev, dtype=torch.float32).contiguous()


def _rows(data, device) -> torch.Tensor:
    """(n, d) rows on `device` (None = CUDA; raises without it)."""
    return _tensor(data, resolve_device(device))


def _family(family, data: torch.Tensor, m: int, seed: int, w: float, fkw: dict):
    """The named family drawn from `seed` on data's device, or the given
    family object (m functions, on data's device)."""
    if isinstance(family, str):
        return lsh_mod.make_family(family, seed, data.shape[1], m, device=data.device,
                                   w=w, **fkw)
    if family.m != m:
        raise ValueError(f"the given family has {family.m} functions, the method needs {m}")
    if family.device.type != data.device.type:
        raise ValueError(f"the family lies on {family.device}, the data on {data.device}")
    return family


# ---------------------------------------------------------------------------


def _order_keys(dist: torch.Tensor, first_row: int) -> torch.Tensor:
    """Unique int64 keys ordered as (distance, row): the float's bits made
    order-preserving as a signed int32 (+0.0 for -0.0, which compares equal)
    above the row index."""
    bits = (dist + 0.0).view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    rows = torch.arange(first_row, first_row + dist.shape[1], dtype=torch.int64,
                        device=dist.device)
    return (key << 32) | rows


def _decode_keys(keys: torch.Tensor):
    hi = (keys >> 32).to(torch.int32)
    dist = torch.where(hi >= 0, hi, hi ^ 0x7FFFFFFF).view(torch.float32)
    return (keys & 0xFFFFFFFF).to(torch.int32), dist


def scan_nearest(data: torch.Tensor, queries: torch.Tensor, k: int, metric: str):
    """The k nearest rows of `data` per query by `lsh.distance` on the
    broadcast (query, row) pairs, ties to the lower row (`lax.top_k(-d, k)`
    of the reference).  Queries and rows go in chunks whose (Bc, nc, d)
    temporaries hold about 1 GiB; each chunk's best k merge with the
    running best through unique (distance, row) keys.
    Returns (ids (B, k) int32, dists (B, k) float32)."""
    n, d = data.shape
    B = queries.shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"k must lie in [0, n = {n}], got {k}")
    pairs = max(1, _SCAN_BYTES // (4 * d))
    bq = max(1, min(B, 1024, pairs // 256))  # at least 256 rows a chunk where it fits
    nc = max(1, pairs // bq)
    ids = torch.empty((B, k), dtype=torch.int32, device=data.device)
    dists = torch.empty((B, k), dtype=torch.float32, device=data.device)
    for lo in range(0, B, bq):
        qc = queries[lo:lo + bq, None, :]
        best = None
        for r0 in range(0, n, nc):
            dist = lsh_mod.distance(data[None, r0:r0 + nc, :], qc, metric)
            keys = _order_keys(dist, r0)
            if best is not None:
                keys = torch.cat([best, keys], dim=1)
            best = torch.topk(keys, min(k, keys.shape[1]), dim=1, largest=False).values
        ids[lo:lo + bq], dists[lo:lo + bq] = _decode_keys(best)
    return ids, dists


@dataclass
class LinearScan:
    """Exact scan; the recall/ratio ground truth."""

    data: torch.Tensor
    metric: str = "euclidean"

    @staticmethod
    def build(data, metric="euclidean", device=None, **_):
        return LinearScan(_rows(data, device), metric)

    def query(self, queries, k=10, **_):
        return scan_nearest(self.data, _tensor(queries, self.data.device), k, self.metric)

    def stats(self):
        return {"tables": 0, "hash_fns": 0, "index_bytes": 0}


# ---------------------------------------------------------------------------
# Static concatenating framework
# ---------------------------------------------------------------------------


class _StaticTables:
    """L sorted tables of compound bucket ids (host-side numpy lookups)."""

    def __init__(self, buckets: np.ndarray):  # (n, L) int64
        self.n, self.L = buckets.shape
        self.order = np.argsort(buckets, axis=0, kind="stable")  # (n, L)
        self.sorted = np.take_along_axis(buckets, self.order, axis=0)

    def lookup(self, q_buckets: np.ndarray, cap_per_table: int) -> np.ndarray:
        """q_buckets: (P, L) probe buckets -> candidate ids (deduped, 1-D)."""
        out = []
        for t in range(self.L):
            col = self.sorted[:, t]
            los = np.searchsorted(col, q_buckets[:, t], side="left")
            his = np.searchsorted(col, q_buckets[:, t], side="right")
            for lo, hi in zip(los, his):
                hi = min(hi, lo + cap_per_table)
                if hi > lo:
                    out.append(self.order[lo:hi, t])
        if not out:
            return np.empty((0,), np.int64)
        return np.unique(np.concatenate(out))

    def nbytes(self) -> int:
        return self.order.nbytes + self.sorted.nbytes


def _compound_buckets(h: np.ndarray, coefs: np.ndarray) -> np.ndarray:
    """(.., L, K) int hash values -> (.., L) compound bucket ids (t1 hashing)."""
    return (h.astype(np.int64) * coefs[None, :, :]).sum(-1) % _PRIME


@dataclass
class E2LSH:
    """Static concatenating framework: G_l(o) = (h_{l,1}(o) ... h_{l,K}(o))."""

    family: Any
    tables: _StaticTables
    coefs: np.ndarray
    data: torch.Tensor
    metric: str
    K: int
    L: int

    @staticmethod
    def build(data, *, K=8, L=16, w=4.0, family="euclidean", seed=0, device=None, **fkw):
        data = _rows(data, device)
        n = data.shape[0]
        fam = _family(family, data, K * L, seed, w, fkw)
        h = fam.hash(data).cpu().numpy().reshape(n, L, K)
        rng = np.random.default_rng(seed + 1)
        coefs = rng.integers(1, _PRIME, size=(L, K), dtype=np.int64)
        tables = _StaticTables(_compound_buckets(h, coefs))
        return E2LSH(fam, tables, coefs, data, fam.metric, K, L)

    def _hash_queries(self, queries: torch.Tensor) -> np.ndarray:
        """(B, d) queries on the device -> (B, L, K) host hash values."""
        return self.family.hash(queries).cpu().numpy().reshape(-1, self.L, self.K)

    def _verify(self, queries: torch.Tensor, ids: np.ndarray, k: int):
        cand = torch.from_numpy(ids).to(self.data.device)
        return verify_candidates(self.data, queries, cand, k, self.metric)

    def query(self, queries, k=10, cap_per_table=64, lam=None, **_):
        queries = _tensor(queries, self.data.device)
        qb = _compound_buckets(self._hash_queries(queries), self.coefs)
        B = queries.shape[0]
        lam = lam or max(k, 100)
        ids = np.full((B, lam), -1, np.int32)
        self.last_cands = 0
        for b in range(B):
            cand = self.tables.lookup(qb[b : b + 1], cap_per_table)[:lam]
            ids[b, : len(cand)] = cand
            self.last_cands += len(cand)
        return self._verify(queries, ids, k)

    def stats(self):
        return {
            "tables": self.L,
            "hash_fns": self.K * self.L,
            "index_bytes": self.tables.nbytes(),
        }


@dataclass
class MultiProbeLSH(E2LSH):
    """E2LSH tables + Lv et al. 2007 probing: perturb the K-dim compound key
    of each table in ascending boundary-distance score order."""

    n_probes: int = 8

    @staticmethod
    def build(data, *, K=8, L=8, w=4.0, family="euclidean", seed=0, n_probes=8, device=None,
              **fkw):
        base = E2LSH.build(data, K=K, L=L, w=w, family=family, seed=seed, device=device, **fkw)
        return MultiProbeLSH(
            base.family, base.tables, base.coefs, base.data, base.metric, base.K,
            base.L, n_probes=n_probes,
        )

    def query(self, queries, k=10, cap_per_table=64, lam=None, n_probes=None, **_):
        queries = _tensor(queries, self.data.device)
        n_probes = n_probes or self.n_probes
        B = queries.shape[0]
        lam = lam or max(k, 100)
        hq_all = self._hash_queries(queries)
        # the whole batch's alternatives in one call: row b holds what
        # `family.query_alternatives(queries[b])` gives (the family's
        # default n_alt), without a launch a query
        vals_all, scores_all = self.family.alternatives(queries)
        vals_all = vals_all.cpu().numpy().reshape(B, self.L, self.K, -1)
        scores_all = scores_all.cpu().numpy().reshape(B, self.L, self.K, -1)
        ids = np.full((B, lam), -1, np.int32)
        self.last_cands = 0
        for b in range(B):
            alt_vals, alt_scores = vals_all[b], scores_all[b]
            probe_buckets = []
            for t in range(self.L):
                deltas = multiprobe.generate_perturbations(
                    alt_scores[t], n_probes, max_gap=self.K
                )
                hq = hq_all[b, t]
                base_bucket = int(
                    (hq.astype(np.int64) * self.coefs[t]).sum() % _PRIME
                )
                row = []
                for delta in deltas:
                    bb = base_bucket
                    for i, j in delta:
                        bb = (
                            bb
                            + int(self.coefs[t, i])
                            * (int(alt_vals[t, i, j]) - int(hq[i]))
                        ) % _PRIME
                    row.append(bb)
                probe_buckets.append(row)
            pb = np.asarray(probe_buckets, np.int64).T  # (P, L)
            cand = self.tables.lookup(pb, cap_per_table)[:lam]
            ids[b, : len(cand)] = cand
            self.last_cands += len(cand)
        return self._verify(queries, ids, k)


class FALCONNLike(MultiProbeLSH):
    """Cross-polytope static tables + vertex probing (Andoni et al. 2015)."""

    @staticmethod
    def build(data, *, K=2, L=16, family="angular", seed=0, n_probes=8, device=None, **fkw):
        fam = "angular" if isinstance(family, str) else family
        base = E2LSH.build(data, K=K, L=L, family=fam, seed=seed, device=device, **fkw)
        return FALCONNLike(
            base.family, base.tables, base.coefs, base.data, base.metric, base.K,
            base.L, n_probes=n_probes,
        )


# ---------------------------------------------------------------------------
# Dynamic collision counting framework
# ---------------------------------------------------------------------------


def collision_topk(h: torch.Tensor, qh: torch.Tensor, k: int):
    """The k rows of `h` (n, m) with the most positions equal to each query
    string of `qh` (B, m), ties to the lower row (the reference's
    `lax.top_k` over its dense (B, n, m) indicator summed over m).  The
    count runs one function at a time over chunks of queries whose int64
    ranking keys hold 1 GiB.  Returns (counts, rows), (B, k) int32 each."""
    n, m = h.shape
    B = qh.shape[0]
    hT = h.t().contiguous()  # (m, n): one function's column is contiguous
    count_dtype = torch.uint8 if m < 256 else torch.int32
    vals = torch.empty((B, k), dtype=torch.int32, device=h.device)
    rows = torch.empty((B, k), dtype=torch.int32, device=h.device)
    step = max(1, _COUNT_KEYS // max(1, n))
    for lo in range(0, B, step):
        qc = qh[lo:lo + step]
        counts = torch.zeros((qc.shape[0], n), dtype=count_dtype, device=h.device)
        for j in range(m):
            counts += hT[j][None, :] == qc[:, j, None]
        vals[lo:lo + step], rows[lo:lo + step] = lsh_mod.topk_largest_lcp(counts, k)
    return vals, rows


@dataclass
class C2LSH:
    """Gan et al. 2012: m single-function tables; o is a candidate once its
    collision count reaches l.  The count is computed densely, a function at
    a time (identical result to per-table lookups)."""

    family: Any
    h: torch.Tensor  # (n, m) int32
    data: torch.Tensor
    metric: str
    l_threshold: int

    @staticmethod
    def build(data, *, m=64, w=4.0, family="euclidean", seed=0, l_threshold=None, device=None,
              **fkw):
        data = _rows(data, device)
        fam = _family(family, data, m, seed, w, fkw)
        h = fam.hash(data)
        return C2LSH(fam, h, data, fam.metric, l_threshold or max(2, m // 8))

    def query(self, queries, k=10, lam=None, l_threshold=None, **_):
        queries = _tensor(queries, self.data.device)
        lam = lam or max(k, 100)
        l_thr = l_threshold or self.l_threshold
        hq = self.family.hash(queries)  # (B, m)
        vals, idx = collision_topk(self.h, hq, min(lam, self.h.shape[0]))
        ids = torch.where(vals >= l_thr, idx, torch.full_like(idx, -1))
        self.last_cands = int((ids >= 0).sum())
        return verify_candidates(self.data, queries, ids, k, self.metric)

    def stats(self):
        m = self.h.shape[1]
        return {"tables": m, "hash_fns": m, "index_bytes": self.h.numel() * 4}
