"""SearchPlan: one built, cached execution plan per (params, topology)
(PyTorch port of `repro.exec.plan`).

`compile_plan(index, queries, params)` resolves the caller's `SearchParams`
against the index's topology (source rewrites, kernel toggles pinned, store
pin checked), builds the topology's runner, and caches it in an explicit
`PlanCache` keyed on

    (topology, instrument, resolved params, index signature,
     query batch shape)

-- the reference's key, where the JAX pytree's structure and leaf shapes
become `index_signature` below.  PyTorch runs eagerly, so a plan holds the
built runner and no captured graph: a cache hit means no rebuild, a miss is
a build, and the counters (on the metrics registry, per scope) let a serving
loop show that it does not rebuild.

A topology adapter is two functions, and an optional third:

    resolve(index, params) -> SearchParams   validate + rewrite
    build(index, params)   -> run(index, queries) -> (ids, dists)
    build_instrumented(index, params) -> run   the same stages, each fenced
                                               and timed into the registry
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from ..obs.registry import registry
from ..obs.trace import fence
from ..obs.trace import stage as _stage

if TYPE_CHECKING:  # pragma: no cover
    from ..core.params import SearchParams

Runner = Callable[[Any, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


# ---------------------------------------------------------------------------
# Topology adapter registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TopologyAdapter:
    name: str
    resolve: Callable[[Any, "SearchParams"], "SearchParams"]
    build: Callable[[Any, "SearchParams"], Runner]
    # the staged variant: same results, each stage fenced and timed into
    # repro_exec_stage_seconds.  None = the whole runner timed as one stage.
    build_instrumented: Callable[[Any, "SearchParams"], Runner] | None = None


_TOPOLOGIES: dict[str, TopologyAdapter] = {}


def register_topology(name: str, *, resolve, build,
                      build_instrumented=None) -> TopologyAdapter:
    """Register a topology adapter (re-registering overwrites)."""
    adapter = TopologyAdapter(name=name, resolve=resolve, build=build,
                              build_instrumented=build_instrumented)
    _TOPOLOGIES[name] = adapter
    return adapter


def available_topologies() -> tuple[str, ...]:
    return tuple(sorted(_TOPOLOGIES))


def topology_of(index) -> str:
    """An index declares its topology via a `topology` class attribute;
    unmarked index-likes default to monolithic."""
    return getattr(index, "topology", "monolithic")


def get_topology(name: str) -> TopologyAdapter:
    try:
        return _TOPOLOGIES[name]
    except KeyError:
        raise KeyError(
            f"unknown index topology {name!r}; available: {available_topologies()}"
        ) from None


# ---------------------------------------------------------------------------
# The plan + its cache
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SearchPlan:
    """A built staged search pipeline, pinned to one (topology, resolved
    params, index signature, query shape) key.  Calling it with any index
    and queries matching the key reuses the same runner."""

    topology: str
    params: "SearchParams"  # resolved: sources rewritten, kernel toggles pinned
    key: tuple = field(repr=False)
    run: Runner = field(repr=False)
    instrumented: bool = False

    def __call__(self, index, queries):
        return self.run(index, torch.as_tensor(queries, dtype=torch.float32).to(index.device))


# the global scope label for unattributed cache activity (scope=None callers)
_UNSCOPED = ""


class PlanCache:
    """LRU cache of `SearchPlan`s with hit/miss/eviction counters carried
    on the metrics registry (`repro_torch.obs`) with per-scope labels --
    `hits`/`misses`/`evictions` and `scopes` are views over the registry
    counters, so a Prometheus scrape and `stats()` never disagree.

    misses == number of plans built.  Evictions are charged to the scope
    that *built* the evicted plan: the replica churning through plan shapes
    is the one named, not whoever inserted the plan that pushed it out."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._hits = registry().counter(
            "repro_plan_cache_hits_total",
            "compiled search plans reused from the exec plan cache",
            labelnames=("scope",),
        )
        self._misses = registry().counter(
            "repro_plan_cache_misses_total",
            "staged-pipeline compiles (plan cache misses)",
            labelnames=("scope",),
        )
        self._evictions = registry().counter(
            "repro_plan_cache_evictions_total",
            "plans evicted from the LRU plan cache, labeled by the scope "
            "that built them",
            labelnames=("scope",),
        )
        # key -> (plan, builder scope): the scope rides along so an eviction
        # is charged to the caller whose build it undoes
        self._plans: OrderedDict[tuple, tuple[SearchPlan, str]] = OrderedDict()  # guarded-by: _lock
        self._lock = threading.Lock()

    # -- registry-backed counter views ---------------------------------------

    @property
    def hits(self) -> int:
        return int(self._hits.value())

    @property
    def misses(self) -> int:
        return int(self._misses.value())

    @property
    def evictions(self) -> int:
        return int(self._evictions.value())

    @property
    def scopes(self) -> dict[str, dict[str, int]]:
        """Per-scope {hits, misses, evictions} (the serving front passes each
        replica engine's name as its scope)."""
        out: dict[str, dict[str, int]] = {}
        for field_name, counter in (("hits", self._hits),
                                    ("misses", self._misses),
                                    ("evictions", self._evictions)):
            for (scope,), val in counter.collect().items():
                if scope == _UNSCOPED:
                    continue
                out.setdefault(
                    scope, {"hits": 0, "misses": 0, "evictions": 0}
                )[field_name] = int(val)
        return out

    def scope_evictions(self, scope: str | None) -> int:
        """Evictions charged to one scope (engine stats mirror this)."""
        if scope is None:
            return 0
        return int(self._evictions.value(scope=scope))

    def get_or_build(self, key: tuple, builder: Callable[[], SearchPlan],
                     scope: str | None = None) -> tuple:
        """Fetch or build the plan for `key`.  Returns (plan, hit): callers
        that attribute cache activity (engine stats) use the per-call `hit`
        flag rather than diffing the global counters, which would absorb
        concurrent callers' activity.  `scope` labels the outcome in the
        registry counters."""
        label = _UNSCOPED if scope is None else scope
        with self._lock:
            entry = self._plans.get(key)
            if entry is not None:
                self._plans.move_to_end(key)
        if entry is not None:
            self._hits.inc(scope=label)
            return entry[0], True
        # build outside the lock; double-building on a race is harmless
        # (last writer wins)
        plan = builder()
        evicted: list[str] = []
        with self._lock:
            self._plans[key] = (plan, label)
            self._plans.move_to_end(key)
            while len(self._plans) > self.maxsize:
                _, (_, owner) = self._plans.popitem(last=False)
                evicted.append(owner)
        self._misses.inc(scope=label)
        for owner in evicted:
            self._evictions.inc(scope=owner)
        return plan, False

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "size": len(self),
            "scopes": self.scopes,
        }

    def clear(self) -> None:
        """Drop every plan and zero the counters (test isolation)."""
        with self._lock:
            self._plans.clear()
        self._hits.reset()
        self._misses.reset()
        self._evictions.reset()


_CACHE = PlanCache()


def plan_cache() -> PlanCache:
    """The process-global plan cache."""
    return _CACHE


# ---------------------------------------------------------------------------
# The index signature
# ---------------------------------------------------------------------------

# (data fields, meta fields) per class: the reference's pytree registrations
# (`repro/core/index.py:466-470`, `repro/core/segments.py:107-109,483-487`,
# `repro/shard/index.py:198-202`, `repro/core/lsh.py:275-282`,
# `repro/store/stores.py:249-251`, and `CSA`, a NamedTuple there).  A data
# field enters the signature as its shape and dtype (a Python int counter as
# a scalar), so new values keep the plan; a meta field enters by value, as
# the treedef's static aux does.
_PYTREE_FIELDS: dict[str, tuple[tuple[str, ...], tuple[str, ...]]] = {
    "LCCSIndex": (("family", "store", "h", "csa", "tail"), ("metric", "tail_path")),
    "SegmentedLCCSIndex": (("family", "store", "alive", "segments", "buf_h", "buf_gid",
                            "n_alloc", "buf_fill", "tail"), ("metric",)),
    "Segment": (("h", "csa", "gid"), ()),
    # the reference's mesh and axis are static aux there; the port has no
    # mesh, and the shard count is the leading axis of every leaf
    "ShardedLCCSIndex": (("family", "store", "h", "csa", "gid", "tail"),
                         ("metric", "n_rows")),
    "CSA": (("I", "P", "Hd", "L"), ()),
    "RandomProjectionLSH": (("a", "b"), ("w", "metric")),
    "CrossPolytopeLSH": (("signs", "rot"), ("d", "dr", "rotation", "metric")),
    "BitSamplingLSH": (("idx",), ("d", "metric")),
    "Fp32Store": (("rows",), ()),
    "Bf16Store": (("rows",), ()),
    "Int8Store": (("q", "scale"), ()),
}


def index_signature(x) -> Any:
    """Hashable fingerprint of an index: its classes, the meta fields' values
    and every data leaf's shape and dtype (`_PYTREE_FIELDS`).  An insert or a
    delete within capacity keeps it; a compaction (a new segment tuple), a
    buffer or store growth, a store or tail change alters it.  It is taken
    on every search call, so the walk stays lean: exact type checks, no
    generators, shapes and dtypes kept as PyTorch's own hashable objects."""
    if isinstance(x, torch.Tensor):  # first: an index is mostly tensors
        return (x.shape, x.dtype)
    if x is None:
        return None
    t = type(x)
    if t is tuple or t is list:
        return (t.__name__, tuple([_field_signature(v) for v in x]))
    if t is int or t is float or t is bool:  # a counter: its value is not in the key
        return ((), t.__name__)
    spec = _PYTREE_FIELDS.get(t.__name__)
    if spec is None:
        if isinstance(x, np.ndarray):
            return (x.shape, x.dtype)
        return ((), t.__name__)  # an unregistered index-like: one opaque leaf
    data, meta = spec
    return (t.__name__, tuple([_field_signature(getattr(x, f)) for f in data]),
            tuple([getattr(x, f) for f in meta]))


def _field_signature(v) -> Any:
    # a tensor leaf without a call: most of an index's fields are tensors
    return (v.shape, v.dtype) if isinstance(v, torch.Tensor) else index_signature(v)


# ---------------------------------------------------------------------------
# compile / execute
# ---------------------------------------------------------------------------


def _default_params():
    from ..core.params import SearchParams, _suppress_width_warning

    # params=None means "the documented defaults": no WindowWidthWarning from
    # a library frame
    with _suppress_width_warning():
        return SearchParams()


def resolve_params(index, params: "SearchParams | None") -> "SearchParams":
    """Topology-aware params resolution only (no plan build): kernel
    toggles pinned, store pin validated."""
    adapter = get_topology(topology_of(index))
    return adapter.resolve(index, params or _default_params())


def _generic_instrumented(adapter: TopologyAdapter, index, p: "SearchParams") -> Runner:
    """Instrumented builder for adapters without a staged variant: the
    ordinary runner, fenced, timed as one `search` stage."""
    run = adapter.build(index, p)

    def instrumented(idx, queries):
        with _stage(adapter.name, "search"):
            out = fence(run(idx, queries))
        return out

    return instrumented


def compile_plan(index, queries, params: "SearchParams | None" = None,
                 *, return_hit: bool = False, scope: str | None = None,
                 instrument: bool = False):
    """Resolve + build (or fetch) the plan for searching `index` with query
    batches shaped like `queries` (a tensor or array, or a plain (B, d)
    shape tuple).  `return_hit=True` returns (plan, hit), the race-free way
    for a caller to attribute this call's cache outcome to itself.  `scope`
    labels the outcome in the per-scope tallies
    (`plan_cache().stats()["scopes"]`); the serving front passes each replica
    engine's name.

    The query part of the key is the batch shape as float32: `execute`
    (and `SearchPlan.__call__`) cast every batch to float32 before the
    runner sees it, so a float64 batch of the same shape is the same plan.

    `instrument=True` builds the topology's staged variant (each stage
    fenced and timed into `repro_exec_stage_seconds{topology,stage}`),
    keyed apart, so flipping instrumentation never disturbs the fused
    plans' miss audit."""
    adapter = get_topology(topology_of(index))
    p = adapter.resolve(index, params or _default_params())
    shape = tuple(queries) if isinstance(queries, tuple) else tuple(np.shape(queries))
    qsig = (shape, "float32")
    instrument = bool(instrument)
    key = (adapter.name, instrument, p, index_signature(index), qsig)
    if instrument:
        build_i = adapter.build_instrumented
        builder = (lambda: SearchPlan(
            topology=adapter.name, params=p, key=key, instrumented=True,
            run=(build_i(index, p) if build_i is not None
                 else _generic_instrumented(adapter, index, p)),
        ))
    else:
        builder = (lambda: SearchPlan(
            topology=adapter.name, params=p, key=key, run=adapter.build(index, p),
        ))
    plan, hit = _CACHE.get_or_build(key, builder, scope=scope)
    return (plan, hit) if return_hit else plan


def execute(index, queries, params: "SearchParams | None" = None, *,
            instrument: bool = False):
    """The unified search entry point: fetch or build the plan for the
    index's topology and the batch's shape, and run it on the index's
    device.  Returns (ids (B, k) int32, dists (B, k) float32).
    `instrument=True` runs the staged, timed variant (the same bits)."""
    queries = torch.as_tensor(queries, dtype=torch.float32).to(index.device)
    plan = compile_plan(index, queries, params, instrument=instrument)
    return plan.run(index, queries)
