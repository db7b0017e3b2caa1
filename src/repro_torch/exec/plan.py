"""Topology registry and the one search entry point (PyTorch port of the
dispatch half of `repro.exec.plan`; the reference's compiled-plan cache is
not ported yet -- PyTorch runs eagerly, so each call resolves and runs).

A topology adapter is two functions:

    resolve(index, params) -> SearchParams   validate + rewrite (kernel
                                             toggles pinned, store pin checked)
    build(index, params)   -> run(index, queries) -> (ids, dists)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable

import torch

if TYPE_CHECKING:  # pragma: no cover
    from ..core.params import SearchParams

Runner = Callable[[Any, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


@dataclass(frozen=True)
class TopologyAdapter:
    name: str
    resolve: Callable[[Any, "SearchParams"], "SearchParams"]
    build: Callable[[Any, "SearchParams"], Runner]


_TOPOLOGIES: dict[str, TopologyAdapter] = {}


def register_topology(name: str, *, resolve, build) -> TopologyAdapter:
    """Register a topology adapter (re-registering overwrites)."""
    adapter = TopologyAdapter(name=name, resolve=resolve, build=build)
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


def _default_params():
    from ..core.params import SearchParams, _suppress_width_warning

    # params=None means "the documented defaults": no WindowWidthWarning from
    # a library frame
    with _suppress_width_warning():
        return SearchParams()


def resolve_params(index, params: "SearchParams | None") -> "SearchParams":
    """Topology-aware params resolution: kernel toggles pinned, store pin
    validated."""
    adapter = get_topology(topology_of(index))
    return adapter.resolve(index, params or _default_params())


def execute(index, queries, params: "SearchParams | None" = None):
    """The unified search entry point: resolve `params` for the index's
    topology, build its runner and run it on the index's device.
    Returns (ids (B, k) int32, dists (B, k) float32)."""
    adapter = get_topology(topology_of(index))
    p = adapter.resolve(index, params or _default_params())
    queries = torch.as_tensor(queries, dtype=torch.float32).to(index.device)
    return adapter.build(index, p)(index, queries)
