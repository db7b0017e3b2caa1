"""Query-execution layer: the staged hash -> probe -> verify pipeline
(`stages`), the topology registry, the plan cache and the one entry point
`execute` (`plan`), and the monolithic and segmented adapters with their
instrumented variants (`topology`)::

    from repro_torch.exec import execute, plan_cache

    ids, dists = execute(index, queries, SearchParams(k=10, lam=200))
    plan_cache().stats()   # {"hits": ..., "misses": ..., ...}: a miss is a
                           # plan built; a flat miss counter shows a serving
                           # loop is not rebuilding
"""
from . import stages
from . import topology  # registers the monolithic and segmented adapters
from .plan import (
    PlanCache,
    SearchPlan,
    TopologyAdapter,
    available_topologies,
    compile_plan,
    execute,
    get_topology,
    plan_cache,
    register_topology,
    resolve_params,
    topology_of,
)

__all__ = [
    "PlanCache",
    "SearchPlan",
    "TopologyAdapter",
    "available_topologies",
    "compile_plan",
    "execute",
    "get_topology",
    "plan_cache",
    "register_topology",
    "resolve_params",
    "stages",
    "topology",
    "topology_of",
]
