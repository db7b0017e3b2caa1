"""Query-execution layer: the staged hash -> probe -> verify pipeline
(`stages`), the topology registry and the one entry point `execute`
(`plan`), and the monolithic adapter (`topology`)."""
from . import stages
from . import topology  # registers the monolithic adapter
from .plan import (
    TopologyAdapter,
    available_topologies,
    execute,
    get_topology,
    register_topology,
    resolve_params,
    topology_of,
)

__all__ = [
    "TopologyAdapter",
    "available_topologies",
    "execute",
    "get_topology",
    "register_topology",
    "resolve_params",
    "stages",
    "topology",
    "topology_of",
]
