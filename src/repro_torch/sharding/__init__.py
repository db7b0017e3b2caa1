"""Logical-axis sharding of the port (counterpart of `repro.sharding`)."""
from .specs import (LOGICAL_RULES, AbstractMesh, P, PartitionSpec, current_mesh,
                    logical_to_spec, param_specs, shard_ctx, to_placements,
                    with_logical_constraint)

__all__ = [
    "LOGICAL_RULES",
    "AbstractMesh",
    "P",
    "PartitionSpec",
    "current_mesh",
    "logical_to_spec",
    "param_specs",
    "shard_ctx",
    "to_placements",
    "with_logical_constraint",
]
