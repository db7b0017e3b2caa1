"""Logical-axis sharding (port of `repro.sharding.specs`): one rule table,
resolved against whatever mesh is active -- single-pod (data, model) or
multi-pod (pod, data, model).

Model code names the logical axes of an activation with
`with_logical_constraint(x, "batch", "seq", None)`; parameters take logical
axes from their name in the reference's tree (`param_specs`).  The rules
resolve each logical name to the subset of its preferred mesh axes that the
active mesh has, so the same model code runs on one device (no mesh: every
constraint is a no-op), one pod, or many.

A spec is the port's own `PartitionSpec`: one entry a tensor dim, each None,
a mesh axis name, or a tuple of names (one tensor dim sharded over several
mesh dims, major to minor, as GSPMD shards it).  `to_placements` turns one
into the placements of a `torch.distributed.tensor.DTensor`, one a mesh dim.
A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims, or an
`AbstractMesh` (names and sizes, no devices: specs and shard shapes only).

Layout (the reference's DESIGN.md §5):
  batch, fsdp      -> (pod, data)   the DP / FSDP axis set
  seq, kv_seq      -> model         sequence sharding of attention
                                    activations and of decode KV caches
  tp, expert, vocab -> model        FFN hidden, fused heads, experts, vocab
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "seq": ("model",),
    "kv_seq": ("model",),
    "tp": ("model",),
    "expert": ("model",),
    "vocab": ("model",),
}


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (sharded over those mesh dims, the first the major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh(NamedTuple):
    """A mesh's dim names and sizes without devices (the counterpart of
    `jax.sharding.AbstractMesh`)."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or an AbstractMesh, in mesh order."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a mesh needs named dims (pod, data, model)")
    return dict(zip(names, mesh.shape))


class _State:
    """The active mesh and rules, process-wide: the autograd engine runs a
    backward, and the forward a recompute repeats, on threads of its own."""
    ctx = None


_state = _State()


@contextlib.contextmanager
def shard_ctx(mesh, rules: dict[str, tuple[str, ...]] | None = None):
    """Activate a mesh and a rule table for `with_logical_constraint` (and
    the mesh for `current_mesh`); None deactivates both."""
    prev = _state.ctx
    _state.ctx = (mesh, rules or LOGICAL_RULES) if mesh is not None else None
    try:
        yield
    finally:
        _state.ctx = prev


def current_mesh():
    """The mesh that shard_ctx activated (None when unsharded, e.g. one
    device)."""
    ctx = _state.ctx
    return ctx[0] if ctx else None


def _resolve(name: str | None, axes: dict[str, int], rules):
    if name is None:
        return None
    hit = tuple(a for a in rules.get(name, ()) if a in axes)
    if not hit:
        return None
    return hit if len(hit) > 1 else hit[0]


def logical_to_spec(logical: tuple[str | None, ...], mesh, rules=None) -> PartitionSpec:
    axes = mesh_axes(mesh)
    rules = rules or LOGICAL_RULES
    return P(*(_resolve(name, axes, rules) for name in logical))


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def to_placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of `spec` on `mesh`, one a mesh dim: Shard(d)
    where the mesh dim's name is in tensor dim d's entry, else Replicate()
    (a mesh dim of one rank replicates: its one shard is the tensor).
    A tensor dim over several mesh dims is sharded by them in mesh order,
    which is the entry's order (pod before data): DTensor shards a dim by
    the mesh dims left to right, as GSPMD does by the entry's names."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axes(mesh)
    names = list(sizes)
    dim_of = {}
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec {spec}: entry {entry} is not in mesh order {names}")
        for a in axes:
            if a in dim_of:
                raise ValueError(f"spec {spec}: mesh axis {a} appears twice")
            dim_of[a] = d
    return [Shard(dim_of[n]) if n in dim_of and sizes[n] > 1 else Replicate() for n in names]


def local_shape(shape, spec: PartitionSpec, mesh) -> tuple[int, ...]:
    """The shape of rank 0's shard of a tensor of `shape` under `spec`: each
    dim split by its mesh dims in turn, the first chunk ceil(n / k) as
    `torch.chunk` (and DTensor) cut it.  DTensor gives the last shards of an
    uneven dim fewer rows where GSPMD pads them, so rank 0's shard is the
    largest of either."""
    axes = mesh_axes(mesh)
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        for a in entry_axes(entry):
            n = -(-n // axes[a])
        out.append(n)
    return tuple(out)


def shard_bytes(shape, dtype_bytes: int, spec: PartitionSpec, mesh) -> int:
    return math.prod(local_shape(shape, spec, mesh)) * dtype_bytes


def with_logical_constraint(x, *logical: str | None):
    """Redistribute a DTensor to the spec of `logical` on the active mesh
    (a dim shorter than its shards left whole); nothing without an active
    mesh or on a plain tensor (a process that trains its state as plain
    tensors under a mesh, e.g. `launch.train --mesh 1x1`, runs bit for bit
    as without one)."""
    ctx = _state.ctx
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    axes = mesh_axes(mesh)
    # a dim shorter than its shards stays whole (a decode step's one token:
    # GSPMD pads it, a DTensor shard of it could not be reshaped)
    spec = P(*(None if n < math.prod(axes[a] for a in entry_axes(e)) else e
               for n, e in zip(x.shape, logical_to_spec(logical, mesh, rules))))
    return _Constrain.apply(x, tuple(to_placements(spec, mesh)))


def _placed_as(t, placements: tuple):
    if tuple(t.placements) == placements:
        return t.view_as(t)
    return t.redistribute(t.device_mesh, placements)


class _Constrain(torch.autograd.Function):
    """A DTensor placed as given, and its gradient placed alike: the
    transpose of a sharding constraint constrains the cotangent, as XLA's
    `with_sharding_constraint` does."""

    @staticmethod
    def forward(ctx, x, placements: tuple):
        ctx.placements = placements
        return _placed_as(x, placements)

    @staticmethod
    def backward(ctx, g):
        return _placed_as(g, ctx.placements), None


# ---------------------------------------------------------------------------
# Parameter sharding from the reference's tree paths
# ---------------------------------------------------------------------------

# leaf name -> logical axes of its trailing dims (the reference's leading
# stacked "layers" dims map to None).  2-D weights are (in, out) unless noted.
_PARAM_AXES: dict[str, tuple[str | None, ...]] = {
    # embeddings / heads
    "embedding": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    "pos_embedding": (None, "fsdp"),
    # attention (fused head*dim out axis)
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",),
    "bk": ("tp",),
    "bv": ("tp",),
    # dense mlp
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # moe (the expert axis takes the model mesh axis; inner dims fsdp)
    "router": ("fsdp", None),
    "e_gate": ("expert", "fsdp", None),
    "e_up": ("expert", "fsdp", None),
    "e_down": ("expert", None, "fsdp"),
    # mamba
    "in_proj": ("fsdp", "tp"),
    "x_proj": ("tp", None),
    "dt_proj": (None, "tp"),
    "out_proj": ("tp", "fsdp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "A_log": ("tp", None),
    "D": ("tp",),
    "dt_bias": ("tp",),
    # norms / scalars
    "scale": (None,),
    "bias": (None,),
}


def leaf_logical(name: str | None, nd: int) -> tuple[str | None, ...]:
    """The reference's `_leaf_logical`: the logical axes of a leaf of rank
    `nd` named `name` in its tree."""
    axes = _PARAM_AXES.get(name)
    if axes is None:
        return (None,) * nd
    if len(axes) < nd:  # leading stacked-layer dims
        return (None,) * (nd - len(axes)) + axes
    if len(axes) > nd:  # e.g. squeezed scalars
        return axes[-nd:] if nd else ()
    return axes


def param_logical_axes(cfg, named_shapes: dict) -> dict[str, tuple[str | None, ...]]:
    """{port parameter name: logical axes} for a model's named parameters
    (or anything with a `.shape` under those names).  A port parameter is
    the reference's leaf (`models.convert.reference_path`) with the stacked
    leading dim dropped where the reference stacks it: its axes are the
    reference leaf's axes without that dim."""
    from ..models.convert import reference_path

    out = {}
    for name, t in named_shapes.items():
        path, r = reference_path(cfg, name)
        stacked = r is not None
        out[name] = leaf_logical(path[-1], len(t.shape) + stacked)[stacked:]
    return out


def param_specs(cfg, named_shapes: dict, mesh, rules=None) -> dict[str, PartitionSpec]:
    """{port parameter name: PartitionSpec} on `mesh` (works on meta and
    fake tensors: only shapes are read)."""
    return {name: logical_to_spec(axes, mesh, rules)
            for name, axes in param_logical_axes(cfg, named_shapes).items()}
