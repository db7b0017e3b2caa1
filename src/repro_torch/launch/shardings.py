"""PartitionSpecs of the port's train states, batches and serving caches
(port of `repro.launch.shardings`), and their DTensor placements.

The port keeps its layers unstacked: a parameter, a moment or a layer's
cache is the reference's leaf without the leading repeat (or layer) dim
where the reference stacks it over a pattern's repeats.  Each spec here is
the reference's spec of that leaf with the stacked dim dropped: the rules
are applied at the reference leaf's rank, so a tail layer's cache takes
the rule of its own rank as in the reference (zamba2-7b's tail Mamba-2
state, 4-D there, takes the rule the reference writes for a stacked
Mamba-1 state)."""
from __future__ import annotations

from ..models.whisper import WhisperCache
from ..optim import AdamWState
from ..sharding import specs
from ..sharding.specs import P, PartitionSpec, mesh_axes, param_specs
from ..train.step import TrainState


def _bd(axes: dict):
    bd = tuple(a for a in ("pod", "data") if a in axes)
    return bd if len(bd) > 1 else (bd[0] if bd else None)


def _bd_size(axes: dict) -> int:
    n = 1
    for a in ("pod", "data"):
        n *= axes.get(a, 1)
    return n


def batch_specs(batch: dict, mesh) -> dict[str, PartitionSpec]:
    """Inputs: the leading batch dim over (pod, data) where they divide it
    (long_500k's batch of 1 is replicated); every other dim replicated (the
    models' constraints shard the sequence)."""
    axes = mesh_axes(mesh)
    bd, n_bd = _bd(axes), _bd_size(axes)
    out = {}
    for name, x in batch.items():
        nd = len(x.shape)
        lead = bd if nd >= 1 and x.shape[0] % n_bd == 0 else None
        out[name] = P(lead, *([None] * (nd - 1))) if nd else P()
    return out


def state_specs(state: TrainState, mesh) -> TrainState:
    """A TrainState of specs: the parameters and both AdamW moments by the
    parameter rules, the step replicated."""
    cfg = state.model.cfg
    p = param_specs(cfg, dict(state.model.named_parameters()), mesh)
    return TrainState(model=p, opt=AdamWState(m=dict(p), v=dict(p), step=P()))


def _cache_rule(name: str, shape: tuple, axes: dict) -> PartitionSpec:
    """The reference's `cache_specs` rule for a leaf `name` of `shape` (the
    reference's shape, stacked dims included)."""
    bd, n_bd = _bd(axes), _bd_size(axes)
    md = "model" if "model" in axes else None
    nd = len(shape)

    def b(n):  # replicate the batch where (pod, data) does not divide it (B = 1)
        return bd if n % n_bd == 0 else None

    if name in ("k", "v") and nd == 5:  # (repeats, B, S, H, dh): shard S
        return P(None, b(shape[1]), md, None, None)
    if name in ("k", "v") and nd == 4:
        return P(b(shape[0]), md, None, None)
    if name in ("ck", "cv"):  # whisper cross K / V: (L, B, S_enc, H, dh)
        return P(None, b(shape[1]), None, None, None)
    if name == "conv_tail" and nd == 4:  # (repeats, B, k - 1, C)
        return P(None, b(shape[1]), None, md)
    if name == "conv_tail" and nd == 3:
        return P(b(shape[0]), None, md)
    if name == "state":  # m1 (R, B, Di, N) | m2 (R, B, H, N, hd)
        if nd == 4:
            return P(None, b(shape[1]), md, None)
        if nd == 5:
            return P(None, b(shape[1]), md, None, None)
        if nd == 3:
            return P(b(shape[0]), md, None)
    return P(*([None] * nd))


def _leaf_spec(name: str, t, stacked: bool, axes: dict) -> PartitionSpec:
    shape = tuple(t.shape)
    return _cache_rule(name, (1,) * stacked + shape, axes)[stacked:]


def _layer_cache_specs(cache, stacked: bool, axes: dict):
    return cache._replace(**{f: _leaf_spec(f, getattr(cache, f), stacked, axes)
                             for f in cache._fields if f != "length"}, length=None)


def cache_specs(cfg, caches, mesh):
    """Serving caches: the batch over (pod, data), a KV cache's sequence
    and an SSM cache's channels over model.  `caches` as the port holds
    them (a list in layer order of KVCache / SSMCache, or a WhisperCache);
    returns the same structure with a spec in place of each tensor and None
    for each length (a Python int)."""
    axes = mesh_axes(mesh)
    if isinstance(caches, WhisperCache):
        return WhisperCache(
            [_layer_cache_specs(c, True, axes) for c in caches.self_kv],
            [_leaf_spec("ck", t, True, axes) for t in caches.ck],
            [_leaf_spec("cv", t, True, axes) for t in caches.cv], None)
    n_pat = len(cfg.pattern) * cfg.repeats  # the pattern's layers are stacked there
    return [_layer_cache_specs(c, i < n_pat, axes) for i, c in enumerate(caches)]


def to_placements(tree, mesh):
    """Each PartitionSpec in a tree of specs (dicts, lists, NamedTuples) as
    its DTensor placements on `mesh`; any other leaf as it is."""
    if isinstance(tree, PartitionSpec):
        return specs.to_placements(tree, mesh)
    if isinstance(tree, dict):
        return {k: to_placements(v, mesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_placements(v, mesh) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_placements(v, mesh) for v in tree)
    return tree

