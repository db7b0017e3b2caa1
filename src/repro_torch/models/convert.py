"""Carrying a reference model across: the JAX package's parameter tree (as
numpy arrays, e.g. `jax.tree.map(np.asarray, params)`) into the port's
`LM`, so both packages run the same weights; and the reference's decode
caches into the port's list of caches, so either can continue the other's
decode."""
from __future__ import annotations

import numpy as np
import torch

from ..core.index import resolve_device
from .attention import KVCache
from .blocks import ATTN_KINDS
from .lm import LM, layer_kinds
from .ssm import SSMCache


def _flatten(tree, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, path + ".")
        else:
            yield path, val


def _layer_sources(cfg):
    """(tree key, slot key, repeat or None) of each layer in the port's
    order: the stacked pattern slots unstacked by repeat, then the tail
    (whose parameters the reference keeps under "tailp", its caches under
    "tail")."""
    n_pat = len(cfg.pattern)
    for r in range(cfg.repeats):
        for j in range(n_pat):
            yield "pattern", f"slot{j}", r
    for j in range(len(cfg.tail)):
        yield "tail", f"tail{j}", None


def params_from_reference(cfg, params_np, device=None) -> LM:
    """An `LM` on `device` (None = CUDA; raises without it) holding the
    reference's weights.  The stacked pattern slots (`pattern/slot{j}`,
    leading axis = repeats) are unstacked into layer r * len(pattern) + j,
    the tail blocks (`tailp/tail{j}`) follow, `embed/embedding`,
    `final_norm/fn_*` and the untied `head/lm_head` map to the same names.
    zamba's one shared block (`shared`) fills the LM's `shared`, read only
    for a config whose pattern has a `shared_attn` slot; that slot's
    `pattern/slot{j}` is empty.  Raises when a port parameter is missing
    from the tree, a shape differs, or the tree has a top-level key the
    port does not read (such as `shared` for any other config)."""
    model = LM(cfg, device=resolve_device(device))
    todo = dict(model.named_parameters())

    def put(name: str, arr) -> None:
        if name not in todo:
            raise KeyError(f"reference parameter {name!r} has no place in the port's LM")
        t = todo.pop(name)
        a = np.asarray(arr, dtype=np.float32)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{name}: reference shape {a.shape}, port shape {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.array(a)))

    read = {"embed", "final_norm", "pattern", "tailp", "head"}
    if model.shared is not None:
        read.add("shared")
    extra = sorted(set(params_np) - read)
    if extra:
        raise KeyError(f"reference tree keys the port does not read: {extra}")
    put("embedding", params_np["embed"]["embedding"])
    for key, arr in params_np.get("head", {}).items():
        put(key, arr)
    for key, arr in params_np["final_norm"].items():
        put(key, arr)
    if model.shared is not None:
        for path, arr in _flatten(params_np["shared"], "shared."):
            put(path, arr)
    for i, (tree, slot, r) in enumerate(_layer_sources(cfg)):
        for path, arr in _flatten(params_np["tailp" if tree == "tail" else tree][slot]):
            put(f"layers.{i}.{path}", arr if r is None else np.asarray(arr)[r])
    if todo:
        raise KeyError(f"port parameters missing from the reference tree: {sorted(todo)}")
    return model.eval().requires_grad_(False)


def caches_from_reference(cfg, caches_np, device=None) -> list:
    """The reference's decode caches ({"pattern": {"slot{j}": stacked over
    repeats}, "tail": {"tail{j}": ...}}, each a KVCache (k, v, length) or
    an SSMCache (conv_tail, state, length), as numpy arrays, e.g.
    `jax.tree.map(np.asarray, caches)`) as the port's list, one a layer in
    layer order (zamba's shared block: its KV cache of repeat r at each
    place r), on `device` (None = CUDA; raises without it).  K and V
    stay bf16 (their values are bf16 already), the lengths become ints."""
    dev = resolve_device(device)

    def tensor(a, r, dtype):
        a = np.asarray(a, dtype=np.float32)
        return torch.from_numpy(np.array(a if r is None else a[r])).to(dev, dtype)

    out = []
    for kind, (tree, slot, r) in zip(layer_kinds(cfg), _layer_sources(cfg)):
        a, b, length = caches_np[tree][slot]
        length = int(np.asarray(length) if r is None else np.asarray(length)[r])
        if kind in ATTN_KINDS:
            out.append(KVCache(tensor(a, r, torch.bfloat16), tensor(b, r, torch.bfloat16),
                               length))
        else:
            out.append(SSMCache(tensor(a, r, torch.float32), tensor(b, r, torch.float32),
                                length))
    return out
