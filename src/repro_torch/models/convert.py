"""Carrying a reference model across: the JAX package's parameter tree (as
numpy arrays, e.g. `jax.tree.map(np.asarray, params)`) into the port's
`LM`, so both packages run the same weights."""
from __future__ import annotations

import numpy as np
import torch

from ..core.index import resolve_device
from .lm import LM


def _flatten(tree, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, path + ".")
        else:
            yield path, val


def params_from_reference(cfg, params_np, device=None) -> LM:
    """An `LM` on `device` (None = CUDA; raises without it) holding the
    reference's weights.  The stacked pattern slots (`pattern/slot{j}`,
    leading axis = repeats) are unstacked into layer r * len(pattern) + j,
    the tail blocks (`tailp/tail{j}`) follow, and `embed/embedding` and
    `final_norm/fn_*` map to the same names.  Raises when a port parameter
    is missing from the tree or a shape differs."""
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

    put("embedding", params_np["embed"]["embedding"])
    for key, arr in params_np["final_norm"].items():
        put(key, arr)
    n_pat = len(cfg.pattern)
    for j in range(n_pat):
        for path, arr in _flatten(params_np["pattern"][f"slot{j}"]):
            for r in range(cfg.repeats):
                put(f"layers.{r * n_pat + j}.{path}", np.asarray(arr)[r])
    for j in range(len(cfg.tail)):
        for path, arr in _flatten(params_np["tailp"][f"tail{j}"]):
            put(f"layers.{cfg.repeats * n_pat + j}.{path}", arr)
    if todo:
        raise KeyError(f"port parameters missing from the reference tree: {sorted(todo)}")
    return model.eval().requires_grad_(False)
