"""Carrying a reference model across: the JAX package's parameter tree (as
numpy arrays, e.g. `jax.tree.map(np.asarray, params)`) into the port's
`LM` or `Whisper`, so both packages run the same weights; and the
reference's decode caches into the port's caches, so either can continue
the other's decode."""
from __future__ import annotations

import numpy as np
import torch

from ..core.index import resolve_device
from .attention import KVCache
from .blocks import ATTN_KINDS
from .lm import LM, layer_kinds
from .ssm import SSMCache
from .whisper import Whisper, WhisperCache


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


def _put_all(model, pairs) -> None:
    """Copy each (port parameter name, array) of `pairs` into `model`.
    Raises when a name has no place in the model, a shape differs, or a
    port parameter is left without an array."""
    todo = dict(model.named_parameters())
    for name, arr in pairs:
        if name not in todo:
            raise KeyError(f"reference parameter {name!r} has no place in the port's "
                           f"{type(model).__name__}")
        t = todo.pop(name)
        a = np.asarray(arr, dtype=np.float32)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{name}: reference shape {a.shape}, port shape {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.array(a)))
    if todo:
        raise KeyError(f"port parameters missing from the reference tree: {sorted(todo)}")


def _check_keys(params_np, read: set) -> None:
    extra = sorted(set(params_np) - read)
    if extra:
        raise KeyError(f"reference tree keys the port does not read: {extra}")


def _whisper_pairs(params_np):
    """(port name, array) of whisper's tree: `embed/embedding` and
    `dec_pos/pos_embedding` by their leaf names, `enc` and `dec` (stacked
    over layers) unstacked into `enc.{i}.` and `dec.{i}.`, `enc_ln` and
    `dec_ln` as they are."""
    _check_keys(params_np, {"embed", "dec_pos", "enc", "dec", "enc_ln", "dec_ln"})
    yield "embedding", params_np["embed"]["embedding"]
    yield "pos_embedding", params_np["dec_pos"]["pos_embedding"]
    for stack in ("enc", "dec"):
        for path, arr in _flatten(params_np[stack]):
            arr = np.asarray(arr)
            for i in range(arr.shape[0]):
                yield f"{stack}.{i}.{path}", arr[i]
    for norm in ("enc_ln", "dec_ln"):
        yield from _flatten(params_np[norm], f"{norm}.")


def _lm_pairs(cfg, model: LM, params_np):
    """(port name, array) of an LM's tree, as `params_from_reference` says."""
    read = {"embed", "final_norm", "pattern", "tailp", "head"}
    if model.shared is not None:
        read.add("shared")
    _check_keys(params_np, read)
    yield "embedding", params_np["embed"]["embedding"]
    yield from params_np.get("head", {}).items()
    yield from params_np["final_norm"].items()
    if model.shared is not None:
        yield from _flatten(params_np["shared"], "shared.")
    for i, (tree, slot, r) in enumerate(_layer_sources(cfg)):
        for path, arr in _flatten(params_np["tailp" if tree == "tail" else tree][slot]):
            yield f"layers.{i}.{path}", arr if r is None else np.asarray(arr)[r]


def params_from_reference(cfg, params_np, device=None) -> LM | Whisper:
    """A model on `device` (None = CUDA; raises without it) holding the
    reference's weights: a `Whisper` for an encoder-decoder config (its
    tree as `_whisper_pairs` reads it), else an `LM` (the VLM's tree is the
    LM's).  The LM's stacked pattern slots (`pattern/slot{j}`,
    leading axis = repeats) are unstacked into layer r * len(pattern) + j,
    the tail blocks (`tailp/tail{j}`) follow, `embed/embedding`,
    `final_norm/fn_*` and the untied `head/lm_head` map to the same names.
    zamba's one shared block (`shared`) fills the LM's `shared`, read only
    for a config whose pattern has a `shared_attn` slot; that slot's
    `pattern/slot{j}` is empty.  Raises when a port parameter is missing
    from the tree, a shape differs, or the tree has a top-level key the
    port does not read (such as `shared` for any other config)."""
    dev = resolve_device(device)
    if cfg.enc_dec:
        model = Whisper(cfg, device=dev)
        _put_all(model, _whisper_pairs(params_np))
    else:
        model = LM(cfg, device=dev)
        _put_all(model, _lm_pairs(cfg, model, params_np))
    return model.eval().requires_grad_(False)


def caches_from_reference(cfg, caches_np, device=None) -> list | WhisperCache:
    """The reference's decode caches ({"pattern": {"slot{j}": stacked over
    repeats}, "tail": {"tail{j}": ...}}, each a KVCache (k, v, length) or
    an SSMCache (conv_tail, state, length), as numpy arrays, e.g.
    `jax.tree.map(np.asarray, caches)`) as the port's list, one a layer in
    layer order (zamba's shared block: its KV cache of repeat r at each
    place r), on `device` (None = CUDA; raises without it).  K and V
    stay bf16 (their values are bf16 already), the lengths become ints.
    Whisper's ({"self": a KVCache stacked over the decoder's layers, "ck",
    "cv" (layers, B, S_enc, Hkv, dh) float32, "length"}) become a
    `WhisperCache`; a key it does not read raises."""
    dev = resolve_device(device)

    def tensor(a, r, dtype):
        a = np.asarray(a, dtype=np.float32)
        return torch.from_numpy(np.array(a if r is None else a[r])).to(dev, dtype)

    if cfg.enc_dec:
        _check_keys(caches_np, {"self", "ck", "cv", "length"})
        k, v, lengths = caches_np["self"]
        n = np.asarray(k).shape[0]
        return WhisperCache(
            [KVCache(tensor(k, i, torch.bfloat16), tensor(v, i, torch.bfloat16),
                     int(np.asarray(lengths)[i])) for i in range(n)],
            [tensor(caches_np["ck"], i, torch.float32) for i in range(n)],
            [tensor(caches_np["cv"], i, torch.float32) for i in range(n)],
            int(np.asarray(caches_np["length"])))

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
