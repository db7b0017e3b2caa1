"""Carrying a reference model across: the JAX package's parameter tree (as
numpy arrays, e.g. `jax.tree.map(np.asarray, params)`) into the port's
`LM` or `Whisper`, so both packages run the same weights, and back
(`params_to_reference`); a train state (parameters, AdamW moments, step)
both ways (`train_state_from_reference`, `train_state_to_reference`), so
either package restores the other's checkpoint; and the reference's decode
caches into the port's caches, so either can continue the other's decode."""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from ..core.index import resolve_device
from .attention import KVCache
from .blocks import ATTN_KINDS
from .lm import LM, layer_kinds
from .ssm import SSMCache
from .whisper import Whisper, WhisperCache

if TYPE_CHECKING:
    from ..train.step import TrainState


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


def reference_path(cfg, name: str) -> tuple[tuple[str, ...], int | None]:
    """Where the port's parameter `name` lives in the reference's tree: (the
    path of keys, the repeat index where the reference stacks it, else
    None).  The inverse of the pairs `params_from_reference` reads: an LM's
    `layers.{i}` is `pattern/slot{j}` at repeat r (i = r * len(pattern) +
    j) or `tailp/tail{j}` past the pattern; zamba's `shared` is `shared`;
    whisper's `enc.{i}` and `dec.{i}` are `enc` and `dec` at layer i."""
    head, _, rest = name.partition(".")
    tail = tuple(rest.split(".")) if rest else ()
    if cfg.enc_dec:
        if name == "embedding":
            return ("embed", "embedding"), None
        if name == "pos_embedding":
            return ("dec_pos", "pos_embedding"), None
        if head in ("enc", "dec"):
            i, _, path = rest.partition(".")
            return (head, *path.split(".")), int(i)
        return (head, *tail), None
    if name == "embedding":
        return ("embed", "embedding"), None
    if name == "lm_head":
        return ("head", "lm_head"), None
    if name in ("fn_scale", "fn_bias"):
        return ("final_norm", name), None
    if head == "shared":
        return ("shared", *tail), None
    if head != "layers":
        raise KeyError(f"port parameter {name!r} has no place in the reference's tree")
    i, _, path = rest.partition(".")
    i, n_pat = int(i), len(cfg.pattern)
    if i < cfg.repeats * n_pat:
        return ("pattern", f"slot{i % n_pat}", *path.split(".")), i // n_pat
    return ("tailp", f"tail{i - cfg.repeats * n_pat}", *path.split(".")), None


def reference_ndim(cfg, model: LM | Whisper) -> dict[str, int]:
    """The rank of each port parameter's leaf in the reference's tree: its
    own, plus one where the reference stacks it over repeats or layers (a
    pattern slot's norm scale is (repeats, D) there)."""
    return {name: p.dim() + (reference_path(cfg, name)[1] is not None)
            for name, p in model.named_parameters()}


def host_array(t: torch.Tensor) -> np.ndarray:
    """A copy of `t` on the host as numpy (bf16 as float32: numpy has no
    bf16, and the values are exact); a copy also of a CPU tensor, so that a
    later in-place update does not reach it."""
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dtype=dtype, copy=True).numpy()


def _nest(paths: dict[tuple, np.ndarray]) -> dict:
    tree: dict = {}
    for path, arr in paths.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


def named_to_reference(cfg, named: dict[str, torch.Tensor]) -> dict:
    """A dict of port tensors keyed by parameter name (the parameters, or an
    AdamW moment of each) as the reference's nested tree of numpy arrays,
    the stacked leaves stacked over repeats or layers; a `shared_attn`
    pattern slot is an empty dict, as in the reference.  Values are
    `host_array` copies."""
    stacks: dict[tuple, dict[int, np.ndarray]] = {}
    paths: dict[tuple, np.ndarray] = {}
    for name, t in named.items():
        a = host_array(t)
        path, r = reference_path(cfg, name)
        if r is None:
            paths[path] = a
        else:
            stacks.setdefault(path, {})[r] = a
    for path, by_r in stacks.items():
        paths[path] = np.stack([by_r[r] for r in range(len(by_r))])
    tree = _nest(paths)
    if not cfg.enc_dec:
        for j, kind in enumerate(cfg.pattern):
            if kind == "shared_attn":
                tree.setdefault("pattern", {})[f"slot{j}"] = {}
    return tree


def named_from_reference(cfg, model: LM | Whisper, tree_np) -> dict[str, np.ndarray]:
    """The reference's nested tree (`named_to_reference`'s form) as numpy
    arrays keyed by the port's parameter names of `model`."""
    pairs = (_whisper_pairs(tree_np) if cfg.enc_dec else _lm_pairs(cfg, model, tree_np))
    return {name: np.asarray(a) for name, a in pairs}


def params_to_reference(cfg, model: LM | Whisper) -> dict:
    """The model's parameters as the reference's tree of float32 numpy
    arrays (`params_from_reference` inverted)."""
    return named_to_reference(cfg, dict(model.named_parameters()))


def train_state_to_reference(state: TrainState):
    """A port `TrainState` as the reference's, flattened as `jax.tree_util`
    flattens its `TrainState(params, AdamWState(m, v, step))`: (params, (m,
    v, step)), each tree `named_to_reference`'s, step an int32 scalar."""
    cfg = state.model.cfg
    return (params_to_reference(cfg, state.model),
            (named_to_reference(cfg, state.opt.m), named_to_reference(cfg, state.opt.v),
             host_array(state.opt.step).astype(np.int32)))


def train_state_from_reference(cfg, state_np, device=None, *, opt_dtype=None) -> TrainState:
    """A port `TrainState` on `device` (None = CUDA; raises without it) from
    the reference's (its `TrainState` with numpy leaves, e.g.
    `jax.tree.map(np.asarray, state)`, or `train_state_to_reference`'s
    tuple): the model holds the parameters, trainable; the moments keep the
    arrays' dtype unless `opt_dtype` is given."""
    from ..optim.adamw import AdamWState
    from ..train.step import TrainState

    params_np, (m_np, v_np, step) = state_np[0], state_np[1]
    dev = resolve_device(device)
    model = params_from_reference(cfg, params_np, dev).train().requires_grad_(True)

    def moments(tree):
        out = {}
        for name, a in named_from_reference(cfg, model, tree).items():
            dtype = opt_dtype or (torch.bfloat16 if str(a.dtype) == "bfloat16" else torch.float32)
            out[name] = torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, dtype)
        return out

    return TrainState(model, AdamWState(moments(m_np), moments(v_np),
                                        torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                                     device=dev)))


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
