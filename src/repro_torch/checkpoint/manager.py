"""Fault-tolerant checkpointing (port of `repro.checkpoint.manager`), in the
reference's format, so that each package restores the other's checkpoints:

  * format:   ``step_N/arrays.npz`` holding ``leaf_0`` .. in the order
              `jax.tree_util` flattens the tree (dict keys sorted, tuples in
              order), and ``meta.json`` ({"step", "time", "extra"}); a port
              `TrainState` is written as the reference's TrainState(params,
              AdamWState(m, v, step)) (`models.convert.train_state_to_reference`:
              its stacked pattern slots, then m, then v, then the step);
  * atomic:   write to ``step_N.tmp/`` then os.rename -- a preempted writer
              never corrupts the latest checkpoint, and a leftover ``.tmp``
              is never read;
  * async:    the tensors are copied to the host now and handed to a writer
              thread, so the train loop resumes at once (``blocking=False``);
  * keep-K:   old checkpoints garbage-collected after a successful write;
  * resumable data: the caller's `extra` (the data pipeline's step) rides
              in meta.json.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models.convert import (host_array, named_from_reference, named_to_reference,
                              train_state_to_reference)
from ..optim.adamw import AdamWState
from ..train.step import TrainState


def _leaves(tree) -> list:
    """The leaves of a tree of dicts, tuples and lists in `jax.tree_util`'s
    order: dict keys sorted, sequences in order (None and empty containers
    hold none)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in _leaves(item)]
    return [] if tree is None else [tree]


def _unflatten(like, leaves: list):
    """`like`'s structure (`_leaves`'s order) over the given leaves."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {key: build(node[key]) for key in sorted(node)}
            return {key: out[key] for key in node}
        if isinstance(node, (tuple, list)):
            items = [build(item) for item in node]
            return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)
        return None if node is None else next(it)

    return build(like)


def _host(x) -> np.ndarray:
    """A leaf as a numpy array of its own (`convert.host_array` for a
    tensor)."""
    return host_array(x) if isinstance(x, torch.Tensor) else np.array(x)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- write ---------------------------------------------------------------

    def save(self, step: int, tree, extra: dict | None = None, *, blocking: bool = True):
        """Snapshot `tree` (a `TrainState`, or a tree of dicts, tuples and
        lists over tensors or arrays) at `step`.  With blocking=False the
        copy to the host happens now and the disk write on a thread."""
        self.wait()  # one outstanding async write at a time
        if isinstance(tree, TrainState):
            tree = train_state_to_reference(tree)
        arrs = {f"leaf_{i}": _host(x) for i, x in enumerate(_leaves(tree))}
        meta = {"step": int(step), "time": time.time(), "extra": extra or {}}

        def write():
            try:
                tmp = self.dir / f"step_{step}.tmp"
                final = self.dir / f"step_{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / "arrays.npz", **arrs)
                with open(tmp / "meta.json", "w") as f:
                    json.dump(meta, f)
                if final.exists():
                    shutil.rmtree(final)
                os.rename(tmp, final)  # atomic publish
                self._gc()
            except Exception as e:  # surfaced on the next save() / wait()
                self._error = e

        if blocking:
            write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e}") from e

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like, step: int | None = None, *, device=None) -> tuple[Any, dict]:
        """Restore `step` (None = the latest) into the structure of `like`.
        A `TrainState`: its model's parameters are overwritten in place (the
        model moved to `device` first, where given) and the moments and
        step are new tensors on the model's device, in `like`'s moment
        dtype.  Any other tree: its leaves become tensors on `device` (None
        = the CPU).  Returns (the restored state or tree, meta)."""
        arrs, meta = self._load(step)
        if not isinstance(like, TrainState):
            n = len(_leaves(like))
            if n != len(arrs):
                raise ValueError(f"checkpoint has {len(arrs)} leaves, target tree has {n}")
            dev = torch.device("cpu" if device is None else device)
            return _unflatten(like, [torch.from_numpy(a).to(dev) for a in arrs]), meta
        return self._restore_state(like, arrs, device), meta

    def restore_model(self, model, step: int | None = None) -> dict:
        """Fill `model`'s parameters in place from the train-state checkpoint
        at `step` (None = the latest), reading only its parameters (the
        first of its three trees); returns meta.  How the serving launcher
        loads a trained model."""
        arrs, meta = self._load(step)
        self._fill(model, self._trees(model, arrs, 1)[0])
        return meta

    def _load(self, step: int | None) -> tuple[list, dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        with np.load(d / "arrays.npz") as z:
            arrs = [z[f"leaf_{i}"] for i in range(len(z.files))]
        with open(d / "meta.json") as f:
            meta = json.load(f)
        return arrs, meta

    @staticmethod
    def _trees(model, arrs: list, count: int) -> list[dict]:
        """The first `count` of a train state's trees (params, m, v) in
        `arrs`, each keyed by `model`'s parameter names."""
        cfg = model.cfg
        layout = named_to_reference(cfg, {name: p[:0] for name, p in model.named_parameters()})
        n = len(_leaves(layout))
        if len(arrs) != 3 * n + 1:
            raise ValueError(f"checkpoint has {len(arrs)} leaves, a train state of "
                             f"{cfg.name} has {3 * n + 1}")
        return [named_from_reference(cfg, model, _unflatten(layout, arrs[i * n:(i + 1) * n]))
                for i in range(count)]

    @staticmethod
    def _fill(model, named: dict) -> None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(torch.from_numpy(np.ascontiguousarray(named[name])).to(p.device, p.dtype))

    @classmethod
    def _restore_state(cls, like: TrainState, arrs: list, device) -> TrainState:
        model = like.model if device is None else like.model.to(device)
        params, m, v = cls._trees(model, arrs, 3)
        cls._fill(model, params)
        dev = next(model.parameters()).device

        def moments(tree, like_m):
            return {name: torch.from_numpy(np.ascontiguousarray(a)).to(dev, like_m[name].dtype)
                    for name, a in tree.items()}

        return TrainState(model, AdamWState(
            moments(m, like.opt.m), moments(v, like.opt.v),
            torch.tensor(int(arrs[-1]), dtype=torch.int32, device=dev)))
