"""Dry run of the port at production scale (port of `repro.launch.dryrun`):
every (architecture x shape cell x mesh) cell runs its train step, prefill
or decode step once on fake tensors, placed on a fake device mesh, and the
dry run reports per device what the reference reads from XLA: memory,
FLOPs, bytes, collectives and the roofline on H100 constants.

Nothing is allocated and no kernel is launched.  The mesh is a
`DeviceMesh` over a fake process group (`launch.mesh`): this process plays
rank 0.  The state, the batch and the caches are DTensors placed by the
specs of `launch.shardings`, their local shards fake tensors on the meta
device (a fake "cuda" tensor cannot take a gradient on a CPU-only build of
torch; the wrappers' fake branches stand in for the card's kernels on
either).  The step runs eagerly, as it runs on the card, under
`roofline.OpCounter`, which counts the local shards' ops, the collectives
DTensor's redistributions issue, the kernels' launches and the live bytes.

The record keeps the reference's keys, per device:
  memory_analysis: argument_size_in_bytes (the local shards of the state,
    the batch and the caches), temp_size_in_bytes (the peak live bytes the
    step allocates beyond them), output_size_in_bytes (the local bytes of
    what the step returns) and alias_size_in_bytes (those of them that are
    arguments updated in place);
  hlo_flops_per_device: the aten ops' FLOPs (FlopCounterMode's formulas)
    plus the kernels' products; hlo_bytes_per_device: every op's operand and
    output bytes (the unfused proxy, `roofline`); collective_bytes_per_device
    and collective_by_kind: wire bytes of the collectives;
  roofline, model_flops_total / _per_device, useful_flops_ratio.
Rank 0's shard is the largest where a dim does not divide evenly (DTensor
gives the last shards fewer rows; GSPMD pads them): its bytes are reported.

MoE cells are `not_ported`: their expert-parallel block (`_moe_sharded`)
is ROADMAP A9b.  A cell that does not apply is `skipped` with the
reference's reason.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
from torch import nn

from ..configs import SHAPES, ShapeCell, cell_applicable, get_config, input_specs
from ..models import api
from ..models.attention import CACHE_DTYPE, KVCache
from ..models.blocks import attn_cfg_for
from ..models.common import contiguous_stride
from ..models.whisper import WhisperCache
from ..optim import AdamWState, cosine_schedule
from ..sharding import specs as sp
from ..train.step import TrainState, make_train_step
from . import roofline as rf
from .mesh import make_production_mesh
from .shardings import batch_specs, cache_specs, state_specs

DRY_DEVICE = "meta"
NOT_PORTED_MOE = ("MoE under a mesh: the expert-parallel _moe_sharded is not ported yet "
                  "(ROADMAP A9b)")


def _mesh_label(mesh, multi_pod: bool | None) -> str:
    if multi_pod is not None:
        return "pod2x16x16" if multi_pod else "16x16"
    return "x".join(str(n) for n in mesh.shape)


def _placed(shape, dtype, spec, mesh):
    """A DTensor of global `shape` placed by `spec`, its local shard (rank
    0's) a meta tensor."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(sp.local_shape(shape, spec, mesh), dtype=dtype, device=DRY_DEVICE)
    return DTensor.from_local(local, mesh, sp.to_placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=contiguous_stride(shape))


def _place_model(model, specs: dict, mesh, dtype, trainable: bool = False) -> None:
    """Swap each parameter of a meta-device model for a DTensor parameter
    of `dtype` placed by its spec (zamba's shared block once)."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = nn.Parameter(_placed(p.shape, dtype, specs[name], mesh),
                                             requires_grad=trainable)


def _placed_batch(batch: dict, mesh) -> dict:
    specs = batch_specs(batch, mesh)
    return {k: _placed(tuple(v.shape), v.dtype, specs[k], mesh) for k, v in batch.items()}


def _locals(tree) -> list[torch.Tensor]:
    """The tensors of a tree (each model as its named parameters), a
    DTensor as its local shard."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_flatten(_tensor_tree(tree))[0] if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors) -> int:
    """The bytes of the tensors' storages, each storage once."""
    storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in tensors}
    return sum(storages.values())


def _tensor_tree(tree):
    """`tree` with each model (a TrainState's, or a serving model) as its
    named parameters, so that a tree walk finds their tensors."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    if isinstance(tree, TrainState):
        return (dict(tree.model.named_parameters()), tree.opt)
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tensor_tree(t) for t in tree)
    return tree


def _train_cell(cfg, cell: ShapeCell, mesh, opt_dtype, microbatch: int):
    """(the step's arguments, a thunk running it once)."""
    model = api.init_model(cfg, device=DRY_DEVICE).train()
    specs = state_specs(TrainState(model, None), mesh)
    _place_model(model, specs.model, mesh, torch.float32, trainable=True)
    od = torch.bfloat16 if opt_dtype == "bfloat16" else torch.float32
    m, v = ({name: _placed(p.shape, od, moment[name], mesh)
             for name, p in model.named_parameters()} for moment in (specs.opt.m, specs.opt.v))
    step = _placed((), torch.int32, specs.opt.step, mesh)
    state = TrainState(model, AdamWState(m, v, step))
    batch = _placed_batch(input_specs(cfg, cell, device=DRY_DEVICE), mesh)
    train_step = make_train_step(cfg, lambda s: cosine_schedule(
        s, peak_lr=3e-4, warmup=2000, total=100_000), microbatch=microbatch)
    return (state, batch), lambda: train_step(state, batch)


def _serve_model(cfg, mesh, serve_params: str):
    rules = None
    dtype = torch.float32
    if serve_params == "tp_bf16":  # bf16 weights, replicated over the DP axes
        rules, dtype = dict(sp.LOGICAL_RULES, fsdp=()), torch.bfloat16
    model = api.init_model(cfg, device=DRY_DEVICE)
    _place_model(model, sp.param_specs(cfg, dict(model.named_parameters()), mesh, rules),
                 mesh, dtype)
    return model


def decode_caches(cfg, B: int, max_len: int, length: int, device="meta"):
    """The caches of a decode cell, `length` tokens in: empty caches of
    `max_len` slots (whisper: its self KV a decoder layer and the cross K /
    V over the audio frames), on the meta device."""
    if cfg.enc_dec:
        acfg = attn_cfg_for(cfg, "attn")
        kv = (B, max_len, acfg.n_kv, acfg.head_dim)
        ctx = (B, cfg.n_audio_frames, acfg.n_kv, acfg.head_dim)
        return WhisperCache([KVCache(torch.empty(kv, dtype=CACHE_DTYPE, device=device),
                                     torch.empty(kv, dtype=CACHE_DTYPE, device=device), length)
                             for _ in range(cfg.repeats)],
                            [torch.empty(ctx, device=device) for _ in range(cfg.repeats)],
                            [torch.empty(ctx, device=device) for _ in range(cfg.repeats)],
                            length)
    return [c._replace(length=length) for c in api.init_caches(cfg, B, max_len, device=device)]


def _decode_caches(cfg, B: int, max_len: int, length: int, mesh):
    """`decode_caches` placed by `cache_specs`."""
    meta = decode_caches(cfg, B, max_len, length)
    specs = cache_specs(cfg, meta, mesh)

    def place(c, s):
        return c._replace(**{f: _placed(tuple(getattr(c, f).shape), getattr(c, f).dtype,
                                        getattr(s, f), mesh)
                             for f in c._fields if f != "length"})

    if cfg.enc_dec:
        return WhisperCache([place(c, s) for c, s in zip(meta.self_kv, specs.self_kv)],
                            [_placed(tuple(t.shape), t.dtype, s, mesh)
                             for t, s in zip(meta.ck, specs.ck)],
                            [_placed(tuple(t.shape), t.dtype, s, mesh)
                             for t, s in zip(meta.cv, specs.cv)], length)
    return [place(c, s) for c, s in zip(meta, specs)]


def lower_cell(arch: str, shape: str | ShapeCell, *, multi_pod: bool = False, mesh=None,
               opt_dtype: str = "float32", overrides: dict | None = None,
               serve_params: str = "fsdp_f32", microbatch: int = 0, cfg=None,
               top: int = 12) -> dict:
    """Run one cell once on fake tensors; returns its record (or a skip /
    not-ported record).  `mesh`: a mesh to place it on (a 1x1 fake mesh, a
    test's (2, 4)); else the production mesh of `multi_pod` (a fake process
    group of 256 or 512 ranks).  `cfg`: a config in place of the
    registry's (a smoke or depth-cut one); `overrides`: ModelConfig fields
    to replace.  `shape`: a SHAPES name or a ShapeCell.  serve_params:
    "fsdp_f32" (float32 weights sharded as in training) or "tp_bf16" (bf16
    weights replicated over the DP axes)."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = cfg or get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = cell_applicable(cfg, cell.name) if cell.name in SHAPES else (True, "")
    base = {"arch": arch, "shape": cell.name, "kind": cell.kind,
            "mesh": _mesh_label(mesh, None if mesh is not None else multi_pod)}
    if not ok:
        return {**base, "status": "skipped", "reason": why}
    if cfg.n_experts:
        return {**base, "status": "not_ported", "reason": NOT_PORTED_MOE}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    t0 = time.perf_counter()
    if cell.kind == "train":
        args, run = _train_cell(cfg, cell, mesh, opt_dtype, microbatch)
    else:
        model = _serve_model(cfg, mesh, serve_params)
        if cell.kind == "prefill":
            batch = _placed_batch(input_specs(cfg, cell, device=DRY_DEVICE), mesh)
            max_len = cell.seq_len + (cfg.n_patches if cfg.vlm else 0) + 64
            args = (model, batch)
            run = lambda: api.prefill(model, batch, max_len)  # noqa: E731
        else:
            caches = _decode_caches(cfg, cell.global_batch, cell.seq_len + 64, cell.seq_len,
                                    mesh)
            token = _placed_batch(input_specs(cfg, cell, device=DRY_DEVICE), mesh)["token"]
            args = (model, token, caches)
            run = lambda: api.decode_step(model, token, caches)  # noqa: E731
    arg_locals = _locals(args)
    counter = rf.OpCounter()
    counter.exclude(arg_locals)
    t_build = time.perf_counter() - t0
    # a plain tensor the model builds (positions, rotary tables) is the same
    # on every rank: DTensor takes it as replicated
    with sp.shard_ctx(mesh), implicit_replication(), counter:
        out = _locals(run())
    t_run = time.perf_counter() - t0 - t_build
    arg_keys = {t.untyped_storage()._cdata for t in arg_locals}
    mem = {"argument_size_in_bytes": _storage_bytes(arg_locals),
           "temp_size_in_bytes": counter.peak_bytes,
           "output_size_in_bytes": _storage_bytes(out),
           "alias_size_in_bytes": _storage_bytes(
               t for t in out if t.untyped_storage()._cdata in arg_keys)}
    totals = counter.totals()
    terms = rf.roofline_terms(totals)
    mf = rf.model_flops(cfg, cell)
    mf_dev = mf / n_chips
    return {
        **base, "status": "ok", "n_chips": n_chips,
        "build_s": t_build, "run_s": t_run,
        "memory_analysis": mem,
        **{k: totals[k] for k in ("hlo_flops_per_device", "hlo_bytes_per_device",
                                  "collective_bytes_per_device", "collective_by_kind")},
        "aten_flops_per_device": counter.aten_flops(),
        "kernel_launches": dict(counter.launches),
        "roofline": terms,
        "model_flops_total": mf,
        "model_flops_per_device": mf_dev,
        "useful_flops_ratio": mf_dev / max(totals["hlo_flops_per_device"], 1e-30),
        "breakdown": counter.breakdown(top),
        "constants": rf.CARD,
    }


def argument_bytes(cfg, cell: ShapeCell, mesh, opt_dtype: str = "float32",
                   serve_params: str = "fsdp_f32") -> int:
    """A cell's argument bytes on rank 0 from the specs alone (what
    `lower_cell`'s argument_size_in_bytes must be): a train cell's float32
    parameter shards and both moments' shards, the step and the batch's
    shards; a prefill cell's parameter shards (bf16 and replicated over the
    DP axes with "tp_bf16") and the batch's; a decode cell's parameters,
    its caches' shards and the token's."""
    from ..models.lm import LM
    from ..models.whisper import Whisper

    model = (Whisper if cfg.enc_dec else LM)(cfg, device="meta")
    named = dict(model.named_parameters())
    batch = input_specs(cfg, cell)
    b_specs = batch_specs(batch, mesh)
    n = sum(sp.shard_bytes(t.shape, t.element_size(), b_specs[k], mesh)
            for k, t in batch.items())
    if cell.kind == "train":
        specs = state_specs(TrainState(model, None), mesh)
        od = 2 if opt_dtype == "bfloat16" else 4
        n += sp.shard_bytes((), 4, specs.opt.step, mesh)
        for name, p in named.items():
            n += sp.shard_bytes(p.shape, 4, specs.model[name], mesh)
            n += sp.shard_bytes(p.shape, od, specs.opt.m[name], mesh)
            n += sp.shard_bytes(p.shape, od, specs.opt.v[name], mesh)
        return n
    rules = dict(sp.LOGICAL_RULES, fsdp=()) if serve_params == "tp_bf16" else None
    p_specs = sp.param_specs(cfg, named, mesh, rules)
    size = 2 if serve_params == "tp_bf16" else 4
    n += sum(sp.shard_bytes(p.shape, size, p_specs[name], mesh) for name, p in named.items())
    if cell.kind == "decode":
        caches = decode_caches(cfg, cell.global_batch, cell.seq_len + 64, cell.seq_len)
        n += sum(sp.shard_bytes(t.shape, t.element_size(), s, mesh)
                 for t, s in _cache_pairs(caches, cache_specs(cfg, caches, mesh)))
    return n


def _cache_pairs(caches, specs):
    """(tensor, spec) of each tensor of a port's caches and their specs."""
    if isinstance(caches, WhisperCache):
        for c, s in zip(caches.self_kv, specs.self_kv, strict=True):
            yield from ((c.k, s.k), (c.v, s.v))
        yield from zip(caches.ck, specs.ck, strict=True)
        yield from zip(caches.cv, specs.cv, strict=True)
        return
    for c, s in zip(caches, specs, strict=True):
        yield from ((getattr(c, f), getattr(s, f)) for f in c._fields if f != "length")


def parse_overrides(pairs: list[str]) -> dict:
    """--set k=v pairs: True / False, ints and floats as such, else strings."""
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            out[k] = v == "True"
        elif v.lstrip("-").isdigit():
            out[k] = int(v)
        else:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def main(argv: list[str] | None = None) -> int:
    from ..configs import ARCHS
    from .mesh import release_fake_group

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--opt-dtype", default="float32")
    ap.add_argument("--serve-params", default="fsdp_f32", choices=["fsdp_f32", "tp_bf16"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override, e.g. --set remat_policy=nothing")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    overrides = parse_overrides(args.set)
    out_path = Path(args.out) if args.out else None
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)
    n_fail = 0
    t_all = time.perf_counter()
    try:
        for mp in meshes:  # one fake group a mesh size
            for arch in archs:
                for shape in shapes:
                    label = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                    try:
                        res = lower_cell(arch, shape, multi_pod=mp, opt_dtype=args.opt_dtype,
                                         overrides=overrides, serve_params=args.serve_params,
                                         microbatch=args.microbatch)
                    except Exception as e:  # a cell's failure is its record; the grid goes on
                        traceback.print_exc()
                        res = {"arch": arch, "shape": shape,
                               "mesh": "pod2x16x16" if mp else "16x16",
                               "status": "error", "error": f"{type(e).__name__}: {e}"}
                        n_fail += 1
                    _print(label, res)
                    if out_path:
                        with open(out_path, "a") as f:
                            f.write(json.dumps(res) + "\n")
    finally:
        release_fake_group()
    print(f"[dryrun] {len(archs) * len(shapes) * len(meshes)} cells, {n_fail} errors, "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    return 1 if n_fail else 0


def _print(label: str, res: dict) -> None:
    if res["status"] == "ok":
        r = res["roofline"]
        m = res["memory_analysis"]
        print(f"[OK]   {label}: run={res['run_s']:.1f}s bottleneck={r['bottleneck']} "
              f"terms(c/m/x)={r['compute_s']:.4f}/{r['memory_s']:.4f}/{r['collective_s']:.4f}s "
              f"useful={res['useful_flops_ratio']:.2f} args+temp="
              f"{(m['argument_size_in_bytes'] + m['temp_size_in_bytes']) / 2**30:.1f}GiB",
              flush=True)
    elif res["status"] in ("skipped", "not_ported"):
        print(f"[{res['status'].upper()}] {label}: {res['reason']}", flush=True)
    else:
        print(f"[FAIL] {label}: {res.get('error')}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
