"""Training launcher of the port: config -> data -> fault-tolerant loop (port
of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke \\
        --device cpu --steps 100 --ckpt-dir /tmp/run1 [--dedup]

Trains on the card unless `--device cpu`.  Re-running the same command
after an interruption resumes from the latest checkpoint in --ckpt-dir,
which `repro_torch.launch.serve --ckpt-dir` (and the reference's launchers)
can restore.  `--mesh DxM` builds the reference's data x model mesh over
the default process group (NCCL on the card, gloo on the CPU; started here
at tcp://localhost:<a free port> with world size 1 and rank 0 where none
is up) and trains under it (`sharding.shard_ctx`).  The state stays plain
tensors on one device, so the models' constraints do nothing and the
losses are those of a run without it, bit for bit; a mesh of more ranks
than the group has raises, and so does a MoE model (its expert-parallel
block is ROADMAP A9b).
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from ..configs import ARCHS
from ..core.device import resolve_device
from ..data import DataPipeline, lm_token_batches
from ..data.dedup import NearDupFilter
from ..sharding import shard_ctx
from ..train.trainer import Trainer, TrainerConfig
from .mesh import init_group, make_debug_mesh


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--total-steps", type=int, default=0)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--peak-lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--dedup", action="store_true",
                    help="enable the LCCS-LSH near-dup data filter")
    ap.add_argument("--mesh", default=None,
                    help="'DxM' data x model mesh over the process group (at most its ranks)")
    ap.add_argument("--device", default="cuda",
                    help="device of the model, the optimizer and the filter (cuda or cpu)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    own_group = bool(args.mesh) and not dist.is_initialized()
    if own_group:
        init_group(device)
    try:
        mesh = make_debug_mesh(*(int(v) for v in args.mesh.lower().split("x"))) \
            if args.mesh else None
        with shard_ctx(mesh):
            return _train(args, device)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args: argparse.Namespace, device) -> dict:
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = cfg.smoke()
    n_shards = 1  # one process; the reference shards by process index across hosts
    data = DataPipeline(
        lm_token_batches(vocab=cfg.vocab, seed=0),
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        n_shards=n_shards,
        dedup=NearDupFilter(threshold=30, device=device) if args.dedup else None,
    )
    tcfg = TrainerConfig(
        steps=args.steps, total_steps=args.total_steps,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        peak_lr=args.peak_lr, microbatch=args.microbatch,
    )
    out = Trainer(cfg, data, tcfg, device=device).run()
    dropped = f" dropped={data.dedup.n_dropped}" if data.dedup is not None else ""
    print(
        f"[launch.train] {args.arch}: step={out['final_step']} "
        f"loss={out['final_loss']} wall={out['wall_s']:.1f}s "
        f"preempted={out['preempted']}{dropped}"
    )
    return out

if __name__ == "__main__":
    main()
