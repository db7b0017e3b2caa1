"""Training launcher of the port: config -> data -> fault-tolerant loop (port
of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke \\
        --device cpu --steps 100 --ckpt-dir /tmp/run1 [--dedup]

Trains on the card unless `--device cpu`.  Re-running the same command
after an interruption resumes from the latest checkpoint in --ckpt-dir,
which `repro_torch.launch.serve --ckpt-dir` (and the reference's launchers)
can restore.  One process, one device: `--mesh` (the reference's data x
model mesh) is not ported yet (ROADMAP A12).
"""
from __future__ import annotations

import argparse

from ..configs import ARCHS
from ..core.device import resolve_device
from ..data import DataPipeline, lm_token_batches
from ..data.dedup import NearDupFilter
from ..train.trainer import Trainer, TrainerConfig


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
                    help="'DxM' data x model mesh: not ported yet (ROADMAP A12)")
    ap.add_argument("--device", default="cuda",
                    help="device of the model, the optimizer and the filter (cuda or cpu)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh: device meshes are not ported yet (ROADMAP A12); "
                                  "the port trains on one device")
    device = resolve_device(args.device)
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
