"""Training loop with fault tolerance (port of `repro.train.trainer`):

  * checkpoint every `ckpt_every` steps (async, atomic, keep-K), and a
    blocking one at the end or on preemption;
  * SIGTERM/SIGINT -> checkpoint-and-exit (preemption safety);
  * restart resumes from the latest checkpoint, the data pipeline skipping
    ahead deterministically (step-keyed batches);
  * per-step wall-time percentiles logged (the p99/median ratio is the
    straggler indicator).

Eager where the reference jits its step: each step runs the port's train
step on `device` (CUDA by default, raising without it) and reads its
metrics back to the host once."""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass

import numpy as np

from ..checkpoint import CheckpointManager
from ..core.device import resolve_device
from ..optim import cosine_schedule
from .step import TrainState, init_train_state, make_train_step


@dataclass
class TrainerConfig:
    steps: int = 100  # when THIS run stops (preemption horizon)
    total_steps: int = 0  # LR-schedule horizon; 0 = same as steps.  Kept apart
    # so that checkpoint/restart runs bit-follow uninterrupted ones (the
    # schedule must not depend on where a run was preempted).
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    peak_lr: float = 3e-4
    warmup: int = 10
    log_every: int = 10
    microbatch: int = 0
    seed: int = 0


class Trainer:
    def __init__(self, model_cfg, data_pipeline, tcfg: TrainerConfig, device=None):
        self.cfg = model_cfg
        self.data = data_pipeline
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        total = tcfg.total_steps or tcfg.steps
        lr_fn = lambda step: cosine_schedule(
            step, peak_lr=tcfg.peak_lr, warmup=tcfg.warmup, total=total
        )
        self.train_step = make_train_step(model_cfg, lr_fn, microbatch=tcfg.microbatch)
        self._preempted = False
        self.step_times: list[float] = []
        self.history: list[dict] = []

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not on the main thread (tests)

    # -- lifecycle -----------------------------------------------------------

    def init_or_restore(self) -> tuple[TrainState, int]:
        state = init_train_state(self.cfg, self.tcfg.seed, self.device)
        latest = self.ckpt.latest_step()
        if latest is None:
            return state, 0
        state, meta = self.ckpt.restore(state)
        self.data.restore(meta["extra"]["data"])
        print(f"[trainer] resumed from step {meta['step']}")
        return state, int(meta["step"])

    def run(self) -> dict:
        self._install_signal_handlers()
        state, start = self.init_or_restore()
        self.data.step = max(self.data.step, start)
        step = start
        t_all0 = time.time()
        while step < self.tcfg.steps and not self._preempted:
            batch = next(self.data)
            t0 = time.time()
            state, metrics = self.train_step(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            self.step_times.append(dt)
            step += 1
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps:
                st = np.asarray(self.step_times[-50:])
                print(
                    f"[trainer] step {step} loss={metrics['loss']:.4f} "
                    f"lr={metrics['lr']:.2e} gnorm={metrics['grad_norm']:.2f} "
                    f"t/step={np.median(st)*1e3:.0f}ms "
                    f"p99={np.percentile(st, 99)*1e3:.0f}ms",
                    flush=True,
                )
                self.history.append({"step": step, **metrics})
            if step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(
                    step, state, extra={"data": self.data.state()}, blocking=False
                )
        # final / preemption checkpoint (blocking: must land before exit)
        self.ckpt.save(step, state, extra={"data": self.data.state()}, blocking=True)
        return {
            "final_step": step,
            "preempted": self._preempted,
            "wall_s": time.time() - t_all0,
            "history": self.history,
            "final_loss": self.history[-1]["loss"] if self.history else None,
        }
