"""LR schedules (port of `repro.optim.schedule`)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to `peak_lr` over `warmup` steps, then a cosine decay to
    `floor * peak_lr` at `total`; a float32 scalar tensor on the device of
    `step` (an int, or an integer tensor: the AdamW step, so that no host
    sync is needed), computed in float32 as the reference's."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
