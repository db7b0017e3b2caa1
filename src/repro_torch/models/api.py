"""Model construction (port of `repro.models.api.init_model`)."""
from __future__ import annotations

import torch

from ..core.index import resolve_device
from .lm import LM


def init_model(cfg, seed: int = 0, device=None) -> LM:
    """A randomly initialised `LM` for `cfg` on `device` (None = CUDA; raises
    without it).  The weights are drawn on the device itself from a
    `torch.Generator` seeded with `seed`, so a full-width model is never
    built on the host and copied.  Returned in eval mode without gradients
    (the port serves; it does not train yet)."""
    dev = resolve_device(device)
    model = LM(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.reset_parameters(gen)
    return model.eval().requires_grad_(False)
