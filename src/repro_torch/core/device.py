"""The port's device rule, in one place: an entry point given no device
runs on CUDA, and raises where CUDA is absent instead of dropping to the
CPU.  A module of its own, so that `lsh` (which `index` imports) can apply
it too without an import cycle."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> CUDA.  Raises when CUDA is asked for but absent: the port never
    drops to the CPU on its own (pass device="cpu" for that)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; pass device='cpu' to build "
            "or load an index on the CPU"
        )
    return dev
