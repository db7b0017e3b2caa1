"""Optimizer substrate of the port (PyTorch counterpart of `repro.optim`):
functional AdamW over a model's named parameters, global-norm clipping,
the cosine schedule, and int8 gradient compression over a
`torch.distributed` process group."""
from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .grad_compress import compress_psum_int8, dequantize_int8, quantize_int8
from .schedule import cosine_schedule

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "compress_psum_int8",
    "cosine_schedule",
    "dequantize_int8",
    "quantize_int8",
]
