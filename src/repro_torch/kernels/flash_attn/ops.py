"""Public wrapper for batched grouped-query flash attention (port of
`repro.kernels.flash_attn.ops.flash_attention`): the hand-written kernel
(`csrc/flash_attn.cu`, `flash_attn_launch`) on CUDA tensors, its plain
version (`ref.flash_attention_ref`) on CPU tensors.  The kernel reads each
kv head in place for its group of query heads (K and V are not repeated)."""
from __future__ import annotations

import torch

from .. import common
from .ref import flash_attention_ref

# the kernel keeps a query row's accumulator in registers, 64 columns a chunk,
# at most four chunks
MAX_DH = 256


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, Hq, dh), k and v (B, Skv, Hkv, dh) float32, Hq a multiple of
    Hkv -> (B, Sq, Hq, dh) float32.  `causal` aligns the ends (query i sits
    at key position i + Skv - Sq); `window` > 0 keeps the last `window` keys
    up to that position; `softcap` > 0 caps the scores as c tanh(s / c)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn: unsupported device {q.device}")
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    common.check("q", q, device=dev, dtype=torch.float32, shape=(B, Sq, Hq, dh))
    common.check("k", k, device=dev, dtype=torch.float32, shape=(B, Skv, Hkv, dh))
    common.check("v", v, device=dev, dtype=torch.float32, shape=(B, Skv, Hkv, dh))
    if Hq % Hkv != 0:
        raise ValueError(f"flash_attn: {Hq} query heads are not a multiple of {Hkv} kv heads")
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"flash_attn: the kernel takes 1 <= dh <= {MAX_DH}, got {dh}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    common.launch("flash_attn", "flash_attn_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, Sq, Skv, Hq, Hkv, dh, int(causal), int(window),
                  float(softcap))
    return out
