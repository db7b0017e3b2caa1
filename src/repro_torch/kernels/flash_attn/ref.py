"""Plain PyTorch version of blocked flash attention (port of
`repro.kernels.flash_attn.ref.attn_ref`, plus its batched grouped-query
form).  It computes the function that the hand-written kernel computes:
masks use the true lengths, with the ends of the query and key sequences
aligned (query i sits at key position i + Skv - Sq)."""
from __future__ import annotations

import torch

from ..common import no_tf32


def attn_mask(Sq: int, Skv: int, *, causal: bool, window: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: True where query i may attend to key j."""
    qp = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    kp = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, Hq, dh), k and v (B, Skv, Hkv, dh), Hq a multiple of Hkv
    (query head h reads kv head h // (Hq // Hkv)) -> (B, Sq, Hq, dh).
    Scores (q . k) / sqrt(dh), soft-capped as c tanh(s / c) when softcap
    c > 0, masked, softmax over keys in float32.  A row with no key left
    is 0 (the kernel's acc / max(l, 1e-30))."""
    no_tf32()
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))
    qg = q.to(torch.float32).reshape(B, Sq, Hkv, groups, dh)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.to(torch.float32)) * scale.to(q.device)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    mask = attn_mask(Sq, Skv, causal=causal, window=window, device=q.device)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, Hq, dh).to(q.dtype)


def attn_ref(q, k, v, *, causal: bool = True, window: int = 0,
             softcap: float = 0.0) -> torch.Tensor:
    """One head: q (Sq, dh), k and v (Skv, dh) -> (Sq, dh)."""
    out = flash_attention_ref(q[None, :, None], k[None, :, None], v[None, :, None],
                              causal=causal, window=window, softcap=softcap)
    return out[0, :, 0]
