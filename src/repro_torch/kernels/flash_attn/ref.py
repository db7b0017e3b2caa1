"""Plain PyTorch version of blocked flash attention (port of
`repro.kernels.flash_attn.ref.attn_ref`, plus its batched grouped-query
form) and of its backward.  It computes the functions that the
hand-written kernels compute: masks use the true lengths, with the ends of
the query and key sequences aligned (query i sits at key position i + Skv -
Sq).  The backward's formulas are computed densely here
(`flash_attention_bwd_ref`); the tests and chip_smoke.py hold the kernels
to these, and no card path calls them."""
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


LOG2E = 1.4426950408889634


def _scores(q, k, causal: bool, window: int, softcap: float):
    """The capped, masked scores z (B, Hkv, G, Sq, Skv) in float32 (-inf where
    masked), tanh of the capped argument (None without a softcap), the mask,
    q grouped (B, Sq, Hkv, G, dh) and the scale 1 / sqrt(dh)."""
    no_tf32()
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))
    qg = q.to(torch.float32).reshape(B, Sq, Hkv, Hq // Hkv, dh)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.to(torch.float32)) * scale.to(q.device)
    th = None
    if softcap > 0.0:
        th = torch.tanh(s / softcap)
        s = softcap * th
    mask = attn_mask(Sq, Skv, causal=causal, window=window, device=q.device)
    return s.masked_fill(~mask, float("-inf")), th, mask, qg, scale.to(q.device)


def _per_row(x: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, G, Sq) -> (B, Sq, Hq), query head h = kv head * G + g."""
    B, Hkv, G, Sq = x.shape
    return x.permute(0, 3, 1, 2).reshape(B, Sq, Hkv * G)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, return_lse: bool = False):
    """q (B, Sq, Hq, dh), k and v (B, Skv, Hkv, dh), Hq a multiple of Hkv
    (query head h reads kv head h // (Hq // Hkv)) -> (B, Sq, Hq, dh).
    Scores (q . k) / sqrt(dh), soft-capped as c tanh(s / c) when softcap
    c > 0, masked, softmax over keys in float32.  A row with no key left
    is 0 (the kernel's acc / max(l, 1e-30)).  With `return_lse`, also the
    rows' log-sum-exp (B, Sq, Hq) float32 as the kernel writes it: in base
    2, log2 sum_j 2^(z_j log2 e) of the capped scores z_j, +inf for a row
    with no key."""
    B, Sq, Hq, dh = q.shape
    z, _, _, _, _ = _scores(q, k, causal, window, softcap)
    p = torch.nan_to_num(torch.softmax(z, dim=-1), nan=0.0)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.to(torch.float32))
    out = out.reshape(B, Sq, Hq, dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(z, dim=-1) * LOG2E
    lse = torch.where(torch.isneginf(lse), torch.full_like(lse, float("inf")), lse)
    return out, _per_row(lse)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True, window: int = 0,
                            softcap: float = 0.0):
    """The gradient of `flash_attention_ref`'s output o with respect to q, k
    and v, given dO = `do` and the forward's base-2 row log-sum-exp `lse`
    (B, Sq, Hq), densely in float32, the formulas of the backward kernel
    (csrc/flash_attn_bwd.cu): p = 2^(z log2 e - lse) on the unmasked keys,
    delta = rowsum(dO o), dV = P^T dO, dP = dO V^T, dS = p (dP - delta)
    cap'(s) / sqrt(dh) with cap' = 1 - tanh^2 (1 without a softcap), dQ = dS
    K and dK = dS^T Q, the GQA group's heads summed into dK and dV.
    Returns (dq, dk, dv) float32, shaped as q, k, v."""
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    z, th, mask, qg, scale = _scores(q, k, causal, window, softcap)
    lse_g = lse.to(torch.float32).reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)[..., None]
    p = torch.where(mask, torch.exp2(z * LOG2E - lse_g), torch.zeros_like(z))
    dog = do.to(torch.float32).reshape(B, Sq, Hkv, G, dh)
    og = o.to(torch.float32).reshape(B, Sq, Hkv, G, dh)
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]  # (B, Hkv, G, Sq, 1)
    dv = torch.einsum("bhgst,bshgd->bthd", p, dog)
    dp = torch.einsum("bshgd,bthd->bhgst", dog, v.to(torch.float32))
    ds = p * (dp - delta) * scale
    if th is not None:
        ds = ds * (1.0 - th * th)
    dq = torch.einsum("bhgst,bthd->bshgd", ds, k.to(torch.float32)).reshape(B, Sq, Hq, dh)
    dk = torch.einsum("bhgst,bshgd->bthd", ds, qg)
    return dq, dk, dv


def attn_ref(q, k, v, *, causal: bool = True, window: int = 0,
             softcap: float = 0.0) -> torch.Tensor:
    """One head: q (Sq, dh), k and v (Skv, dh) -> (Sq, dh)."""
    out = flash_attention_ref(q[None, :, None], k[None, :, None], v[None, :, None],
                              causal=causal, window=window, softcap=softcap)
    return out[0, :, 0]
