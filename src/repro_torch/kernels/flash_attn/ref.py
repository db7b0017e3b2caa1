"""Plain PyTorch version of blocked flash attention (port of
`repro.kernels.flash_attn.ref.attn_ref`, plus its batched grouped-query
form) and of its backward.  It computes the functions that the
hand-written kernels compute: masks use the true lengths, with the ends of
the query and key sequences aligned (query i sits at key position i + Skv -
Sq).  The backward's formulas are computed densely here
(`flash_attention_bwd_ref`); the tests and chip_smoke.py hold the kernels
to these, and no card path calls them.  `bf16_probs` (the models'
attn_bf16_probs) gives the function of the kernels' bf16-P forms: the
probabilities and V rounded to bf16 in the P V product, the product's sum
rounded once; `flash_attention_bf16_tiles_ref` gives the bf16-P forward
kernel's own roundings, p rounded a key tile at a time against the
running max."""
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


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and widened back: differentiable,
    the gradient passing through as through JAX's astype pair."""
    return x.to(torch.bfloat16).to(torch.float32)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, return_lse: bool = False,
                        bf16_probs: bool = False):
    """q (B, Sq, Hq, dh), k and v (B, Skv, Hkv, dh), Hq a multiple of Hkv
    (query head h reads kv head h // (Hq // Hkv)) -> (B, Sq, Hq, dh).
    Scores (q . k) / sqrt(dh), soft-capped as c tanh(s / c) when softcap
    c > 0, masked, softmax over keys in float32.  A row with no key left
    is 0 (the kernel's acc / max(l, 1e-30)).  With `return_lse`, also the
    rows' log-sum-exp (B, Sq, Hq) float32 as the kernel writes it: in base
    2, log2 sum_j 2^(z_j log2 e) of the capped scores z_j, +inf for a row
    with no key.  With `bf16_probs`, p_j = exp(z_j - max_j z_j) and out =
    bf16(sum_j bf16(p_j) bf16(v_j)) / max(l, 1e-30), l = sum_j p_j of the
    unrounded p: the reference's `chunked_attention(bf16_probs=True)`
    where the keys fit one of its chunks, whose einsum rounds its bf16 sum
    once.  Torch differentiates it as JAX does its casts: each rounding
    passes the gradient, itself rounded to bf16 where it leaves a bf16
    value."""
    B, Sq, Hq, dh = q.shape
    z, _, _, _, _ = _scores(q, k, causal, window, softcap)
    if bf16_probs:
        m = z.amax(dim=-1, keepdim=True)
        p = torch.exp(z - torch.where(torch.isneginf(m), torch.zeros_like(m), m))
        l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]  # (B, Sq, Hkv, G, 1)
        pv = torch.einsum("bhgst,bthd->bshgd", _bf16(p), _bf16(v.to(torch.float32)))
        out = _bf16(pv) / torch.clamp(l, min=1e-30)
    else:
        p = torch.nan_to_num(torch.softmax(z, dim=-1), nan=0.0)
        out = torch.einsum("bhgst,bthd->bshgd", p, v.to(torch.float32))
    out = out.reshape(B, Sq, Hq, dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(z, dim=-1) * LOG2E
    lse = torch.where(torch.isneginf(lse), torch.full_like(lse, float("inf")), lse)
    return out, _per_row(lse)


def flash_attention_bf16_tiles_ref(q, k, v, *, causal: bool = True, window: int = 0,
                                   softcap: float = 0.0, block_rows: int,
                                   key_tile: int) -> torch.Tensor:
    """The bf16-P forward as the kernel walks its keys (csrc/flash_attn.cu):
    the rows r = i G + g of a (batch row, kv head) in blocks of `block_rows`,
    each block's keys in tiles of `key_tile` from the first key any of its
    rows may see (0, or with a window the block's first row's first key).
    Each tile's p is 2^(x - m) against the running max m after that tile
    (0 where no key has been seen) and rounded to bf16 there; the
    accumulator and l are rescaled by 2^(m_old - m) a tile, the
    accumulator rounded to bf16 at the end: o = bf16(acc) / max(l, 1e-30).
    With one tile over every key this is `flash_attention_ref(...,
    bf16_probs=True)`; the kernels' tiles come from `ops.fwd_tiles`."""
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    z, _, _, _, _ = _scores(q, k, causal, window, softcap)
    x = z * LOG2E  # (B, Hkv, G, Sq, Skv), -inf where masked
    dev = q.device
    r = torch.arange(Sq, device=dev)[None, :] * G + torch.arange(G, device=dev)[:, None]
    kv_lo = torch.zeros_like(r)
    if window > 0:  # every row of a block sees no key below its first row's first
        kv_lo = torch.clamp(r // block_rows * block_rows // G + (Skv - Sq) - window + 1, min=0)
    keys = torch.arange(Skv, device=dev)
    tile = torch.div(keys - kv_lo[..., None], key_tile, rounding_mode="floor")  # (G, Sq, Skv)
    vb = _bf16(v.to(torch.float32)).permute(0, 2, 1, 3)  # (B, Hkv, Skv, dh)
    acc = torch.zeros((B, Hkv, G, Sq, dh), dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq, 1), dtype=torch.float32, device=dev)
    m = torch.full_like(l, float("-inf"))
    lo0, hi0 = (int(kv_lo.min()), int(kv_lo.max())) if Skv else (0, 0)
    for t in range(-(-(Skv - lo0) // key_tile) if Skv else 0):
        j0, j1 = lo0 + t * key_tile, min(Skv, hi0 + (t + 1) * key_tile)
        xt = x[..., j0:j1].masked_fill(tile[..., j0:j1] != t, float("-inf"))
        m_new = torch.maximum(m, xt.amax(dim=-1, keepdim=True))
        m_use = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(xt - m_use)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgst,bhtd->bhgsd", _bf16(p), vb[:, :, j0:j1])
        m = m_new
    out = _bf16(acc) / torch.clamp(l, min=1e-30)  # (B, Hkv, G, Sq, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, dh).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True, window: int = 0,
                            softcap: float = 0.0, bf16_probs: bool = False):
    """The gradient of `flash_attention_ref`'s output o with respect to q, k
    and v, given dO = `do` and the forward's base-2 row log-sum-exp `lse`
    (B, Sq, Hq), densely in float32, the formulas of the backward kernel
    (csrc/flash_attn_bwd.cu): p = 2^(z log2 e - lse) on the unmasked keys,
    delta = rowsum(dO o), dV = P^T dO, dP = dO V^T, dS = p (dP - delta)
    cap'(s) / sqrt(dh) with cap' = 1 - tanh^2 (1 without a softcap), dQ = dS
    K and dK = dS^T Q, the GQA group's heads summed into dK and dV.  With
    `bf16_probs`, the bf16-P backward kernel's: dV = bf16(P)^T bf16(dO) and
    dP = bf16(dO) bf16(V)^T, each rounding's derivative taken as 1 (dO
    rounded as the reference's cotangent cast rounds it), dS from the
    unrounded p and delta from the float32 dO.  Returns (dq, dk, dv)
    float32, shaped as q, k, v."""
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    z, th, mask, qg, scale = _scores(q, k, causal, window, softcap)
    lse_g = lse.to(torch.float32).reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)[..., None]
    p = torch.where(mask, torch.exp2(z * LOG2E - lse_g), torch.zeros_like(z))
    dog = do.to(torch.float32).reshape(B, Sq, Hkv, G, dh)
    og = o.to(torch.float32).reshape(B, Sq, Hkv, G, dh)
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]  # (B, Hkv, G, Sq, 1)
    if bf16_probs:
        dv = torch.einsum("bhgst,bshgd->bthd", _bf16(p), _bf16(dog))
        dp = torch.einsum("bshgd,bthd->bhgst", _bf16(dog), _bf16(v.to(torch.float32)))
    else:
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
