"""Shared model components (port of `repro.models.common`): norms, rotary
embeddings (RoPE, M-RoPE), whisper's sinusoidal positions, the dense
initialiser, the cross-entropy."""
from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), in float32 (gemma's form:
    a zero scale is the identity gain)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(dt)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the dtype jnp's `@` computes: both operands promoted to
    `torch.promote_types` of theirs (bf16 with float32 gives float32), where
    torch's `@` refuses a mix.  The casts are no-ops when the dtypes agree."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t) @ b.to(t)


def dense_init_(w: torch.Tensor, generator: torch.Generator, in_axis: int = 0) -> torch.Tensor:
    """Fill `w` in place with normal / sqrt(fan_in), fan_in = w.shape[in_axis]
    (the reference's `dense_init`)."""
    with torch.no_grad():
        return w.normal_(0.0, 1.0 / math.sqrt(w.shape[in_axis]), generator=generator)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) int."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)  # (dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
                sections: tuple[float, float, float] = (0.25, 0.375, 0.375)) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x: (B, S, H, dh); positions: (B, S, 3)
    int, the (temporal, height, width) streams.  The dh/2 frequency slots
    fall into three sections, int(half * 0.25) driven by t and int(half *
    0.375) by h, the rest by w (16 / 24 / 24 at dh 128).  Where the three
    streams are equal (text) this is `apply_rope`."""
    dh = x.shape[-1]
    half = dh // 2
    n_t = int(half * sections[0])
    n_h = int(half * sections[1])
    sec_pos = torch.cat([positions[..., i:i + 1].expand(*positions.shape[:-1], n)
                         for i, n in enumerate((n_t, n_h, half - n_t - n_h))], dim=-1)
    ang = sec_pos.to(torch.float32) * rope_freqs(dh, theta, device=x.device)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper's fixed position table (max_len, d_model) float32: [sin |
    cos] of pos / 10000^(2i / d_model), the two halves concatenated (not
    interleaved)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d_model))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean negative log-likelihood over tokens, in float32 through
    logsumexp.  logits (B, S, V), labels (B, S) int; with `mask` (B, S) the
    sum of nll * mask over max(sum(mask), 1)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
