"""Attention substrate (port of `repro.models.attention`, full-sequence
forward only): GQA/MQA projections, RoPE, and the attention itself through
the `flash_attn` wrapper -- the hand-written kernel on CUDA tensors, its
plain version on CPU tensors.  That computes the reference's
`chunked_attention` (causal with the ends aligned, sliding window, logit
soft-capping); KV caches, prefill and decode are not ported yet."""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..kernels.flash_attn import ops as flash_ops
from .common import apply_rope, dense_init_


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    window: int = 0  # 0 = global
    softcap: float = 0.0
    rope_theta: float = 10000.0
    mrope: bool = False
    causal: bool = True


class Attention(nn.Module):
    """Parameters as the reference names them: wq (D, Hq dh), wk and wv
    (D, Hkv dh), wo (Hq dh, D), and bq, bk, bv with `qkv_bias`."""

    def __init__(self, cfg: AttnConfig, device=None):
        super().__init__()
        if cfg.mrope:
            raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet: ROADMAP A11")
        self.cfg = cfg
        qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
        shapes = {"wq": (cfg.d_model, qd), "wk": (cfg.d_model, kvd),
                  "wv": (cfg.d_model, kvd), "wo": (qd, cfg.d_model)}
        if cfg.qkv_bias:
            shapes.update(bq=(qd,), bk=(kvd,), bv=(kvd,))
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape, device=device)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("wq", "wk", "wv", "wo"):
            dense_init_(getattr(self, name), generator)
        if self.cfg.qkv_bias:
            with torch.no_grad():
                for name in ("bq", "bk", "bv"):
                    getattr(self, name).zero_()

    def project_qkv(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        B, S, _ = x.shape
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, S, cfg.n_kv, cfg.head_dim)
        v = v.reshape(B, S, cfg.n_kv, cfg.head_dim)
        if cfg.rope_theta > 0:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """x: (B, S, D), positions (B, S) -> (B, S, D)."""
        cfg = self.cfg
        q, k, v = self.project_qkv(x, positions)
        out = flash_ops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                                        softcap=cfg.softcap)
        return out.reshape(x.shape[0], x.shape[1], -1) @ self.wo
