"""Attention substrate (port of `repro.models.attention`): GQA/MQA
projections, RoPE and M-RoPE, the full-sequence forward, prefill and
one-token decode with a KV cache, and whisper's cross attention over an
encoder's keys and values.  The attention itself runs through the
`flash_attn` wrapper -- the hand-written kernel on CUDA tensors, its plain
version on CPU tensors --, which computes the reference's
`chunked_attention` (causal with the ends aligned, or not causal;
sliding window, logit soft-capping) and, at Sq = 1 over the cache's live
keys, its `attention_decode`.  A layer built with `bf16_probs` (the
config's attn_bf16_probs, which the blocks pass) runs its full-sequence
forward and prefill through the kernel's bf16-P form, as the reference's
`attention_block` and `attention_prefill` take the knob; its decode and
cross attention never do, as the reference's `attention_decode` and
whisper's calls read no knob."""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..kernels.flash_attn import ops as flash_ops
from .common import apply_mrope, apply_rope, dense_init_, matmul


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


# the reference's cache dtype (`repro.models.attention.init_cache`)
CACHE_DTYPE = torch.bfloat16


class KVCache(NamedTuple):
    """A layer's keys and values, (B, S_max, Hkv, dh) in bf16, and the number
    of tokens in them: one count for the batch, as in the reference, kept a
    Python int so that a decode step needs no host sync."""
    k: torch.Tensor
    v: torch.Tensor
    length: int


def init_cache(cfg: AttnConfig, batch: int, max_len: int, device=None) -> KVCache:
    shape = (batch, max_len, cfg.n_kv, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
                   torch.zeros(shape, dtype=CACHE_DTYPE, device=device), 0)


class Attention(nn.Module):
    """Parameters as the reference names them: wq (D, Hq dh), wk and wv
    (D, Hkv dh), wo (Hq dh, D), and bq, bk, bv with `qkv_bias`.
    `bf16_probs`: the forward and prefill round P and V to bf16 in the P V
    product (the reference's attn_bf16_probs)."""

    def __init__(self, cfg: AttnConfig, device=None, bf16_probs: bool = False):
        super().__init__()
        self.cfg = cfg
        self.bf16_probs = bf16_probs
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

    def _project(self, x: torch.Tensor, name: str, heads: int) -> torch.Tensor:
        """x (B, S, D) @ w{name} (+ b{name}) -> (B, S, heads, dh)."""
        out = matmul(x, getattr(self, f"w{name}"))
        if self.cfg.qkv_bias:
            out = out + getattr(self, f"b{name}")
        return out.reshape(x.shape[0], x.shape[1], heads, self.cfg.head_dim)

    def project_qkv(self, x: torch.Tensor, positions: torch.Tensor | None):
        """q, k, v of x (B, S, D), rotated at `positions`: (B, S, 3) streams
        with `mrope`, else (B, S) (or the first of three streams, as the
        reference reads them); None where the layer has no rotary."""
        cfg = self.cfg
        q = self._project(x, "q", cfg.n_heads)
        k = self._project(x, "k", cfg.n_kv)
        v = self._project(x, "v", cfg.n_kv)
        if cfg.mrope:
            q = apply_mrope(q, positions, cfg.rope_theta)
            k = apply_mrope(k, positions, cfg.rope_theta)
        elif cfg.rope_theta > 0:
            pos1 = positions if positions.ndim == 2 else positions[..., 0]
            q = apply_rope(q, pos1, cfg.rope_theta)
            k = apply_rope(k, pos1, cfg.rope_theta)
        return q, k, v

    def _attend(self, q, k, v, bf16_probs: bool = False) -> torch.Tensor:
        """q (B, S, Hq, dh) over k, v -> the output projection (B, S, D).  The
        attention runs in float32 and its output is cast back to q's dtype,
        as the reference's (a bf16 training forward reaches the float32
        kernel; float32 serving is unchanged); `bf16_probs` takes the
        bf16-P form."""
        cfg = self.cfg
        f32 = torch.float32
        out = flash_ops.flash_attention(q.to(f32), k.to(f32), v.to(f32), causal=cfg.causal,
                                        window=cfg.window, softcap=cfg.softcap,
                                        bf16_probs=bf16_probs)
        return matmul(out.to(q.dtype).reshape(q.shape[0], q.shape[1], -1), self.wo)

    def forward(self, x: torch.Tensor, positions: torch.Tensor | None) -> torch.Tensor:
        """x: (B, S, D), positions as `project_qkv` -> (B, S, D)."""
        return self._attend(*self.project_qkv(x, positions), bf16_probs=self.bf16_probs)

    def project_ctx_kv(self, ctx: torch.Tensor):
        """The keys and values of an encoder's states ctx (B, S_enc, D), no
        rotary: (B, S_enc, Hkv, dh) each (the reference's `project_ctx_kv`)."""
        return self._project(ctx, "k", self.cfg.n_kv), self._project(ctx, "v", self.cfg.n_kv)

    def cross(self, x: torch.Tensor, ctx_k: torch.Tensor, ctx_v: torch.Tensor) -> torch.Tensor:
        """Cross attention of x (B, S, D) over an encoder's keys and values
        (`project_ctx_kv`), causal as the layer's config (whisper builds its
        cross attention not causal), as the reference's `cross_attention`
        -> (B, S, D)."""
        return self._attend(self._project(x, "q", self.cfg.n_heads), ctx_k, ctx_v)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor | None, max_len: int):
        """The forward over a prompt, and a cache of `max_len` slots holding
        its keys and values.  The attention reads them in float32; only the
        cache holds them rounded to bf16.  Returns (out (B, S, D), KVCache)."""
        B, S, _ = x.shape
        if S > max_len:
            raise ValueError(f"a prompt of {S} tokens does not fit a cache of {max_len}")
        q, k, v = self.project_qkv(x, positions)
        out = self._attend(q, k, v, bf16_probs=self.bf16_probs)
        cache = init_cache(self.cfg, B, max_len, device=x.device)
        cache.k[:, :S] = k
        cache.v[:, :S] = v
        return out, cache._replace(length=S)

    def decode(self, x: torch.Tensor, cache: KVCache, position: torch.Tensor | None):
        """One token, x (B, 1, D), at position `cache.length`, which
        `position` (B, 1), or (B, 1, 3) with `mrope`, holds (built once a
        step by the caller; None without rotary).  Its key and
        value are written into the cache first (in place: the slot beyond
        the given cache's length), then the live keys are read back as
        float32, so the token's own key is seen rounded, as in the
        reference: [lo, length] with lo = length + 1 - window for a local
        layer, else 0.  The attention's aligned ends put the query at key
        position `length`, where its window keeps the keys the reference's
        mask keeps.  Returns (out (B, 1, D), the cache one token longer)."""
        cfg = self.cfg
        t = cache.length
        if t >= cache.k.shape[1]:
            raise ValueError(f"the cache is full: {t} of {cache.k.shape[1]} slots")
        q, k, v = self.project_qkv(x, position)
        cache.k[:, t] = k[:, 0]
        cache.v[:, t] = v[:, 0]
        lo = max(0, t + 1 - cfg.window) if cfg.window > 0 else 0
        keys, values = (c[:, lo:t + 1].to(torch.float32).contiguous()
                        for c in (cache.k, cache.v))
        return self._attend(q, keys, values), cache._replace(length=t + 1)
