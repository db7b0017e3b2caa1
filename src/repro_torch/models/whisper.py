"""Whisper-style encoder-decoder (port of `repro.models.whisper`).  The conv
audio frontend is a stub, as in the reference: its inputs are precomputed
frame embeddings (B, S_enc, d_model).

Encoder: sinusoidal positions, then layers of bidirectional self-attention
and a GELU MLP, then a layer norm.  Decoder: learned positions, then layers
of causal self-attention, cross attention over the encoder's states and a
GELU MLP, then a layer norm and the tied unembedding.  Every attention has
Q, K and V biases and no rotary, and runs through the `flash_attn` wrapper:
the encoder's and the cross attention not causal, the decoder's causal.

Parameters carry the reference's names ({enc, dec}.{i}.{ln1, attn,
self_attn, ln_x, cross_attn, ln2, mlp}...), with the reference's per-layer
stacks unstacked by layer (`convert.params_from_reference`)."""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .attention import Attention, AttnConfig, KVCache
from .common import (embedding_lookup, layer_norm, matmul, sinusoidal_positions,
                     softmax_cross_entropy)
from ..sharding import with_logical_constraint as wlc
from .ffn import MLP


def attn_cfg(cfg, causal: bool) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                      head_dim=cfg.head_dim, qkv_bias=True, rope_theta=0.0, causal=causal)


class LayerNorm(nn.Module):
    """`scale` and `bias` (d,), eps 1e-5 (the reference's `layer_norm`)."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, device=device))
        self.bias = nn.Parameter(torch.empty(d, device=device))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias)


def _mlp(cfg, device) -> MLP:
    return MLP(cfg.d_model, cfg.d_ff, gated=False, activation="gelu", device=device)


class EncoderLayer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, device)
        self.attn = Attention(attn_cfg(cfg, causal=False), device=device)
        self.ln2 = LayerNorm(cfg.d_model, device)
        self.mlp = _mlp(cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), None)
        return x + self.mlp(self.ln2(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, device)
        self.self_attn = Attention(attn_cfg(cfg, causal=True), device=device)
        self.ln_x = LayerNorm(cfg.d_model, device)
        self.cross_attn = Attention(attn_cfg(cfg, causal=False), device=device)
        self.ln2 = LayerNorm(cfg.d_model, device)
        self.mlp = _mlp(cfg, device)

    def _rest(self, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
        """The cross attention and the MLP after the self-attention."""
        x = x + self.cross_attn.cross(self.ln_x(x), ck, cv)
        return x + self.mlp(self.ln2(x))

    def forward(self, x, ck, cv):
        return self._rest(x + self.self_attn(self.ln1(x), None), ck, cv)

    def prefill(self, x, ck, cv, max_len: int):
        a, cache = self.self_attn.prefill(self.ln1(x), None, max_len)
        return self._rest(x + a, ck, cv), cache

    def decode(self, x, ck, cv, cache: KVCache):
        a, cache = self.self_attn.decode(self.ln1(x), cache, None)
        return self._rest(x + a, ck, cv), cache


class WhisperCache(NamedTuple):
    """The decoder's caches (the reference's {"self", "ck", "cv",
    "length"}): a bf16 KVCache a layer for its self-attention, written by
    decode; each layer's cross-attention keys and values over the
    encoder's states, (B, S_enc, Hkv, dh) float32 as the reference keeps
    them, computed once by prefill and never rewritten; the tokens seen."""
    self_kv: list
    ck: list
    cv: list
    length: int


class Whisper(nn.Module):
    """Parameters: `embedding` (vocab_padded, D), tied; `pos_embedding`
    (max_pos, D), the decoder's learned positions; `enc` and `dec`, the
    layers; `enc_ln` and `dec_ln`.  Built with uninitialised storage on
    `device`; `reset_parameters` fills it (see `api.init_model`)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if not cfg.enc_dec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder")
        self.cfg = cfg
        D = cfg.d_model
        self.embedding = nn.Parameter(torch.empty((cfg.vocab_padded, D), device=device))
        self.pos_embedding = nn.Parameter(torch.empty((cfg.max_pos, D), device=device))
        self.enc = nn.ModuleList(EncoderLayer(cfg, device) for _ in range(cfg.n_enc_layers))
        self.dec = nn.ModuleList(DecoderLayer(cfg, device)
                                 for _ in range(cfg.n_layers - cfg.n_enc_layers))
        self.enc_ln = LayerNorm(D, device)
        self.dec_ln = LayerNorm(D, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions: embedding normal * 0.02, positions
        normal * 0.01, dense weights normal / sqrt(fan_in), biases 0, layer
        norms one and zero."""
        with torch.no_grad():
            self.embedding.normal_(0.0, 0.02, generator=generator)
            self.pos_embedding.normal_(0.0, 0.01, generator=generator)
        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.reset_parameters()
            elif isinstance(m, (Attention, MLP)):
                m.reset_parameters(generator)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, S_enc, D) float32 -> the encoder's states (B, S_enc, D)."""
        S, D = frames.shape[1:]
        x = frames + sinusoidal_positions(S, D, device=frames.device)[None].to(frames.dtype)
        for layer in self.enc:
            x = layer(x)
        return self.enc_ln(x)

    def _embed(self, tokens: torch.Tensor, start: int) -> torch.Tensor:
        """tokens (B, S) at positions start .. start + S - 1 -> (B, S, D)."""
        if start + tokens.shape[1] > self.cfg.max_pos:
            raise ValueError(f"position {start + tokens.shape[1] - 1} is past the "
                             f"{self.cfg.max_pos} learned positions")
        return (embedding_lookup(self.embedding, tokens)
                + self.pos_embedding[start:start + tokens.shape[1]][None])

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Hidden states -> logits through the tied embedding.  Under a mesh
        the LM's layout: the sequence whole, the logits split by vocab (the
        reference constrains neither; GSPMD picks a layout of its own)."""
        x = wlc(x, "batch", None, None)
        return wlc(matmul(x, self.embedding.T), "batch", None, "vocab")

    def decode_train(self, tokens: torch.Tensor, enc_states: torch.Tensor) -> torch.Tensor:
        """The decoder over tokens (B, S) at positions 0 .. S - 1 and the
        encoder's states -> logits (B, S, vocab_padded) (the reference's
        `decode_train`, the training forward)."""
        x = self._embed(tokens, 0)
        for layer in self.dec:
            x = layer(x, *layer.cross_attn.project_ctx_kv(enc_states))
        return self.unembed(self.dec_ln(x))

    def loss(self, frames: torch.Tensor, tokens: torch.Tensor, labels: torch.Tensor,
             mask=None):
        """The mean cross-entropy of `labels` under `decode_train` (over the
        tokens where `mask` is set); aux 0.  Returns (loss, {"ce", "aux"})."""
        ce = softmax_cross_entropy(self.decode_train(tokens, self.encode(frames)), labels, mask)
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=ce.device)}

    def prefill(self, frames: torch.Tensor, tokens: torch.Tensor, max_len: int):
        """Encode the audio, run the decoder over the prompt (B, S) and build
        its caches (self-attention caches of `max_len` slots).  Returns (the
        last position's logits (B, vocab_padded), a WhisperCache)."""
        enc = self.encode(frames)
        x = self._embed(tokens, 0)
        kv, cks, cvs = [], [], []
        for layer in self.dec:
            ck, cv = layer.cross_attn.project_ctx_kv(enc)
            x, cache = layer.prefill(x, ck, cv, max_len)
            kv.append(cache)
            cks.append(ck)
            cvs.append(cv)
        logits = self.unembed(self.dec_ln(x[:, -1:]))[:, 0]
        return logits, WhisperCache(kv, cks, cvs, tokens.shape[1])

    def decode_step(self, token: torch.Tensor, caches: WhisperCache):
        """One token a sequence, token (B, 1) int, at position
        `caches.length`.  Returns (logits (B, vocab_padded), the caches one
        token longer; the self-attention caches written in place)."""
        if len(caches.self_kv) != len(self.dec):
            raise ValueError(f"{len(caches.self_kv)} caches for {len(self.dec)} decoder layers")
        x = self._embed(token, caches.length)
        kv = []
        for layer, cache, ck, cv in zip(self.dec, caches.self_kv, caches.ck, caches.cv):
            x, cache = layer.decode(x, ck, cv, cache)
            kv.append(cache)
        logits = self.unembed(self.dec_ln(x))[:, 0]
        return logits, caches._replace(self_kv=kv, length=caches.length + 1)
