"""Layer blocks (port of `repro.models.blocks`): the kinds attn / global /
local / dense (attention + MLP), moe (attention + the MoE FFN), m1 / m2
(Mamba-1 / Mamba-2) and shared_attn (zamba's shared transformer block: an
attention + MLP layer whose one set of weights the LM applies at every
repeat), each in the reference's three modes -- the full-sequence forward,
prefill (which also builds the layer's cache) and one-token decode against
it.  The config's bf16 activation knobs reach the layers as the reference's
`apply_block` passes them: attn_bf16_probs to the attention's forward and
prefill, ssm_bf16_acts (with ssm_fused_chunks) to Mamba-1's."""
from __future__ import annotations

import torch
from torch import nn

from .attention import Attention, AttnConfig, init_cache
from .common import layer_norm, rms_norm
from .ffn import MLP
from .moe import MoE, MoEConfig
from .ssm import (Mamba1, Mamba1Config, Mamba2, Mamba2Config, init_mamba1_cache,
                  init_mamba2_cache)

ATTN_KINDS = ("attn", "global", "local", "dense", "moe", "shared_attn")
SSM_KINDS = ("m1", "m2")


def attn_cfg_for(cfg, kind: str) -> AttnConfig:
    local = kind == "local"
    return AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv=cfg.n_kv,
        head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        window=cfg.window if local else 0,
        softcap=cfg.attn_softcap,
        rope_theta=cfg.rope_theta_local if local else cfg.rope_theta,
        mrope=cfg.mrope,
        causal=cfg.causal,
    )


def moe_cfg_for(cfg) -> MoEConfig:
    return MoEConfig(
        d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
        capacity_factor=cfg.capacity_factor, shared_expert_ff=cfg.shared_expert_ff,
    )


def m1_cfg_for(cfg) -> Mamba1Config:
    return Mamba1Config(
        d_model=cfg.d_model, d_inner=cfg.ssm_d_inner, d_state=cfg.ssm_state,
        dt_rank=cfg.ssm_dt_rank, d_conv=cfg.ssm_conv,
    )


def m2_cfg_for(cfg) -> Mamba2Config:
    return Mamba2Config(
        d_model=cfg.d_model, d_inner=cfg.ssm_d_inner, d_state=cfg.ssm_state,
        head_dim=cfg.ssm_head_dim, d_conv=cfg.ssm_conv,
    )


class Block(nn.Module):
    """One layer.  Norm parameters are named as in the reference
    ({ln1, ln2, ln1p, ln2p}_{scale, bias}); the attention, MLP, MoE and SSM
    parameters sit under `attn.`, `mlp.`, `moe.` and `ssm.`."""

    def __init__(self, kind: str, cfg, device=None):
        super().__init__()
        self.kind = kind
        self.cfg = cfg
        if kind in ATTN_KINDS:
            norms = ["ln1", "ln2"] + (["ln1p", "ln2p"] if cfg.post_norms else [])
            self.attn = Attention(attn_cfg_for(cfg, kind), device=device,
                                  bf16_probs=cfg.attn_bf16_probs)
            if kind == "moe":
                self.moe = MoE(moe_cfg_for(cfg), device=device)
            else:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                               activation=cfg.activation, device=device)
        elif kind == "m1":
            norms = ["ln1"]
            # the reference rounds the scan's inputs only on its fused path
            self.ssm = Mamba1(m1_cfg_for(cfg), device=device,
                              bf16_acts=cfg.ssm_fused_chunks and cfg.ssm_bf16_acts)
        elif kind == "m2":
            norms = ["ln1"]
            self.ssm = Mamba2(m2_cfg_for(cfg), cfg.ssm_chunk, device=device)
        else:
            raise ValueError(f"unknown block kind {kind!r}")
        self.norms = tuple(norms)
        for name in norms:
            self.register_parameter(f"{name}_scale",
                                    nn.Parameter(torch.empty(cfg.d_model, device=device)))
            if cfg.norm != "rms":
                self.register_parameter(f"{name}_bias",
                                        nn.Parameter(torch.empty(cfg.d_model, device=device)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name in self.norms:  # rms: zero gain offset; layer: one and zero
                getattr(self, f"{name}_scale").fill_(0.0 if self.cfg.norm == "rms" else 1.0)
                if self.cfg.norm != "rms":
                    getattr(self, f"{name}_bias").zero_()
        for sub in ("attn", "mlp", "moe", "ssm"):
            if hasattr(self, sub):
                getattr(self, sub).reset_parameters(generator)

    def _norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if self.cfg.norm == "rms":
            return rms_norm(x, getattr(self, f"{name}_scale"))
        return layer_norm(x, getattr(self, f"{name}_scale"), getattr(self, f"{name}_bias"))

    def _residual(self, x: torch.Tensor, mix):
        """The residual layer around `mix`, the attention or the SSM, which
        maps the normed x to (out, cache).  Returns (x, cache, aux): the MoE
        FFN's auxiliary loss, 0 for every other kind."""
        h, cache = mix(self._norm(x, "ln1"))
        if self.kind in SSM_KINDS:
            return x + h, cache, 0.0
        if self.cfg.post_norms:
            h = self._norm(h, "ln1p")
        x = x + h
        aux = 0.0
        if self.kind == "moe":
            f, aux = self.moe(self._norm(x, "ln2"))
        else:
            f = self.mlp(self._norm(x, "ln2"))
        if self.cfg.post_norms:
            f = self._norm(f, "ln2p")
        return x + f, cache, aux

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Returns (x, aux)."""
        if self.kind in SSM_KINDS:
            x, _, aux = self._residual(x, lambda h: (self.ssm(h), None))
        else:
            x, _, aux = self._residual(x, lambda h: (self.attn(h, positions), None))
        return x, aux

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, max_len: int):
        """The forward, and the layer's cache (a KVCache of `max_len` slots,
        or an SSMCache).  Returns (x, cache); the aux is dropped, as the
        reference drops it."""
        if self.kind in SSM_KINDS:
            return self._residual(x, self.ssm.prefill)[:2]
        return self._residual(x, lambda h: self.attn.prefill(h, positions, max_len))[:2]

    def decode(self, x: torch.Tensor, cache, position: torch.Tensor | None):
        """One token, x (B, 1, D), against the layer's cache; `position` (B, 1)
        holds the cache's length (an attention layer's RoPE reads it).
        Returns (x, the new cache)."""
        if self.kind in SSM_KINDS:
            return self._residual(x, lambda h: self.ssm.decode(h, cache))[:2]
        return self._residual(x, lambda h: self.attn.decode(h, cache, position))[:2]


def init_block_cache(kind: str, cfg, batch: int, max_len: int, device=None):
    """An empty cache of a layer of `kind` (port of
    `repro.models.blocks.init_block_cache`)."""
    if kind in ATTN_KINDS:
        return init_cache(attn_cfg_for(cfg, kind), batch, max_len, device=device)
    if kind == "m1":
        return init_mamba1_cache(m1_cfg_for(cfg), batch, device=device)
    if kind == "m2":
        return init_mamba2_cache(m2_cfg_for(cfg), batch, device=device)
    raise ValueError(f"unknown block kind {kind!r}")
