"""Layer blocks (port of `repro.models.blocks`, full-sequence forward): the
kinds attn / global / local / dense (attention + MLP) and m1 (Mamba-1).
The reference's other kinds are not ported yet and raise."""
from __future__ import annotations

import torch
from torch import nn

from .attention import Attention, AttnConfig
from .common import layer_norm, rms_norm
from .ffn import MLP
from .ssm import Mamba1, Mamba1Config

ATTN_KINDS = ("attn", "global", "local", "dense")
# block kinds of the reference that the port does not run yet
UNPORTED = {
    "moe": "the MoE FFN (ROADMAP A11)",
    "m2": "Mamba-2 (ROADMAP A11)",
    "shared_attn": "zamba's shared attention block (ROADMAP A11)",
}


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


def m1_cfg_for(cfg) -> Mamba1Config:
    return Mamba1Config(
        d_model=cfg.d_model, d_inner=cfg.ssm_d_inner, d_state=cfg.ssm_state,
        dt_rank=cfg.ssm_dt_rank, d_conv=cfg.ssm_conv,
    )


class Block(nn.Module):
    """One layer.  Norm parameters are named as in the reference
    ({ln1, ln2, ln1p, ln2p}_{scale, bias}); the attention, MLP and SSM
    parameters sit under `attn.`, `mlp.` and `ssm.`."""

    def __init__(self, kind: str, cfg, device=None):
        super().__init__()
        if kind in UNPORTED:
            raise NotImplementedError(f"block kind {kind!r}: {UNPORTED[kind]} is not ported yet")
        if cfg.attn_bf16_probs or cfg.ssm_bf16_acts:
            raise NotImplementedError("the bf16 activation knobs are not ported (ROADMAP A11)")
        self.kind = kind
        self.cfg = cfg
        if kind in ATTN_KINDS:
            norms = ["ln1", "ln2"] + (["ln1p", "ln2p"] if cfg.post_norms else [])
            self.attn = Attention(attn_cfg_for(cfg, kind), device=device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                           activation=cfg.activation, device=device)
        elif kind == "m1":
            norms = ["ln1"]
            self.ssm = Mamba1(m1_cfg_for(cfg), device=device)
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
        for sub in ("attn", "mlp", "ssm"):
            if hasattr(self, sub):
                getattr(self, sub).reset_parameters(generator)

    def _norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if self.cfg.norm == "rms":
            return rms_norm(x, getattr(self, f"{name}_scale"))
        return layer_norm(x, getattr(self, f"{name}_scale"), getattr(self, f"{name}_bias"))

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        if self.kind == "m1":
            return x + self.ssm(self._norm(x, "ln1"))
        a = self.attn(self._norm(x, "ln1"), positions)
        if self.cfg.post_norms:
            a = self._norm(a, "ln1p")
        x = x + a
        f = self.mlp(self._norm(x, "ln2"))
        if self.cfg.post_norms:
            f = self._norm(f, "ln2p")
        return x + f
