"""Decoder LM forward (port of `repro.models.lm`: the embedding, the layer
stack and the final norm; no unembedding, loss, prefill or decode yet).

The reference scans the repeated layer pattern over stacked parameters; the
port holds the layers as a flat `ModuleList` in the order they run: repeat
r, pattern slot j is layer r * len(pattern) + j, then the tail blocks."""
from __future__ import annotations

import torch
from torch import nn

from .blocks import Block
from .common import layer_norm, rms_norm


def layer_kinds(cfg) -> list[str]:
    return list(cfg.pattern) * cfg.repeats + list(cfg.tail)


class LM(nn.Module):
    """Parameters: `embedding` (vocab_padded, D), `layers`, and the final norm
    `fn_scale` (+ `fn_bias` for layer norms).  Built with uninitialised
    storage on `device`; `reset_parameters` fills it (see `api.init_model`)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.enc_dec or cfg.vlm:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder and VLM models are not ported yet (ROADMAP A11)")
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty((cfg.vocab_padded, cfg.d_model),
                                                  device=device))
        self.layers = nn.ModuleList(Block(kind, cfg, device=device) for kind in layer_kinds(cfg))
        self.fn_scale = nn.Parameter(torch.empty(cfg.d_model, device=device))
        self.fn_bias = (None if cfg.norm == "rms"
                        else nn.Parameter(torch.empty(cfg.d_model, device=device)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions: embedding normal * 0.02, dense
        weights normal / sqrt(fan_in), norms zero (rms) or one / zero
        (layer), the SSM's own constants."""
        with torch.no_grad():
            self.embedding.normal_(0.0, 0.02, generator=generator)
            self.fn_scale.fill_(0.0 if self.cfg.norm == "rms" else 1.0)
            if self.fn_bias is not None:
                self.fn_bias.zero_()
        for layer in self.layers:
            layer.reset_parameters(generator)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embedding[tokens]
        if self.cfg.embed_scale:  # gemma: x * sqrt(d_model), in the activation dtype
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
        return x

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) int -> final hidden states (B, S, D), positions
        0 .. S - 1."""
        x = self.embed_tokens(tokens)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        for layer in self.layers:
            x = layer(x, positions)
        if self.fn_bias is None:
            return rms_norm(x, self.fn_scale)
        return layer_norm(x, self.fn_scale, self.fn_bias)
