"""Dense feed-forward blocks (port of `repro.models.ffn`): SwiGLU / GeGLU /
GELU, with the reference's parameter names w_gate, w_up, w_down."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import dense_init_, matmul


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    # the reference's jax.nn.gelu(approximate=True) is the tanh form
    return F.gelu(x, approximate="tanh") if activation == "gelu" else F.silu(x)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, gated: bool = True,
                 activation: str = "silu", device=None):
        super().__init__()
        self.activation = activation
        self.w_up = nn.Parameter(torch.empty((d_model, d_ff), device=device))
        self.w_down = nn.Parameter(torch.empty((d_ff, d_model), device=device))
        self.w_gate = (nn.Parameter(torch.empty((d_model, d_ff), device=device))
                       if gated else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            if w is not None:
                dense_init_(w, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, D) -> (B, S, D)."""
        h_up = matmul(x, self.w_up)
        if self.w_gate is not None:
            h = _act(matmul(x, self.w_gate), self.activation) * h_up
        else:
            h = _act(h_up, self.activation)
        return matmul(h, self.w_down)
