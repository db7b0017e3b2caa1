"""State-space blocks (port of `repro.models.ssm`: Mamba-1, its forward,
prefill and one-token decode with the conv tail and scan state cached).

The input projection, the depthwise causal conv, the dt/B/C projections,
the `+ x D` skip and the `silu(z)` gate are plain torch; the selective scan
runs through the `ssm_scan` wrapper -- the hand-written kernel on CUDA
tensors, its plain version on CPU tensors.  It computes what the
reference's `_mamba1_fused` and `_mamba1_scan` paths both compute, on the
(B, L, d_inner) layout the projections produce; prefill and decode carry
the state through it as h0 and h_fin, decode as one launch at L = 1.
Mamba-2 is not ported yet."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssm_scan import ops as scan_ops
from .common import dense_init_


class Mamba1Config(NamedTuple):
    d_model: int
    d_inner: int
    d_state: int
    dt_rank: int
    d_conv: int = 4


class SSMCache(NamedTuple):
    """A Mamba-1 layer's decode state: the conv's last k - 1 inputs
    (B, k - 1, d_inner), the scan state (B, d_inner, N) float32, and the
    tokens seen (a Python int)."""
    conv_tail: torch.Tensor
    state: torch.Tensor
    length: int


def init_mamba1_cache(cfg: Mamba1Config, batch: int, device=None) -> SSMCache:
    return SSMCache(
        torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=torch.float32, device=device), 0)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tail: torch.Tensor):
    """Depthwise causal conv over time.  x: (B, L, C), w: (k, C), b: (C,);
    `tail` (B, k - 1, C) the inputs before x (zeros: no history).  Sums the
    taps in the reference's order.  Returns (out (B, L, C), the new tail:
    the last k - 1 inputs, a copy, so that a cache does not hold the whole
    padded input)."""
    k, L = w.shape[0], x.shape[1]
    xp = torch.cat([tail, x], dim=1)  # (B, L + k - 1, C)
    out = xp[:, 0:L, :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + L, :] * w[i]
    return out + b, xp[:, L:, :].contiguous()


class Mamba1(nn.Module):
    """Parameters as the reference names them: in_proj, conv_w, conv_b,
    x_proj, dt_proj, dt_bias, A_log, D, out_proj."""

    def __init__(self, cfg: Mamba1Config, device=None):
        super().__init__()
        self.cfg = cfg
        D, Di, N, R = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank
        shapes = {"in_proj": (D, 2 * Di), "conv_w": (cfg.d_conv, Di), "conv_b": (Di,),
                  "x_proj": (Di, R + 2 * N), "dt_proj": (R, Di), "dt_bias": (Di,),
                  "A_log": (Di, N), "D": (Di,), "out_proj": (Di, D)}
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape, device=device)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj"):
            dense_init_(getattr(self, name), generator)
        with torch.no_grad():
            self.conv_b.zero_()
            self.dt_bias.zero_()
            n = torch.arange(1, self.cfg.d_state + 1, dtype=torch.float32,
                             device=self.A_log.device)
            self.A_log.copy_(torch.log(n).expand_as(self.A_log))
            self.D.fill_(1.0)

    def decode(self, x: torch.Tensor, cache: SSMCache):
        """x (B, L, D) after `cache` -> (out (B, L, D), the cache after x).
        A decode step is L = 1: one `ssm_scan` launch from the cached
        state."""
        cfg = self.cfg
        Di, N, R = cfg.d_inner, cfg.d_state, cfg.dt_rank
        x1, z = torch.split(x @ self.in_proj, [Di, Di], dim=-1)
        x1, tail = causal_conv(x1, self.conv_w, self.conv_b, cache.conv_tail)
        x1 = F.silu(x1)
        dt_r, Bc, Cc = torch.split(x1 @ self.x_proj, [R, N, N], dim=-1)
        dt = F.softplus(dt_r @ self.dt_proj + self.dt_bias)  # (B, L, Di)
        A = -torch.exp(self.A_log.to(torch.float32))  # (Di, N)
        y, h = scan_ops.ssm_scan(dt, x1, Bc.contiguous(), Cc.contiguous(), A, cache.state)
        y = (y + x1 * self.D).to(x.dtype)
        y = y * F.silu(z)
        return y @ self.out_proj, SSMCache(tail, h, cache.length + x.shape[1])

    def prefill(self, x: torch.Tensor):
        """The forward over a prompt and the cache after it."""
        return self.decode(x, init_mamba1_cache(self.cfg, x.shape[0], device=x.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, L, D) -> (B, L, D)."""
        return self.prefill(x)[0]
