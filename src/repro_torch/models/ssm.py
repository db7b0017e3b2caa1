"""State-space blocks (port of `repro.models.ssm`: Mamba-1 and Mamba-2,
each with its forward, prefill and one-token decode with the conv tail and
state cached).

The input projection, the depthwise causal conv, the dt/B/C projections,
the `+ x D` skip and the `silu(z)` gate are plain torch; the selective scan
runs through the `ssm_scan` wrapper -- the hand-written kernel on CUDA
tensors, its plain version on CPU tensors.  It computes what the
reference's `_mamba1_fused` and `_mamba1_scan` paths both compute, on the
(B, L, d_inner) layout the projections produce; prefill and decode carry
the state through it as h0 and h_fin, decode as one launch at L = 1.
With `bf16_acts` (the config's ssm_fused_chunks and ssm_bf16_acts), the
forward and prefill hand the scan dt, x, B and C rounded to bf16 (the
kernel's bf16 form), as the reference's fused path casts them; the skip
term keeps the unrounded x, and a decode step scans in float32, as the
reference's unfused `mamba1_decode` does.

Mamba-2 (SSD) is plain torch throughout, as the reference computes it in
jnp outside any Pallas kernel: the chunked form -- the intra-chunk term as
masked matmuls over `_segsum`'s decays, the chunk-final states, a
recurrence over the chunks, the inter-chunk term -- in the reference's
order of operations.  Decode is the same function at L = 1 (one chunk of
one step)."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssm_scan import ops as scan_ops
from .common import dense_init_, matmul, rms_norm


class Mamba1Config(NamedTuple):
    d_model: int
    d_inner: int
    d_state: int
    dt_rank: int
    d_conv: int = 4


class Mamba2Config(NamedTuple):
    d_model: int
    d_inner: int
    d_state: int
    head_dim: int = 64
    d_conv: int = 4

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


class SSMCache(NamedTuple):
    """An SSM layer's decode state: the conv's last k - 1 inputs
    (B, k - 1, C), the state in float32, and the tokens seen (a Python
    int).  Mamba-1: C = d_inner, state (B, d_inner, N); Mamba-2: C =
    d_inner + 2 N (x, B and C go through the conv), state (B, H, N,
    head_dim)."""
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
    x_proj, dt_proj, dt_bias, A_log, D, out_proj.  `bf16_acts`: the forward
    and prefill scan bf16 dt, x, B and C."""

    def __init__(self, cfg: Mamba1Config, device=None, bf16_acts: bool = False):
        super().__init__()
        self.cfg = cfg
        self.bf16_acts = bf16_acts
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

    def decode(self, x: torch.Tensor, cache: SSMCache | None):
        """x (B, L, D) after `cache` -> (out (B, L, D), the cache after x).
        A decode step is L = 1: one `ssm_scan` launch from the cached
        state.  `cache` None is no history, as the reference's forward: a
        zero conv tail in the activations' dtype, a zero float32 state.
        Mixed dtypes (a bf16 training forward) compute what jnp computes:
        the products promote, and dt, x, B and C reach the float32 scan as
        float32, as the reference's fused path casts them; with `bf16_acts`
        and no cache (the forward and prefill) they reach the scan's bf16
        form as bf16."""
        cfg = self.cfg
        Di, N, R = cfg.d_inner, cfg.d_state, cfg.dt_rank
        f32 = torch.float32
        x1, z = torch.split(matmul(x, self.in_proj), [Di, Di], dim=-1)
        act = torch.bfloat16 if self.bf16_acts and cache is None else f32
        if cache is None:
            cache = SSMCache(x1.new_zeros((x.shape[0], cfg.d_conv - 1, Di)),
                             torch.zeros((x.shape[0], Di, N), dtype=f32, device=x.device), 0)
        x1, tail = causal_conv(x1, self.conv_w, self.conv_b, cache.conv_tail)
        x1 = F.silu(x1)
        dt_r, Bc, Cc = torch.split(matmul(x1, self.x_proj), [R, N, N], dim=-1)
        dt = F.softplus(matmul(dt_r, self.dt_proj) + self.dt_bias)  # (B, L, Di)
        A = -torch.exp(self.A_log.to(f32))  # (Di, N)
        y, h = scan_ops.ssm_scan(dt.to(act), x1.to(act), Bc.to(act).contiguous(),
                                 Cc.to(act).contiguous(), A, cache.state)
        y = (y + x1.to(f32) * self.D).to(x.dtype)
        y = y * F.silu(z)
        return matmul(y, self.out_proj), SSMCache(tail, h, cache.length + x.shape[1])

    def prefill(self, x: torch.Tensor):
        """The forward over a prompt and the cache after it."""
        return self.decode(x, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, L, D) -> (B, L, D)."""
        return self.prefill(x)[0]


def init_mamba2_cache(cfg: Mamba2Config, batch: int, device=None) -> SSMCache:
    return SSMCache(
        torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner + 2 * cfg.d_state), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim), dtype=torch.float32,
                    device=device), 0)


def segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA (..., c) -> (..., c, c): seg[t, j] = sum_{i = j+1 .. t} dA_i for
    j <= t, -inf above the diagonal.  As the reference: a difference of
    cumulative sums, cs[t] - cs[j]."""
    c = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((c, c), dtype=torch.bool, device=dA.device).tril()
    return seg.masked_fill(~mask, -torch.inf)


class Mamba2(nn.Module):
    """Parameters as the reference names them: in_proj (D, 2 Di + 2 N + H),
    conv_w (k, Di + 2 N), conv_b, dt_bias_h, A_log_h, D_h (H,), norm_scale
    (Di,), out_proj (Di, D).  `chunk` is the SSD's chunk length over a
    sequence (the config's `ssm_chunk`)."""

    def __init__(self, cfg: Mamba2Config, chunk: int, device=None):
        super().__init__()
        self.cfg, self.chunk = cfg, chunk
        D, Di, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
        shapes = {"in_proj": (D, 2 * Di + 2 * N + H), "conv_w": (cfg.d_conv, Di + 2 * N),
                  "conv_b": (Di + 2 * N,), "dt_bias_h": (H,), "A_log_h": (H,), "D_h": (H,),
                  "norm_scale": (Di,), "out_proj": (Di, D)}
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape, device=device)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("in_proj", "conv_w", "out_proj"):
            dense_init_(getattr(self, name), generator)
        with torch.no_grad():
            for name in ("conv_b", "dt_bias_h", "A_log_h", "norm_scale"):
                getattr(self, name).zero_()
            self.D_h.fill_(1.0)

    def decode(self, x: torch.Tensor, cache: SSMCache):
        """x (B, L, D) after `cache` -> (out (B, L, D), the cache after x),
        in chunks of min(chunk, L): a decode step (L = 1) is one chunk of
        one step from the cached state."""
        cfg = self.cfg
        B, L, _ = x.shape
        Di, N, H, hd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
        z, xbc, dt = torch.split(x @ self.in_proj, [Di, Di + 2 * N, H], dim=-1)
        xbc, tail = causal_conv(xbc, self.conv_w, self.conv_b, cache.conv_tail)
        xs, Bc, Cc = torch.split(F.silu(xbc), [Di, N, N], dim=-1)
        dt = F.softplus(dt.to(torch.float32) + self.dt_bias_h)  # (B, L, H)
        A = -torch.exp(self.A_log_h.to(torch.float32))  # (H,)
        dA = dt * A

        chunk = min(self.chunk, L)
        nc = -(-L // chunk)
        pad = nc * chunk - L
        if pad:
            xs, Bc, Cc, dA, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xs, Bc, Cc, dA, dt))
        Xc = xs.reshape(B, nc, chunk, H, hd).to(torch.float32)
        Bm = Bc.reshape(B, nc, chunk, N).to(torch.float32)
        Cm = Cc.reshape(B, nc, chunk, N).to(torch.float32)
        dAc = dA.reshape(B, nc, chunk, H)
        dtc = dt.reshape(B, nc, chunk, H)

        # intra-chunk: M[t, j] = (C_t . B_j) exp(seg[t, j]) dt_j
        seg = segsum(dAc.transpose(2, 3))  # (B, k, H, c, c)
        CB = torch.einsum("bktn,bkjn->bktj", Cm, Bm)
        M = CB[:, :, None] * torch.exp(seg) * dtc.transpose(2, 3)[:, :, :, None, :]
        Y_intra = torch.einsum("bkhtj,bkjhd->bkthd", M, Xc)

        # chunk-final states: S_k = sum_j exp(cum_last - cum_j) dt_j B_j (x) X_j
        cum = torch.cumsum(dAc, dim=2)  # (B, k, c, H)
        decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
        Sk = torch.einsum("bkcn,bkchd->bkhnd", Bm, (decay_to_end * dtc)[..., None] * Xc)

        # the state before each chunk, through the recurrence over chunks
        chunk_decay = torch.exp(torch.sum(dAc, dim=2))  # (B, k, H)
        S, S_prevs = cache.state, []
        for k in range(nc):
            S_prevs.append(S)
            S = S * chunk_decay[:, k, :, None, None] + Sk[:, k]
        S_prev = torch.stack(S_prevs, dim=1)  # (B, k, H, N, hd)
        Y_inter = torch.einsum("bkcn,bkhnd->bkchd", Cm, S_prev) * torch.exp(cum)[..., None]

        y = (Y_intra + Y_inter).reshape(B, nc * chunk, H, hd)[:, :L]
        y = y + Xc.reshape(B, nc * chunk, H, hd)[:, :L] * self.D_h[:, None]
        y = y.reshape(B, L, Di).to(x.dtype) * F.silu(z)
        y = rms_norm(y, self.norm_scale)
        return y @ self.out_proj, SSMCache(tail, S, cache.length + L)

    def prefill(self, x: torch.Tensor):
        """The forward over a prompt and the cache after it."""
        return self.decode(x, init_mamba2_cache(self.cfg, x.shape[0], device=x.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, L, D) -> (B, L, D)."""
        return self.prefill(x)[0]
