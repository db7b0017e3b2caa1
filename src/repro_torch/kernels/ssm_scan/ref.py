"""Plain PyTorch version of the Mamba-1 selective scan (port of
`repro.kernels.ssm_scan.ref.ssm_scan_ref`, plus its batched form), and of
its gradient as a reverse scan (the reference differentiates its scan with
`jax.value_and_grad`; the port's backward kernel computes the same
gradient).  dt, x, Bc and Cc may come in bf16 (the bf16 form of the
kernel): they are widened to float32 first, and the gradients of the bf16
ones are rounded back to bf16 at the end."""
from __future__ import annotations

import torch


def ssm_scan_batched_ref(dt, x, Bc, Cc, A, h0):
    """dt, x (B, L, D); Bc, Cc (B, L, N); A (D, N); h0 (B, D, N), float32
    (dt, x, Bc, Cc also bf16, widened here).  Returns (y (B, L, D), h_fin
    (B, D, N)) float32 with
      h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t ;  y_t = h_t . C_t"""
    dt, x, Bc, Cc = (t.to(torch.float32) for t in (dt, x, Bc, Cc))
    h = h0.to(torch.float32)
    ys = []
    for t in range(dt.shape[1]):
        a = torch.exp(dt[:, t, :, None] * A)  # (B, D, N)
        b = (dt[:, t] * x[:, t])[..., None] * Bc[:, t, None, :]
        h = a * h + b
        ys.append((h * Cc[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) if ys else dt.new_zeros(dt.shape)
    return y, h


def ssm_scan_ref(dt, x, Bc, Cc, A, h0):
    """One sequence: dt, x (L, D); Bc, Cc (L, N); A, h0 (D, N).
    Returns (y (L, D), h_fin (D, N))."""
    y, h = ssm_scan_batched_ref(dt[None], x[None], Bc[None], Cc[None], A, h0[None])
    return y[0], h[0]


def ssm_scan_bwd_ref(dt, x, Bc, Cc, A, h0, dy, dh_fin=None):
    """The gradient of `ssm_scan_batched_ref` for the output gradients dy
    (B, L, D) and dh_fin (B, D, N; None is zero), step by step: with g_t
    the gradient of h_t,
      g_{L-1} = dh_fin + dy_{L-1} C_{L-1},  g_t = a_{t+1} g_{t+1} + dy_t C_t
      dC_t = sum_d dy_t h_t,  dB_t = sum_d g_t dt_t x_t,
      dx_t = dt_t sum_n g_t B_t,  ddt_t = sum_n g_t (A a_t h_{t-1} + x_t B_t),
      dA = sum_{b,t} g_t dt_t a_t h_{t-1},  dh0 = a_0 g_0.
    Returns (ddt, dx, dB, dC, dA, dh0), each of ddt, dx, dB and dC in its
    input's type (the float32 gradient rounded once)."""
    types = [t.dtype for t in (dt, x, Bc, Cc)]
    dt, x, Bc, Cc = (t.to(torch.float32) for t in (dt, x, Bc, Cc))
    L = dt.shape[1]
    hs = [h0.to(torch.float32)]  # hs[t + 1] = h_t
    for t in range(L):
        a = torch.exp(dt[:, t, :, None] * A)
        hs.append(a * hs[-1] + (dt[:, t] * x[:, t])[..., None] * Bc[:, t, None, :])
    g_next = torch.zeros_like(hs[0]) if dh_fin is None else dh_fin  # a_{t+1} g_{t+1}
    ddt, dx = torch.zeros_like(dt), torch.zeros_like(x)
    dB, dC, dA = torch.zeros_like(Bc), torch.zeros_like(Cc), torch.zeros_like(A)
    for t in reversed(range(L)):
        a = torch.exp(dt[:, t, :, None] * A)
        g = g_next + dy[:, t, :, None] * Cc[:, t, None, :]  # (B, D, N)
        u = a * hs[t]
        dC[:, t] = (dy[:, t, :, None] * hs[t + 1]).sum(1)
        dB[:, t] = (g * (dt[:, t] * x[:, t])[..., None]).sum(1)
        dx[:, t] = dt[:, t] * (g * Bc[:, t, None, :]).sum(-1)
        ddt[:, t] = (g * (A * u + x[:, t, :, None] * Bc[:, t, None, :])).sum(-1)
        dA += (g * dt[:, t, :, None] * u).sum(0)
        g_next = a * g
    ddt, dx, dB, dC = (g.to(ty) for g, ty in zip((ddt, dx, dB, dC), types))
    return ddt, dx, dB, dC, dA, g_next
