"""Plain PyTorch version of the Mamba-1 selective scan (port of
`repro.kernels.ssm_scan.ref.ssm_scan_ref`, plus its batched form)."""
from __future__ import annotations

import torch


def ssm_scan_batched_ref(dt, x, Bc, Cc, A, h0):
    """dt, x (B, L, D); Bc, Cc (B, L, N); A (D, N); h0 (B, D, N), float32.
    Returns (y (B, L, D), h_fin (B, D, N)) with
      h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t ;  y_t = h_t . C_t"""
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
