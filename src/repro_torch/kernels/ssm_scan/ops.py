"""Public wrapper for the batched selective scan (port of
`repro.kernels.ssm_scan.ops.ssm_scan`): on CUDA tensors one launch of the
hand-written kernel (`csrc/ssm_scan.cu`, `ssm_scan_launch`) scans the whole
sequence, its state in registers for any L; on CPU tensors the plain version
(`ref.ssm_scan_batched_ref`) runs in chunks of at most `seq_chunk` steps,
carrying h from one chunk to the next, as the reference's wrapper does."""
from __future__ import annotations

import torch

from .. import common
from .ref import ssm_scan_batched_ref

# the kernel keeps a channel's state in registers: N <= 16 (every Mamba-1
# configuration of the repository)
MAX_N = 16
SEQ_CHUNK = 2048  # the reference wrapper's default


def ssm_scan(dt, x, Bc, Cc, A, h0, *, seq_chunk: int = SEQ_CHUNK):
    """dt, x (B, L, D); Bc, Cc (B, L, N); A (D, N); h0 (B, D, N), float32.
    Returns (y (B, L, D), h_fin (B, D, N)).  `seq_chunk` splits the CPU
    path only; the card scans [0, L) in one launch whatever it is."""
    if seq_chunk < 1:
        raise ValueError(f"ssm_scan: seq_chunk must be >= 1, got {seq_chunk}")
    B, L, D = dt.shape
    if dt.device.type == "cpu":
        ys, h = [], h0
        for lo in range(0, L, seq_chunk):
            hi = min(L, lo + seq_chunk)
            y_c, h = ssm_scan_batched_ref(dt[:, lo:hi], x[:, lo:hi], Bc[:, lo:hi],
                                          Cc[:, lo:hi], A, h)
            ys.append(y_c)
        return (torch.cat(ys, dim=1) if ys else dt.new_zeros(dt.shape)), h
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {dt.device}")
    common.forward_only("ssm_scan", dt, x, Bc, Cc, A, h0,
                        todo="ROADMAP A11 step 6: the scan's backward kernel")
    N = Bc.shape[2]
    dev = dt.device
    for name, t, shape in (("dt", dt, (B, L, D)), ("x", x, (B, L, D)), ("Bc", Bc, (B, L, N)),
                           ("Cc", Cc, (B, L, N)), ("A", A, (D, N)), ("h0", h0, (B, D, N))):
        common.check(name, t, device=dev, dtype=torch.float32, shape=shape)
    if not 1 <= N <= MAX_N:
        raise ValueError(f"ssm_scan: the kernel takes 1 <= N <= {MAX_N}, got N={N}")
    if B == 0 or D == 0 or L == 0:  # nothing to scan: no kernel is launched
        return dt.new_zeros((B, L, D)), h0
    y = torch.empty((B, L, D), dtype=torch.float32, device=dev)
    h = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    common.launch("ssm_scan", "ssm_scan_launch", dt.data_ptr(), x.data_ptr(), Bc.data_ptr(),
                  Cc.data_ptr(), A.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(),
                  B, L, D, N)
    return y, h
