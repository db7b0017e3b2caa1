"""Public wrapper for the batched selective scan (port of
`repro.kernels.ssm_scan.ops.ssm_scan`): on CUDA tensors one launch of the
hand-written kernel (`csrc/ssm_scan.cu`, `ssm_scan_launch`) scans the whole
sequence, its state in registers for any L; on CPU tensors the plain version
(`ref.ssm_scan_batched_ref`, which torch differentiates) runs in chunks of
at most `seq_chunk` steps, carrying h from one chunk to the next, as the
reference's wrapper does.  Both take dt, x, Bc and Cc all float32, or all
bf16 (the model's `ssm_bf16_acts`: the bf16 form of the kernel,
`ssm_scan_bf16_launch`, widens them to float32 as it reads them; the plain
version widens them first), with A and h0 float32, and refuse any other mix
with the same check.

Where autograd records a call on CUDA tensors, it goes through `SSMScan`:
the forward launch also writes the state entering each 32-step tile
(`h_ckpt`), and the backward kernel (`csrc/ssm_scan_bwd.cu`,
`ssm_scan_bwd_launch`) recomputes each tile's states from it and walks the
tile backwards.  Without grad the forward writes no checkpoint and is the
launch it always was.  In the bf16 form `SSMScan` saves the bf16 inputs as
they are and returns their gradients in bf16 (`ssm_scan_bwd_bf16_launch`:
the float32 gradients rounded once, to nearest even).  Each form counts its
own launches (`ssm_scan` / `ssm_scan_bwd`, `ssm_scan_bf16` /
`ssm_scan_bwd_bf16`).

A dry run (`launch.dryrun`) calls the wrappers on meta (or fake) tensors: they
allocate the outputs a launch would write (y, h_fin, and the checkpoints
autograd saves) and record the launch with the dry run's counter
(`common.dry_launch`) instead of launching; LAUNCHES does not move.  On
DTensor inputs, which only a dry run makes, the wrapper runs on the local
shards, each input placed by dt's: the batch and the channels may be
sharded, the sequence not (the scan carries its state along it)."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .. import common
from .ref import ssm_scan_batched_ref

# the kernel keeps a channel's state in registers: N <= 16 (every Mamba-1
# configuration of the repository)
MAX_N = 16
SEQ_CHUNK = 2048  # the reference wrapper's default
TILE = 32  # steps a tile of both kernels: the forward checkpoints h once a tile
BWD_CHANNELS = 32  # channels a block of the backward kernel (its dB / dC partials)


def _check(dt, x, Bc, Cc, A, h0) -> tuple[int, int, int, int]:
    """(B, L, D, N) of valid inputs: dt, x, Bc and Cc all float32 or all
    bf16, A and h0 float32, contiguous, on dt's device, shaped as `ssm_scan`
    takes them; raises otherwise (a TypeError naming the input of the wrong
    type: unless all four are bf16, float32 is asked of each)."""
    B, L, D = dt.shape
    N = Bc.shape[2]
    bf16 = all(t.dtype == torch.bfloat16 for t in (dt, x, Bc, Cc))
    act = torch.bfloat16 if bf16 else torch.float32
    for name, t, shape, dtype in (
            ("dt", dt, (B, L, D), act), ("x", x, (B, L, D), act), ("Bc", Bc, (B, L, N), act),
            ("Cc", Cc, (B, L, N), act), ("A", A, (D, N), torch.float32),
            ("h0", h0, (B, D, N), torch.float32)):
        common.check(name, t, device=dt.device, dtype=dtype, shape=shape)
    return B, L, D, N


# each input type's form: (forward counter, entry point), (backward counter,
# entry point)
FORMS = {torch.float32: (("ssm_scan", "ssm_scan_launch"),
                         ("ssm_scan_bwd", "ssm_scan_bwd_launch")),
         torch.bfloat16: (("ssm_scan_bf16", "ssm_scan_bf16_launch"),
                          ("ssm_scan_bwd_bf16", "ssm_scan_bwd_bf16_launch"))}


def _forward(dt, x, Bc, Cc, A, h0, *, checkpoints: bool):
    """One forward launch on CUDA tensors: (y, h_fin, the state entering
    each tile (B, ceil(L / TILE), D, N) or None)."""
    B, L, D, N = _check(dt, x, Bc, Cc, A, h0)
    if not 1 <= N <= MAX_N:
        raise ValueError(f"ssm_scan: the kernel takes 1 <= N <= {MAX_N}, got N={N}")
    dev = dt.device
    ckpt = (torch.empty((B, -(-L // TILE), D, N), dtype=torch.float32, device=dev)
            if checkpoints else None)
    if B == 0 or D == 0 or L == 0:  # nothing to scan: no kernel is launched
        # under SSMScan a copy: an autograd Function's output is not its input
        y = torch.zeros((B, L, D), dtype=torch.float32, device=dev)
        return y, h0.clone() if checkpoints else h0, ckpt
    y = torch.empty((B, L, D), dtype=torch.float32, device=dev)
    h = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    if common.is_dry(dt, x, Bc, Cc, A, h0):
        common.dry_launch(FORMS[dt.dtype][0][0], B=B, L=L, D=D, N=N,
                           ckpt_tiles=0 if ckpt is None else ckpt.shape[1])
        return y, h, ckpt
    common.launch(*FORMS[dt.dtype][0], dt.data_ptr(), x.data_ptr(), Bc.data_ptr(),
                  Cc.data_ptr(), A.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(),
                  None if ckpt is None else ckpt.data_ptr(), B, L, D, N)
    return y, h, ckpt


def bwd_blocks(D: int) -> int:
    """The backward kernel's channel blocks: each writes its own dB and dC
    partials, which the reduce sums in block order."""
    return -(-D // BWD_CHANNELS)


def ssm_scan_bwd(dt, x, Bc, Cc, A, h0, ckpt, dy, dh_fin=None, *, want_dh0: bool = True):
    """The backward kernel on CUDA tensors: (ddt, dx, dB, dC, dA, dh0) of
    the scan whose forward wrote the checkpoints `ckpt` (`_forward(...,
    checkpoints=True)`), for the output gradients dy (B, L, D) and dh_fin
    (B, D, N; None is zero).  dh0 is None when `want_dh0` is false.  One
    counted launch (the walk, then the reduce of the partials over the
    channel blocks and of dA over the batch rows).  In the bf16 form (dt,
    x, Bc, Cc bf16) ddt, dx, dB and dC come back bf16, the float32
    gradients rounded once; dA and dh0 are float32.  No plain fallback:
    `ref.ssm_scan_bwd_ref` is its plain version, for the tests and
    chip_smoke.py."""
    dry = common.is_dry(dt, x, Bc, Cc, A, h0)
    if dt.device.type != "cuda" and not dry:
        raise ValueError(f"ssm_scan_bwd: the backward kernel needs CUDA tensors, got {dt.device}")
    B, L, D, N = _check(dt, x, Bc, Cc, A, h0)
    if not 1 <= N <= MAX_N:
        raise ValueError(f"ssm_scan_bwd: the kernel takes 1 <= N <= {MAX_N}, got N={N}")
    dev = dt.device
    common.check("ckpt", ckpt, device=dev, dtype=torch.float32, shape=(B, -(-L // TILE), D, N))
    common.check("dy", dy, device=dev, dtype=torch.float32, shape=(B, L, D))
    if dh_fin is not None:
        common.check("dh_fin", dh_fin, device=dev, dtype=torch.float32, shape=(B, D, N))
    if B == 0 or D == 0 or L == 0:  # nothing to walk: no kernel is launched
        dh0 = (torch.zeros_like(h0) if dh_fin is None else dh_fin.clone()) if want_dh0 else None
        return (torch.zeros_like(dt), torch.zeros_like(x), torch.zeros_like(Bc),
                torch.zeros_like(Cc), torch.zeros_like(A), dh0)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dB, dC, dA = torch.empty_like(Bc), torch.empty_like(Cc), torch.empty_like(A)
    dh0 = torch.empty_like(h0) if want_dh0 else None
    if dry:  # the scratch (partials) lives within the call: not modelled
        common.dry_launch(FORMS[dt.dtype][1][0], B=B, L=L, D=D, N=N)
        return ddt, dx, dB, dC, dA, dh0
    # the dB and dC partials of each channel block, then dA of each batch row
    scratch = torch.empty(2 * B * bwd_blocks(D) * L * N + B * D * N, dtype=torch.float32,
                          device=dev)
    common.launch(*FORMS[dt.dtype][1], dt.data_ptr(), x.data_ptr(),
                  Bc.data_ptr(), Cc.data_ptr(), A.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
                  None if dh_fin is None else dh_fin.data_ptr(), ddt.data_ptr(), dx.data_ptr(),
                  dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
                  None if dh0 is None else dh0.data_ptr(), scratch.data_ptr(), B, L, D, N)
    return ddt, dx, dB, dC, dA, dh0


class SSMScan(torch.autograd.Function):
    """The forward kernel with the tiles' checkpoints, and the backward
    kernel as its gradient (once differentiable: the backward is no
    autograd graph).  An output whose gradient does not reach the loss
    (h_fin in training) comes to the backward as None.  The inputs are
    saved in their own types (bf16 ones as bf16), and each gradient comes
    back in its input's type."""

    @staticmethod
    def forward(ctx, dt, x, Bc, Cc, A, h0):
        y, h, ckpt = _forward(dt, x, Bc, Cc, A, h0, checkpoints=True)
        ctx.save_for_backward(dt, x, Bc, Cc, A, h0, ckpt)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh_fin):
        dt, x, Bc, Cc, A, h0, ckpt = ctx.saved_tensors
        dy = (torch.zeros(dt.shape, dtype=torch.float32, device=dt.device) if dy is None
              else dy.contiguous())
        dh_fin = None if dh_fin is None else dh_fin.contiguous()
        return ssm_scan_bwd(dt, x, Bc, Cc, A, h0, ckpt, dy, dh_fin,
                            want_dh0=ctx.needs_input_grad[5])


def ssm_scan(dt, x, Bc, Cc, A, h0, *, seq_chunk: int = SEQ_CHUNK):
    """dt, x (B, L, D); Bc, Cc (B, L, N); A (D, N); h0 (B, D, N): dt, x, Bc
    and Cc all float32 or all bf16 (the bf16 form), A and h0 float32.
    Returns (y (B, L, D), h_fin (B, D, N)) float32.  `seq_chunk` splits the
    CPU path only; the card scans [0, L) in one launch whatever it is,
    through `SSMScan` where autograd records the call.  Meta (or fake)
    tensors, a dry run's, take the kernel path without launching; DTensors
    run on their local shards (`_on_shards`)."""
    from torch.distributed.tensor import DTensor

    if seq_chunk < 1:
        raise ValueError(f"ssm_scan: seq_chunk must be >= 1, got {seq_chunk}")
    if isinstance(dt, DTensor):
        return _on_shards(dt, x, Bc, Cc, A, h0)
    B, L, D, N = _check(dt, x, Bc, Cc, A, h0)
    dry = common.is_dry(dt, x, Bc, Cc, A, h0)  # a dry run: the kernel's path
    if dt.device.type == "cpu" and not dry:
        ys, h = [], h0
        for lo in range(0, L, seq_chunk):
            hi = min(L, lo + seq_chunk)
            y_c, h = ssm_scan_batched_ref(dt[:, lo:hi], x[:, lo:hi], Bc[:, lo:hi],
                                          Cc[:, lo:hi], A, h)
            ys.append(y_c)
        return (torch.cat(ys, dim=1) if ys else torch.zeros(dt.shape, dtype=torch.float32)), h
    if dt.device.type != "cuda" and not dry:
        raise ValueError(f"ssm_scan: unsupported device {dt.device}")
    if common.needs_grad(dt, x, Bc, Cc, A, h0):
        return SSMScan.apply(dt, x, Bc, Cc, A, h0)
    y, h, _ = _forward(dt, x, Bc, Cc, A, h0, checkpoints=False)
    return y, h


def _on_shards(dt, x, Bc, Cc, A, h0):
    """ssm_scan on DTensors (a dry run's): dt (B, L, D) sharded by batch and
    by channel, not by sequence; x takes dt's placements, Bc and Cc its
    batch sharding, A (D, N) its channel sharding, h0 (B, D, N) both
    (each redistributed there where it is placed otherwise).  The wrapper
    runs on the local shards; y takes dt's placements, h_fin h0's."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    ins = (dt, x, Bc, Cc, A, h0)
    if not all(isinstance(t, DTensor) for t in ins):
        raise TypeError("ssm_scan: dt is a DTensor, every input must be")
    common.on_shards_check("ssm_scan", *ins)
    if any(not (p.is_replicate() or p.is_shard(0) or p.is_shard(2)) for p in dt.placements):
        raise NotImplementedError(f"ssm_scan: dt placed {dt.placements}; the scan takes the "
                                  "batch and the channels sharded, not the sequence")

    def like(batch_dim, chan_dim):
        return [Shard(batch_dim) if p.is_shard(0) and batch_dim is not None
                else Shard(chan_dim) if p.is_shard(2) and chan_dim is not None
                else Replicate() for p in dt.placements]

    want = (dt.placements, like(0, 2), like(0, None), like(0, None), like(None, 0), like(0, 1))
    ins = [t if tuple(t.placements) == tuple(w) else t.redistribute(t.device_mesh, w)
           for t, w in zip(ins, want)]
    y, h = ssm_scan(*(t.to_local() for t in ins))
    mesh = dt.device_mesh
    return (DTensor.from_local(y, mesh, dt.placements, run_check=False, shape=dt.shape,
                               stride=(dt.shape[1] * dt.shape[2], dt.shape[2], 1)),
            DTensor.from_local(h, mesh, want[5], run_check=False, shape=h0.shape,
                               stride=h0.stride()))
