"""Public wrapper for batched grouped-query flash attention (port of
`repro.kernels.flash_attn.ops.flash_attention`): the hand-written kernels
(`csrc/flash_attn.cu`, `flash_attn_launch`; the backward
`csrc/flash_attn_bwd.cu`, `flash_attn_bwd_launch`) on CUDA tensors, the
plain version (`ref.flash_attention_ref`, which torch differentiates) on
CPU tensors.  The forward kernel packs a kv head's group of query heads into
its row tiles, so K and V are staged once for the group (and never
repeated), and runs both products on the tensor cores as three TF32 MMAs a
product, at float32 accuracy.  Where autograd records the call, the forward
also writes each row's log-sum-exp and the backward kernels compute dq, dk
and dv from it (`FlashAttention`), all five products on the tensor cores in
3xTF32 likewise.  `bf16_probs` (the models' attn_bf16_probs) takes the
kernels' bf16-P forms (`flash_attn_bf16_launch`, `flash_attn_bwd_bf16_launch`:
the P V product, and the backward's P^T dO and dO V^T, as one bf16 MMA a
step), counted apart as `flash_attn_bf16` and `flash_attn_bwd_bf16`; a CUDA
call with it launches them or raises, never the float32 form.

A dry run (`launch.dryrun`) calls the wrappers on meta (or fake) tensors: they
allocate the outputs a launch would write (o, and the lse autograd saves)
and record the launch with the dry run's counter (`common.dry_launch`)
instead of launching; LAUNCHES does not move.  On DTensor inputs, which
only a dry run makes, the wrapper runs on the local shards: q may be
sharded by sequence (the attention's constraint), k and v not; the launch
is costed at the local shapes with the ends aligned (the pairs of the
sequence's last shard, the busiest)."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .. import common
from .ref import flash_attention_ref

# the kernel keeps a warp's 16 rows of output in registers, dh padded to 64,
# 128, 192 or 256 columns
MAX_DH = 256


def _check(q, k, v):
    """(B, Sq, Skv, Hq, Hkv, dh) of valid kernel inputs; raises on what the
    kernels do not take."""
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    common.check("q", q, device=dev, dtype=torch.float32, shape=(B, Sq, Hq, dh))
    common.check("k", k, device=dev, dtype=torch.float32, shape=(B, Skv, Hkv, dh))
    common.check("v", v, device=dev, dtype=torch.float32, shape=(B, Skv, Hkv, dh))
    if Hq % Hkv != 0:
        raise ValueError(f"flash_attn: {Hq} query heads are not a multiple of {Hkv} kv heads")
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"flash_attn: the kernel takes 1 <= dh <= {MAX_DH}, got {dh}")
    return B, Sq, Skv, Hq, Hkv, dh


# each form's (forward counter, entry point), (backward counter, entry point),
# by bf16_probs
FORMS = {False: (("flash_attn", "flash_attn_launch"),
                 ("flash_attn_bwd", "flash_attn_bwd_launch")),
         True: (("flash_attn_bf16", "flash_attn_bf16_launch"),
                ("flash_attn_bwd_bf16", "flash_attn_bwd_bf16_launch"))}


def _forward(q, k, v, causal: bool, window: int, softcap: float, with_lse: bool,
             bf16_probs: bool = False):
    """One forward launch: (out, lse (B, Sq, Hq) in base 2, or None)."""
    B, Sq, Skv, Hq, Hkv, dh = _check(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return out, lse
    if common.is_dry(q, k, v):
        common.dry_launch(FORMS[bool(bf16_probs)][0][0], B=B, Sq=Sq, Skv=Skv, Hq=Hq, Hkv=Hkv,
                           dh=dh, causal=causal, window=window)
        return out, lse
    common.launch(*FORMS[bool(bf16_probs)][0], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), None if lse is None else lse.data_ptr(), B, Sq, Skv, Hq,
                  Hkv, dh, int(causal), int(window), float(softcap))
    return out, lse


def fwd_tiles(B: int, Sq: int, Hq: int, Hkv: int) -> tuple[int, int]:
    """(rows a block, keys a tile) that a forward launch walks on the
    current card (`flash_attn_tiles`): the bf16-P form rounds each key
    tile's p against the running max, so its plain mirror
    (`ref.flash_attention_bf16_tiles_ref`) walks the same tiles."""
    t = common.library().flash_attn_tiles(B, Sq, Hq, Hkv)
    if t < 0:
        raise RuntimeError(f"flash_attn: tiles failed with cudaError {-t}")
    return t >> 16, t & 0xFFFF


def bwd_chunks(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, dh: int) -> int:
    """The row chunks C into which the backward's dK / dV pass cuts each key
    tile's rows on the current card (`flash_attn_bwd_chunks`: 1 where its
    key tiles give every SM a block).  A backward call launches two kernels
    at C = 1 and three above (the chunks' reduce)."""
    c = common.library().flash_attn_bwd_chunks(B, Sq, Skv, Hq, Hkv, dh)
    if c < 1:
        raise RuntimeError(f"flash_attn_bwd: chunks failed with cudaError {-c}")
    return c


def bwd_kernels(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, dh: int) -> int:
    """The kernels one backward call launches on the current card: the dQ
    pass (with delta), the dK / dV pass (none without keys), and the
    chunks' reduce where the dK / dV pass is cut into row chunks.  The
    bf16-P form launches the same kernels, cut into the same chunks."""
    if B * Sq == 0:
        return 0
    return 1 + (Skv > 0) + (bwd_chunks(B, Sq, Skv, Hq, Hkv, dh) > 1)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, bf16_probs: bool = False):
    """The backward kernel on CUDA tensors: (dq, dk, dv) of the attention
    whose forward gave o and lse (`_forward(..., with_lse=True)`), for the
    output gradient `do`; all float32 and contiguous, shaped as the
    forward's.  `bf16_probs`: the bf16-P form, the gradient of the forward's
    bf16-P form.  No plain fallback: `ref.flash_attention_bwd_ref` is its
    plain version, for the tests and chip_smoke.py."""
    dry = common.is_dry(q, k, v)
    if q.device.type != "cuda" and not dry:
        raise ValueError(f"flash_attn_bwd: the backward kernel needs CUDA tensors, got {q.device}")
    B, Sq, Skv, Hq, Hkv, dh = _check(q, k, v)
    dev = q.device
    common.check("o", o, device=dev, dtype=torch.float32, shape=(B, Sq, Hq, dh))
    common.check("do", do, device=dev, dtype=torch.float32, shape=(B, Sq, Hq, dh))
    common.check("lse", lse, device=dev, dtype=torch.float32, shape=(B, Sq, Hq))
    if q.numel() == 0:  # no query: nothing flows back, and no kernel is launched
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dry:  # the scratch (partials, delta) lives within the call: not modelled
        common.dry_launch(FORMS[bool(bf16_probs)][1][0], B=B, Sq=Sq, Skv=Skv, Hq=Hq, Hkv=Hkv,
                           dh=dh, causal=causal, window=window)
        return dq, dk, dv
    # the partial dK and dV of C > 1 row chunks, then delta (B, Sq, Hq)
    C = bwd_chunks(B, Sq, Skv, Hq, Hkv, dh)
    scratch = torch.empty(2 * C * k.numel() * (C > 1) + B * Sq * Hq, dtype=torch.float32,
                          device=dev)
    common.launch(*FORMS[bool(bf16_probs)][1], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), B, Sq, Skv, Hq, Hkv, dh,
                  int(causal), int(window), float(softcap))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the rows' log-sum-exp, and the backward
    kernel as its gradient (once differentiable: the backward is no
    autograd graph)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float, bf16_probs: bool):
        out, lse = _forward(q, k, v, causal, window, softcap, with_lse=True,
                            bf16_probs=bf16_probs)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softcap, bf16_probs)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap, bf16_probs = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), causal=causal,
                                         window=window, softcap=softcap, bf16_probs=bf16_probs)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, bf16_probs: bool = False) -> torch.Tensor:
    """q (B, Sq, Hq, dh), k and v (B, Skv, Hkv, dh) float32, Hq a multiple of
    Hkv -> (B, Sq, Hq, dh) float32.  `causal` aligns the ends (query i sits
    at key position i + Skv - Sq); `window` > 0 keeps the last `window` keys
    up to that position; `softcap` > 0 caps the scores as c tanh(s / c);
    `bf16_probs` rounds P and V to bf16 in the P V product (the bf16-P
    forms).  On CUDA tensors that autograd records, the call goes through
    `FlashAttention` (the backward kernel); else one forward launch.  Fake
    or meta tensors (a dry run's) take the kernel path without launching;
    DTensors run on their local shards (`_on_shards`)."""
    from torch.distributed.tensor import DTensor

    kw = dict(causal=causal, window=window, softcap=softcap, bf16_probs=bf16_probs)
    if isinstance(q, DTensor):
        return _on_shards(q, k, v, kw)
    dry = common.is_dry(q, k, v)  # a dry run: the kernel's path, which records the launch
    if q.device.type == "cpu" and not dry:
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                   bf16_probs=bf16_probs)
    if q.device.type != "cuda" and not dry:
        raise ValueError(f"flash_attn: unsupported device {q.device}")
    if common.needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, int(window), float(softcap),
                                    bool(bf16_probs))
    return _forward(q, k, v, causal, window, softcap, with_lse=False, bf16_probs=bf16_probs)[0]


def _on_shards(q, k, v, kw: dict):
    """flash_attention on DTensors (a dry run's).  q (B, S, Hq, dh) may be
    sharded by batch, by sequence (the attention's constraint) and by heads
    (a decode step's projection); k and v are placed to match on each mesh
    dim: by batch with q's batch, whole where q's sequence is sharded, by
    heads where q's heads are and Hkv divides (whole where Hkv is 1; else
    q's heads are gathered); a pending sum in q is reduced.  Whatever placement that asks for is a
    redistribution DTensor counts.  The wrapper runs on the local shards;
    the output takes q's placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not (isinstance(k, DTensor) and isinstance(v, DTensor)):
        raise TypeError("flash_attn: q is a DTensor, k and v must be too")
    common.on_shards_check("flash_attn", q, k, v)
    mesh = q.device_mesh
    Hkv = k.shape[2]
    qp, kp = list(q.placements), []
    for i, p in enumerate(qp):
        if p.is_shard(0):
            kp.append(Shard(0))
        elif p.is_shard(1) or p.is_replicate():
            kp.append(Replicate())
        elif p.is_shard(2) and Hkv % mesh.size(i) == 0:
            kp.append(Shard(2))
        elif p.is_shard(2):
            if Hkv != 1:
                qp[i] = Replicate()
            kp.append(Replicate())
        elif p.is_partial():  # a pending sum: reduced first
            qp[i] = Replicate()
            kp.append(Replicate())
        else:
            raise NotImplementedError(f"flash_attn: q placed {q.placements}")
    q = q if qp == list(q.placements) else q.redistribute(mesh, qp)
    k, v = (t if list(t.placements) == kp else t.redistribute(mesh, kp) for t in (k, v))
    out = flash_attention(q.to_local(), k.to_local(), v.to_local(), **kw)
    return DTensor.from_local(out, mesh, qp, run_check=False, shape=q.shape, stride=q.stride())
