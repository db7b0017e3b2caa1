"""Shared model components (port of `repro.models.common`): norms, rotary
embeddings (RoPE, M-RoPE), whisper's sinusoidal positions, the dense
initialiser, the cross-entropy."""
from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), in float32 (gemma's form:
    a zero scale is the identity gain)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(dt)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the dtype jnp's `@` computes: both operands promoted to
    `torch.promote_types` of theirs (bf16 with float32 gives float32), where
    torch's `@` refuses a mix.  The casts are no-ops when the dtypes agree."""
    from torch.distributed.tensor import DTensor

    t = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(t), b.to(t)
    if isinstance(a, DTensor) and isinstance(b, DTensor):
        return _sharded_matmul(a, b)
    return a @ b


def embedding_lookup(weight: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """weight[tokens].  On a dry run's DTensor weight, whose vocab rows may
    be split over a mesh dim: its other splits are gathered, each rank
    looks up the tokens its vocab shard holds (0 for the others) on the
    local shards, and the shards' rows are a pending sum (DTensor's own
    rule for the lookup's backward fails on some versions of torch)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(weight, DTensor):
        return weight[tokens]
    mesh = weight.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    want = [p if p.is_shard(0) else Replicate() for p in weight.placements]
    vocab_dims = [i for i, p in enumerate(want) if p.is_shard(0)]
    if len(vocab_dims) > 1:
        raise NotImplementedError(f"the vocab over several mesh dims: {weight.placements}")
    if want != list(weight.placements):
        weight = weight.redistribute(mesh, want)
    tok_want = [Replicate() if i in vocab_dims or p.is_partial() else p
                for i, p in enumerate(tokens.placements)]
    if any(p.is_shard() and p.dim != 0 for p in tok_want):
        raise NotImplementedError(f"tokens placed {tokens.placements}")
    local_w = weight.to_local()
    idx = tokens.redistribute(mesh, tok_want).to_local().long()
    if vocab_dims:
        (md,) = vocab_dims
        idx = idx - mesh.get_local_rank(md) * -(-weight.shape[0] // mesh.size(md))
        n = local_w.shape[0]
        inside = (idx >= 0) & (idx < n)
        rows = local_w[idx.clamp(0, n - 1)] * inside[..., None].to(local_w.dtype)
    else:
        rows = local_w[idx]
    out = [Partial() if i in vocab_dims else p for i, p in enumerate(tok_want)]
    shape = (*tokens.shape, weight.shape[1])
    return DTensor.from_local(rows, mesh, out, run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def contiguous_stride(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of `shape` (a DTensor's global
    strides, computed without allocating one)."""
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.append(n)
        n *= max(size, 1)
    return tuple(reversed(stride))


def _sharded_matmul(a, b):
    """A dry run's DTensor product a (..., K) @ b (K, N), on the local
    shards with the placements GSPMD gives it, mesh dim by mesh dim: where
    a's rows are split, b is gathered there (the ZeRO gather of a weight)
    and the product's rows are split alike; where a's K is split, b's is
    too and the product is a pending sum; else b's columns stay split
    (column parallel), or the product is whole.  A pending sum in a is
    reduced first.  (DTensor's own rule for the pair folds a's split rows
    into one dim, which it cannot always view.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    a = _reduced(a)
    mesh, last = a.device_mesh, a.ndim - 1
    b_want, out = [], []
    for pa, pb in zip(a.placements, b.placements):
        if pa.is_shard() and pa.dim < last:
            b_want.append(Replicate())
            out.append(Shard(pa.dim))
        elif pa.is_shard():
            b_want.append(Shard(0))
            out.append(Partial())
        elif pb.is_shard(1):
            b_want.append(Shard(1))
            out.append(Shard(last))
        else:
            b_want.append(Replicate())
            out.append(Replicate())
    if b_want != list(b.placements):
        b = b.redistribute(mesh, b_want)
    local = a.to_local().contiguous() @ b.to_local()
    shape = (*a.shape[:-1], b.shape[1])
    return DTensor.from_local(local, mesh, out, run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def dense_init_(w: torch.Tensor, generator: torch.Generator, in_axis: int = 0) -> torch.Tensor:
    """Fill `w` in place with normal / sqrt(fan_in), fan_in = w.shape[in_axis]
    (the reference's `dense_init`)."""
    with torch.no_grad():
        return w.normal_(0.0, 1.0 / math.sqrt(w.shape[in_axis]), generator=generator)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) int."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)  # (dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
                sections: tuple[float, float, float] = (0.25, 0.375, 0.375)) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x: (B, S, H, dh); positions: (B, S, 3)
    int, the (temporal, height, width) streams.  The dh/2 frequency slots
    fall into three sections, int(half * 0.25) driven by t and int(half *
    0.375) by h, the rest by w (16 / 24 / 24 at dh 128).  Where the three
    streams are equal (text) this is `apply_rope`."""
    dh = x.shape[-1]
    half = dh // 2
    n_t = int(half * sections[0])
    n_h = int(half * sections[1])
    sec_pos = torch.cat([positions[..., i:i + 1].expand(*positions.shape[:-1], n)
                         for i, n in enumerate((n_t, n_h, half - n_t - n_h))], dim=-1)
    ang = sec_pos.to(torch.float32) * rope_freqs(dh, theta, device=x.device)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper's fixed position table (max_len, d_model) float32: [sin |
    cos] of pos / 10000^(2i / d_model), the two halves concatenated (not
    interleaved)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d_model))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean negative log-likelihood over tokens, in float32 through
    logsumexp.  logits (B, S, V), labels (B, S) int; with `mask` (B, S) the
    sum of nll * mask over max(sum(mask), 1)."""
    logits = logits.to(torch.float32)
    nll = _logsumexp(logits) - _gold(logits, labels.long())
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _vocab_sharded(logits) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(logits, DTensor) and any(p.is_shard(logits.ndim - 1)
                                               for p in logits.placements)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim.  On a dry run's DTensor logits with the
    vocab sharded, DTensor would gather the whole vocab first; the shards
    instead reduce their maxima (an all-reduce of max) and then their sums
    of exp(x - max) (an all-reduce of sum), as GSPMD reduces a sharded
    axis."""
    if not _vocab_sharded(logits):
        return torch.logsumexp(logits, dim=-1)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, last = logits.device_mesh, logits.ndim - 1
    logits = _reduced(logits)
    lead = [Replicate() if p.is_shard(last) else p for p in logits.placements]
    shape = logits.shape[:-1]
    stride = contiguous_stride(shape)

    def reduce(local, op):
        part = [Partial(op) if p.is_shard(last) else p for p in logits.placements]
        return DTensor.from_local(local, mesh, part, run_check=False, shape=shape,
                                  stride=stride).redistribute(mesh, lead)

    local = logits.to_local()
    m = reduce(local.detach().amax(dim=-1), "max")
    s = reduce(torch.exp(local - m.to_local()[..., None]).sum(dim=-1), "sum")
    return torch.log(s) + m


def _reduced(t):
    """A DTensor with its pending sums reduced."""
    from torch.distributed.tensor import Replicate

    if any(p.is_partial() for p in t.placements):
        t = t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in t.placements])
    return t


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[..., labels].  On a dry run's DTensor logits with the vocab
    sharded (`launch.dryrun`), whose gather DTensor cannot place, each rank
    gathers the labels its vocab shard holds (0 elsewhere) on its local
    shard, and the shards' values are summed: a Partial placement, which
    DTensor all-reduces where the loss combines it with the logsumexp."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    last = logits.ndim - 1
    if not _vocab_sharded(logits):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    mesh = logits.device_mesh
    logits = _reduced(logits)
    vocab_dims = [i for i, p in enumerate(logits.placements) if p.is_shard(last)]
    if len(vocab_dims) != 1:
        raise NotImplementedError(f"the vocab over several mesh dims: {logits.placements}")
    (md,) = vocab_dims
    lead = [Replicate() if p.is_shard(last) else p for p in logits.placements]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    local = logits.to_local()
    n = local.shape[-1]
    lo = mesh.get_local_rank(md) * -(-logits.shape[-1] // mesh.size(md))
    lab = labels.redistribute(mesh, lead).to_local() - lo
    inside = (lab >= 0) & (lab < n)
    g = torch.gather(local, -1, lab.clamp(0, n - 1)[..., None])[..., 0] * inside
    out_shape = logits.shape[:-1]
    return DTensor.from_local(g, mesh, [Partial() if i == md else p for i, p in enumerate(lead)],
                              run_check=False, shape=out_shape,
                              stride=contiguous_stride(out_shape))
