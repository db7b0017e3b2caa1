"""The backward of flash attention (`repro_torch.kernels.flash_attn`), on
the CPU: the plain dense backward `flash_attention_bwd_ref` -- the function
the backward kernel (csrc/flash_attn_bwd.cu) computes and is held to on the
card -- against torch autograd of the plain forward and against jax.vjp of
the reference's `chunked_attention` (which the reference differentiates in
training), the forward's base-2 log-sum-exp against the reference's scores,
and a plain mirror of the kernel's walk over tiles (its row and key bounds)
against the dense backward.  Cases: tests/torch_flash_cases.py BWD_CASES
(causal, window, softcap, GQA, Sq != Skv, rows with no key).  A plain
mirror of the kernel's arithmetic (its tiles, row chunks and 3xTF32
products) is held to the dense backward and to the reference's VJP.

Tolerances: float32 summation order only, rtol = atol = 2e-5 against
autograd and the tile mirror, 5e-5 against JAX (its own chunked online
softmax and exp; the lse of rows that see a key likewise); rows with no key
have zero gradient exactly, and their lse is +inf exactly."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_flash_cases import (BWD_CASES, BWD_ROW_TILE, bwd_kernel_mirror, bwd_tile_mirror,
                               chunk_tiles, empty_rows, make_bwd_case)

from repro.models.attention import chunked_attention
from repro_torch.kernels.flash_attn import flash_attention_bwd_ref, flash_attention_ref

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
JAX_TOL = dict(rtol=5e-5, atol=5e-5)
# the kernel's arithmetic against the dense backward and the reference: each
# gradient within this share of its largest entry (chip_smoke.py's
# FLASH_BWD_REL_TOL, which holds the card kernel to the plain version)
FLASH_BWD_REL_TOL = 2e-4


def _torch_case(name):
    q, k, v, do, kw = make_bwd_case(name)
    return (*(torch.from_numpy(t) for t in (q, k, v, do)), kw)


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_bwd_ref_matches_torch_autograd(name):
    q, k, v, do, kw = _torch_case(name)
    o, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    e = empty_rows(q.shape[1], k.shape[1], kw)
    # autograd over the rows that see a key (softmax's own gradient at a row
    # of -inf is NaN); dropping the leading rows keeps every position
    qa, ka, va = (t.clone().requires_grad_() for t in (q[:, e:], k, v))
    out = flash_attention_ref(qa, ka, va, **kw)
    ga = torch.autograd.grad(out, (qa, ka, va), do[:, e:])
    torch.testing.assert_close(dq[:, e:], ga[0], **TOL)
    torch.testing.assert_close(dk, ga[1], **TOL)
    torch.testing.assert_close(dv, ga[2], **TOL)
    assert torch.equal(dq[:, :e], torch.zeros_like(dq[:, :e]))
    assert bool(torch.isinf(lse[:, :e]).all()) and bool(torch.isfinite(lse[:, e:]).all())
    assert all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))


@functools.lru_cache(maxsize=None)
def _reference_vjp(name):
    """The reference's training attention (`chunked_attention`, the ends
    aligned by q_offset = Skv - Sq) and its gradients by jax.vjp, for dO."""
    q, k, v, do, kw = make_bwd_case(name)
    Sq, Skv = q.shape[1], k.shape[1]
    f = lambda a, b, c: chunked_attention(a, b, c, q_offset=Skv - Sq, kv_chunk=16, **kw)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("name", [n for n in BWD_CASES if "empty" not in n])
def test_bwd_ref_matches_reference_vjp(name):
    """The reference's training attention (`chunked_attention`, the ends
    aligned by q_offset = Skv - Sq) differentiated by jax.vjp; its lse from
    the reference's own capped scores."""
    q, k, v, do, kw = make_bwd_case(name)
    Sq, Skv = q.shape[1], k.shape[1]
    out, ref = _reference_vjp(name)
    qt, kt, vt, dot = (torch.from_numpy(t) for t in (q, k, v, do))
    o, lse = flash_attention_ref(qt, kt, vt, return_lse=True, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), **JAX_TOL)
    for got, want in zip(flash_attention_bwd_ref(qt, kt, vt, o, lse, dot, **kw), ref):
        np.testing.assert_allclose(got.numpy(), want, **JAX_TOL)
    # lse: log2 sum 2^(z log2 e) of the reference's capped, masked scores
    B, Hq, Hkv, dh = q.shape[0], q.shape[2], k.shape[2], q.shape[3]
    s = np.einsum("bshd,bthd->bhst", q.astype(np.float64),
                  np.repeat(k, Hq // Hkv, axis=2).astype(np.float64)) / np.sqrt(dh)
    if kw["softcap"] > 0:
        s = kw["softcap"] * np.tanh(s / kw["softcap"])
    qp = np.arange(Sq)[:, None] + Skv - Sq
    kp = np.arange(Skv)[None, :]
    keep = (kp <= qp) if kw["causal"] else np.ones((Sq, Skv), bool)
    if kw["window"] > 0:
        keep &= kp > qp - kw["window"]
    s = np.where(keep, s, -np.inf)
    want = (np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)) / np.log(2)
    np.testing.assert_allclose(lse.numpy(), want.transpose(0, 2, 1), **JAX_TOL)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("name", list(BWD_CASES))
def test_kernel_tile_walk_matches_dense(name, tile):
    """The kernel's tile bounds skip no (row, key) pair that a mask keeps:
    the mirror's walk, at tiles of 16 and of 32 (the kernel's), equals the
    dense backward."""
    q, k, v, do, kw = _torch_case(name)
    o, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    dense = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    walked = bwd_tile_mirror(q, k, v, o, lse, do, tile=tile, **kw)
    for got, want in zip(walked, dense):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("name", list(BWD_CASES))
def test_kernel_mirror_matches_dense_and_reference(name, chunks):
    """The kernel's arithmetic (`bwd_kernel_mirror`: its tiles, the row
    chunks of the dK / dV pass summed in chunk order, every product by
    3xTF32, ex2 and the forward's softcap formula) against the dense
    backward and against jax.vjp of the reference's `chunked_attention`:
    each gradient within FLASH_BWD_REL_TOL of its largest entry; rows with
    no key keep exactly zero gradient.  At 4 chunks some key tiles' rows
    split unevenly (gemma-2b's cut shape: 6 row tiles as 1, 2, 1, 2) and
    some chunks are empty."""
    q, k, v, do, kw = _torch_case(name)
    o, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    dense = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    got = bwd_kernel_mirror(q, k, v, o, lse, do, chunks=chunks, **kw)
    wants = [dense]
    if "empty" not in name:
        wants.append([torch.tensor(g) for g in _reference_vjp(name)[1]])
    for want in wants:
        for tag, a, b in zip(("dq", "dk", "dv"), got, want):
            err = float((a - b).abs().max())
            assert err <= FLASH_BWD_REL_TOL * float(b.abs().max()), (tag, err)
    e = empty_rows(q.shape[1], k.shape[1], kw)
    assert torch.equal(got[0][:, :e], torch.zeros_like(got[0][:, :e]))
    if name == "gemma-2b training, cut" and chunks == 4:
        R = q.shape[1] * q.shape[2] // k.shape[2]
        sizes = [len(t) for t in chunk_tiles(-(-R // BWD_ROW_TILE), chunks)]
        assert sizes == [1, 2, 1, 2]


def test_cpu_flash_attention_is_differentiable_in_the_model_dtype():
    """On CPU tensors the wrapper is the plain version, which torch
    differentiates; the model's attention upcasts bf16 inputs to float32
    and casts the output back (models/attention.py `_attend`)."""
    from repro_torch.models.attention import Attention, AttnConfig

    cfg = AttnConfig(d_model=16, n_heads=4, n_kv=1, head_dim=8)
    att = Attention(cfg)
    gen = torch.Generator().manual_seed(0)
    att.reset_parameters(gen)
    x = torch.randn((2, 6, 16), generator=gen)
    pos = torch.arange(6).expand(2, 6)
    out32 = att(x, pos)
    out32.sum().backward()
    assert att.wq.grad is not None and bool(torch.isfinite(att.wq.grad).all())
    att16 = Attention(cfg)
    att16.load_state_dict({k: v.to(torch.bfloat16) for k, v in att.state_dict().items()},
                          assign=True)
    out16 = att16(x.to(torch.bfloat16), pos)
    assert out16.dtype == torch.bfloat16
    torch.testing.assert_close(out16.float(), out32.detach(), rtol=0.05, atol=0.05)
