"""Port parity for flash attention (`repro_torch.kernels.flash_attn`): the
plain version, which the CPU path runs and the CUDA kernel is held against
on the card, against the reference's oracle `attn_ref` and its Pallas kernel
in interpret mode, at rtol = atol = 2e-5 (float32 summation order).  A
plain mirror of the kernel's own arithmetic (tests/torch_flash_cases.py:
3xTF32 products, the base-2 online softmax, the softcap from exp2 and a
reciprocal) is held to `attn_ref` at the same shapes and to the plain version
at the on-card test's cases, at the kernel's tolerance rtol = atol = 1e-4.

The Pallas kernel masks with the padded lengths when Sq or Skv is not a
multiple of its block (its own oracle disagrees with it there), so it is
compared only at shapes it does not pad; at padded shapes the port follows
`attn_ref`, the function both the kernel's docstring and the model's
`chunked_attention` compute."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_flash_cases import FLASH_CASES, kernel_mirror, make_case, tf32

from repro.kernels.flash_attn.flash_attn import flash_attn_pallas
from repro.kernels.flash_attn.ops import flash_attention as ref_flash_attention
from repro.kernels.flash_attn.ref import attn_ref as ref_attn_ref
from repro_torch.kernels import common
from repro_torch.kernels.flash_attn import attn_mask, attn_ref, flash_attention

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
# the card kernel against the plain version (chip_smoke.py's FLASH_TOL)
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(sq, skv, dh, seed, lead=()):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=lead + (s, dh)).astype(np.float32) for s in (sq, skv, skv)]


def _port(q, k, v, **kw):
    return attn_ref(*map(torch.from_numpy, (q, k, v)), **kw).numpy()


def _mirror(q, k, v, **kw):
    """The kernel's arithmetic on one head: q (Sq, dh), k and v (Skv, dh)."""
    q, k, v = (torch.from_numpy(t)[None, :, None] for t in (q, k, v))
    return kernel_mirror(q, k, v, **kw)[0, :, 0].numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(64, 64), (96, 96), (32, 128)])
def test_single_head_matches_attn_ref_and_pallas(causal, sq, skv):
    q, k, v = _qkv(sq, skv, 32, sq + skv)
    got = _port(q, k, v, causal=causal)
    want = np.asarray(ref_attn_ref(*map(jnp.asarray, (q, k, v)), causal=causal))
    pallas = np.asarray(flash_attn_pallas(*map(jnp.asarray, (q, k, v)), causal=causal,
                                          block_q=32, block_k=32, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("window,softcap", [(16, 0.0), (0, 30.0), (8, 20.0), (24, 50.0)])
def test_window_softcap_matches_attn_ref_and_pallas(window, softcap):
    q, k, v = _qkv(64, 64, 16, window + int(softcap))
    kw = dict(causal=True, window=window, softcap=softcap)
    got = _port(q, k, v, **kw)
    want = np.asarray(ref_attn_ref(*map(jnp.asarray, (q, k, v)), **kw))
    pallas = np.asarray(flash_attn_pallas(*map(jnp.asarray, (q, k, v)), block_q=16,
                                          block_k=16, interpret=True, **kw))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("causal,sq,skv,window", [
    (True, 8, 40, 0),    # the Pallas kernel's query offset comes from padded lengths
    (False, 40, 40, 0),  # the Pallas kernel lets padded keys into the softmax
    (True, 40, 40, 0),
    (False, 40, 40, 9),
    (True, 17, 50, 12),
])
def test_padded_shapes_follow_attn_ref(causal, sq, skv, window):
    q, k, v = _qkv(sq, skv, 16, sq * skv)
    got = _port(q, k, v, causal=causal, window=window)
    want = np.asarray(ref_attn_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                                   window=window))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (8, 1), (4, 4)])  # GQA, MQA, MHA
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (12, 50.0)])
def test_batched_wrapper_matches_reference_wrapper(hq, hkv, window, softcap):
    rng = np.random.default_rng(hq * 10 + hkv)
    B, S, dh = 2, 48, 16
    q = rng.normal(size=(B, S, hq, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, hkv, dh)).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=softcap)
    before = common.launch_counts()["flash_attn"]
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    assert common.launch_counts()["flash_attn"] == before  # CPU: the plain version
    want = np.asarray(ref_flash_attention(*map(jnp.asarray, (q, k, v)), use_pallas=False,
                                          **kw))
    pallas = np.asarray(ref_flash_attention(*map(jnp.asarray, (q, k, v)), use_pallas=True,
                                            **kw))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_mask_aligns_ends_and_empty_rows_are_zero():
    m = attn_mask(3, 5, causal=True, window=2, device="cpu")
    # query i sits at key position i + 2 and sees keys (pos - 2, pos]
    assert m.tolist() == [[False, True, True, False, False],
                          [False, False, True, True, False],
                          [False, False, False, True, True]]
    q, k, v = (torch.ones((4, 8)), torch.ones((2, 8)), torch.ones((2, 8)))
    out = attn_ref(q, k, v, causal=True)  # queries 0, 1 sit before every key
    assert torch.equal(out[:2], torch.zeros((2, 8)))
    assert torch.allclose(out[2:], torch.ones((2, 8)))


def test_cpu_wrapper_stays_differentiable():
    """The autograd guard is the kernel's: on CPU tensors the wrapper runs
    the plain version, and gradients reach q, k and v."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 5, 2, 8), generator=g).requires_grad_() for _ in range(3))
    flash_attention(q, k[:, :, :1], v[:, :, :1], window=3, softcap=20.0).sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in (q, k, v))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(64, 64), (96, 96), (32, 128)])
def test_kernel_mirror_single_head_matches_attn_ref(causal, sq, skv):
    q, k, v = _qkv(sq, skv, 32, sq + skv)
    want = np.asarray(ref_attn_ref(*map(jnp.asarray, (q, k, v)), causal=causal))
    np.testing.assert_allclose(_mirror(q, k, v, causal=causal), want, **KERNEL_TOL)


@pytest.mark.parametrize("window,softcap", [(16, 0.0), (0, 30.0), (8, 20.0), (24, 50.0)])
def test_kernel_mirror_window_softcap_matches_attn_ref(window, softcap):
    q, k, v = _qkv(64, 64, 16, window + int(softcap))
    kw = dict(causal=True, window=window, softcap=softcap)
    want = np.asarray(ref_attn_ref(*map(jnp.asarray, (q, k, v)), **kw))
    np.testing.assert_allclose(_mirror(q, k, v, **kw), want, **KERNEL_TOL)


@pytest.mark.parametrize("causal,sq,skv,window", [
    (True, 8, 40, 0), (False, 40, 40, 0), (True, 40, 40, 0), (False, 40, 40, 9), (True, 17, 50, 12),
])
def test_kernel_mirror_padded_shapes_match_attn_ref(causal, sq, skv, window):
    q, k, v = _qkv(sq, skv, 16, sq * skv)
    want = np.asarray(ref_attn_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                                   window=window))
    np.testing.assert_allclose(_mirror(q, k, v, causal=causal, window=window), want,
                               **KERNEL_TOL)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (8, 1), (4, 4)])  # GQA, MQA, MHA
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (12, 50.0)])
def test_kernel_mirror_batched_matches_reference_wrapper(hq, hkv, window, softcap):
    rng = np.random.default_rng(hq * 10 + hkv)
    B, S, dh = 2, 48, 16
    q = rng.normal(size=(B, S, hq, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, hkv, dh)).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=softcap)
    got = kernel_mirror(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    want = np.asarray(ref_flash_attention(*map(jnp.asarray, (q, k, v)), use_pallas=False,
                                          **kw))
    np.testing.assert_allclose(got, want, **KERNEL_TOL)


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_kernel_mirror_matches_plain_at_card_cases(name):
    """The on-card test's cases (tests/test_torch_kernels_cuda.py): the
    kernel's arithmetic stays within the kernel's tolerance of the plain
    version it is held to on the card; a row that sees no key is 0."""
    q, k, v, kw = make_case(name)
    q, k, v = map(torch.from_numpy, (q, k, v))
    got = kernel_mirror(q, k, v, **kw)
    want = flash_attention(q, k, v, **kw)  # CPU tensors: the plain version
    torch.testing.assert_close(got, want, **KERNEL_TOL)
    Sq, Skv = q.shape[1], k.shape[1]
    if kw["causal"] and Sq > Skv:
        assert torch.equal(got[:, :Sq - Skv], torch.zeros_like(got[:, :Sq - Skv]))


def _float64(q, k, v, **kw):
    """attn_ref's function in float64 (the plain version computes in float32)."""
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.double().reshape(B, Sq, Hkv, Hq // Hkv, dh)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.double()) / np.sqrt(dh)
    if kw["softcap"] > 0:
        s = kw["softcap"] * torch.tanh(s / kw["softcap"])
    mask = attn_mask(Sq, Skv, causal=kw["causal"], window=kw["window"], device="cpu")
    p = torch.nan_to_num(torch.softmax(s.masked_fill(~mask, float("-inf")), -1), nan=0.0)
    return torch.einsum("bhgst,bthd->bshgd", p, v.double()).reshape(B, Sq, Hq, dh)


@pytest.mark.parametrize("name", ["gemma-2b serving", "window + softcap", "dh 200"])
def test_mirror_is_as_accurate_as_float32_at_large_scores(name):
    """q, k and v scaled by 30 (scores of ~900): against float64, the
    kernel's 3xTF32 arithmetic errs no more than twice as much as the
    float32 plain version, where a single TF32 product would err about
    2^13 times as much (10 mantissa bits instead of 23)."""
    q, k, v, kw = make_case(name)
    q, k, v = (torch.from_numpy(t) * 30 for t in (q, k, v))
    exact = _float64(q, k, v, **kw)
    err_mirror = float((kernel_mirror(q, k, v, **kw).double() - exact).abs().max())
    err_fp32 = float((flash_attention(q, k, v, **kw).double() - exact).abs().max())
    assert err_mirror <= 2 * err_fp32


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 2 ** -12, -(one + 2 ** -11), one + 3 * 2 ** -11,
                      one + 2 ** -10 + 2 ** -20, 0.0, float("inf")], dtype=torch.float32)
    want = [one + 2 ** -10, one, -(one + 2 ** -10), one + 2 ** -9, one + 2 ** -10, 0.0,
            float("inf")]
    assert tf32(x).tolist() == want
