"""Port parity for flash attention (`repro_torch.kernels.flash_attn`): the
plain version, which the CPU path runs and the CUDA kernel is held against
on the card, against the reference's oracle `attn_ref` and its Pallas kernel
in interpret mode, at rtol = atol = 2e-5 (float32 summation order).

The Pallas kernel masks with the padded lengths when Sq or Skv is not a
multiple of its block (its own oracle disagrees with it there), so it is
compared only at shapes it does not pad; at padded shapes the port follows
`attn_ref`, the function both the kernel's docstring and the model's
`chunked_attention` compute."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.flash_attn import flash_attn_pallas
from repro.kernels.flash_attn.ops import flash_attention as ref_flash_attention
from repro.kernels.flash_attn.ref import attn_ref as ref_attn_ref
from repro_torch.kernels import common
from repro_torch.kernels.flash_attn import attn_mask, attn_ref, flash_attention

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(sq, skv, dh, seed, lead=()):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=lead + (s, dh)).astype(np.float32) for s in (sq, skv, skv)]


def _port(q, k, v, **kw):
    return attn_ref(*map(torch.from_numpy, (q, k, v)), **kw).numpy()


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
