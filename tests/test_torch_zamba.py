"""Port parity for the hybrid family (zamba2-7b): Mamba-2 (`repro_torch.models
.ssm.Mamba2`) against the JAX package's `mamba2_block` / `mamba2_decode`
(plain jnp, no Pallas kernel), and the LM's one shared attention block
against the reference's `params["shared"]`, with the reference's weights
carried across and inputs from a seeded numpy generator.

Tolerances:
  * TOL, rtol 1e-4 / atol 1e-5, for the block's output, its SSD state
    (B, H, N, head_dim) and its conv tail: float32 einsums, cumulative sums
    and exps in another summation order.
  * ZAMBA_TOL, 4 x TOL, for the smoke LM's hidden states
    (tests/test_torch_models.py) and its Mamba-2 states after prefill
    (tests/test_torch_decode.py, whose other rules hold it as the other
    models): through 13 layers the smoke model turns rounding into more
    than TOL.  The reference against itself, every weight moved by at most
    half an ulp, reads up to 1.3 x TOL at seeds 5-7; the port, another
    float32 order, 1.2-1.7 x.  `test_zamba_tol_covers_half_an_ulp_of_the_
    weights` keeps the reference's own spread within half of ZAMBA_TOL."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import api as ref_api
from repro.models import lm as ref_lm
from repro.models.ssm import Mamba2Config as RefMamba2Config
from repro.models.ssm import init_mamba2, init_mamba2_cache as ref_init_cache
from repro.models.ssm import mamba2_block, mamba2_decode
from repro_torch.configs import ARCHS
from repro_torch.kernels import common
from repro_torch.models import init_model, param_count, params_from_reference, prefill
from repro_torch.models.lm import LM, SharedPlace
from repro_torch.models.ssm import Mamba2, Mamba2Config, SSMCache, init_mamba2_cache

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
ZAMBA_TOL = dict(rtol=4e-4, atol=4e-5)
# the smoke config's Mamba-2: d_inner 128 in 4 heads of 32, N 16, chunk 8
KW = dict(d_model=64, d_inner=128, d_state=16, head_dim=32, d_conv=4)
CHUNK = 8


# the reference's block and decode step, compiled once for all the cases
REF_BLOCK = jax.jit(mamba2_block, static_argnames=("cfg", "return_cache", "chunk"))
REF_DECODE = jax.jit(mamba2_decode, static_argnames=("cfg",))


def _block(seed: int = 3):
    """The reference's parameters (numpy, with non-trivial biases, decays,
    skip and norm gain, so every parameter is exercised) and the port's
    module holding them."""
    p = jax.tree.map(np.asarray, init_mamba2(jax.random.key(seed), RefMamba2Config(**KW)))
    rng = np.random.default_rng(seed)
    H, conv_ch = KW["d_inner"] // KW["head_dim"], KW["d_inner"] + 2 * KW["d_state"]
    p = dict(p, conv_b=rng.normal(size=conv_ch).astype(np.float32) * 0.1,
             dt_bias_h=rng.normal(size=H).astype(np.float32) * 0.5,
             A_log_h=rng.normal(size=H).astype(np.float32) * 0.5,
             D_h=rng.normal(size=H).astype(np.float32),
             norm_scale=rng.normal(size=KW["d_inner"]).astype(np.float32) * 0.1)
    mod = Mamba2(Mamba2Config(**KW), CHUNK)
    named = dict(mod.named_parameters())
    assert sorted(named) == sorted(p)
    with torch.no_grad():
        for name, arr in p.items():
            named[name].copy_(torch.from_numpy(np.array(arr)))
    return jax.tree.map(jnp.asarray, p), mod


def _x(B, L, seed):
    return np.random.default_rng(seed).normal(size=(B, L, KW["d_model"])).astype(np.float32)


def _assert_cache(got: SSMCache, want) -> None:
    tail, state, length = want
    assert got.length == int(length)
    assert got.state.shape == (got.state.shape[0], 4, KW["d_state"], KW["head_dim"])
    torch.testing.assert_close(got.state, torch.from_numpy(np.array(state)), **TOL)
    torch.testing.assert_close(got.conv_tail, torch.from_numpy(np.array(tail)), **TOL)


@pytest.mark.parametrize("L", [19, 16])
def test_mamba2_block_matches_reference(L):
    """The forward and the cache after it, at a length the chunk of 8 does
    not divide (19: the padding path) and at one it does (16)."""
    p, mod = _block()
    x = _x(3, L, seed=L)
    want, want_cache = REF_BLOCK(p, jnp.asarray(x), cfg=RefMamba2Config(**KW),
                                 return_cache=True, chunk=CHUNK)
    before = common.launch_counts()
    with torch.no_grad():
        got, cache = mod.prefill(torch.from_numpy(x))
        fwd = mod(torch.from_numpy(x))
    assert common.launch_counts() == before  # no kernel: Mamba-2 is plain torch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(fwd, got)
    _assert_cache(cache, want_cache)


def test_mamba2_decode_matches_reference():
    """Six one-token steps from a prefilled cache (13 tokens: two chunks,
    the second padded), each step's output and cache against the
    reference's `mamba2_decode` from its own cache."""
    p, mod = _block(seed=5)
    cfg = RefMamba2Config(**KW)
    x = _x(2, 19, seed=9)
    _, ref_cache = REF_BLOCK(p, jnp.asarray(x[:, :13]), cfg=cfg, return_cache=True,
                             chunk=CHUNK)
    with torch.no_grad():
        _, cache = mod.prefill(torch.from_numpy(x[:, :13]))
        for t in range(13, 19):
            want, ref_cache = REF_DECODE(p, jnp.asarray(x[:, t:t + 1]), cfg=cfg,
                                         cache=ref_cache)
            got, cache = mod.decode(torch.from_numpy(x[:, t:t + 1]), cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            _assert_cache(cache, ref_cache)


def test_mamba2_cache_and_init_follow_the_reference():
    """The empty cache's shapes and dtypes, and the initial values:
    in_proj, conv_w and out_proj dense, the rest zero but D_h one."""
    want = jax.tree.map(np.asarray, ref_init_cache(RefMamba2Config(**KW), 3))
    got = init_mamba2_cache(Mamba2Config(**KW), 3)
    for a, b in zip(got[:2], want[:2]):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32 and not bool(a.any())
    assert got.length == 0
    wide = Mamba2(Mamba2Config(d_model=512, d_inner=1024, d_state=64, head_dim=64),
                  CHUNK).requires_grad_(False)
    gen = torch.Generator()
    gen.manual_seed(0)
    wide.reset_parameters(gen)
    for name in ("in_proj", "conv_w", "out_proj"):
        w = getattr(wide, name)
        assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.05, name
    for name in ("conv_b", "dt_bias_h", "A_log_h", "norm_scale"):
        assert not bool(getattr(wide, name).any()), name
    assert bool((wide.D_h == 1).all())


def _over(got: np.ndarray, want: np.ndarray, tol: dict) -> float:
    """The largest |got - want| over its allclose bound."""
    return float((np.abs(got - want) / (tol["atol"] + tol["rtol"] * np.abs(want))).max())


def test_zamba_tol_covers_half_an_ulp_of_the_weights():
    """The reference's forward at the smoke config with every weight
    multiplied by 1 + s 2^-24, s in {-1, 0, 1} at random (no more than a
    rounding of each weight; three draws), against the unmoved one, on the
    forward test's tokens: within half of ZAMBA_TOL."""
    ref_cfg = REF_ARCHS["zamba2-7b"].smoke()
    params = ref_api.init_model(jax.random.key(0), ref_cfg)
    fwd = jax.jit(lambda p, t: ref_lm.forward(p, t, ref_cfg)[0])
    toks = jnp.asarray(np.random.default_rng(5).integers(0, ref_cfg.vocab, (3, 21)))
    base = np.asarray(fwd(params, toks))
    rng = np.random.default_rng(0)
    for _ in range(3):
        moved = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) * (
            1 + rng.choice([-1, 0, 1], size=a.shape) * 2.0 ** -24).astype(np.float32)), params)
        assert _over(np.asarray(fwd(moved, toks)), base, ZAMBA_TOL) <= 0.5


def _zamba():
    ref_cfg, cfg = REF_ARCHS["zamba2-7b"].smoke(), ARCHS["zamba2-7b"].smoke()
    params = jax.tree.map(np.asarray, ref_api.init_model(jax.random.key(0), ref_cfg))
    return cfg, params, params_from_reference(cfg, params, "cpu")


def test_the_shared_block_is_one():
    """The reference's one `shared` block fills the LM's `shared`; its
    places in the layer order (one a repeat) run those very tensors; the
    state dict and the parameter count hold them once."""
    cfg, params, model = _zamba()
    assert param_count(model) == ref_api.param_count(params)
    places = [i for i, layer in enumerate(model.layers) if isinstance(layer, SharedPlace)]
    assert places == [r * len(cfg.pattern) + cfg.pattern.index("shared_attn")
                      for r in range(cfg.repeats)]
    assert all(model.layers[i].kind == "shared_attn" for i in places)
    shared = dict(model.shared.named_parameters())
    for name, t in shared.items():
        want = params["shared"]
        for key in name.split("."):
            want = want[key]
        assert np.array_equal(t.numpy(), want), name
        ptrs = {model.layers[i].block.get_parameter(name).data_ptr() for i in places}
        assert ptrs == {t.data_ptr()}, name
    state = model.state_dict()
    assert sorted(k[len("shared."):] for k in state if k.startswith("shared.")) == sorted(shared)
    assert not any(k.startswith(f"layers.{i}.") for k in state for i in places)
    ptrs = [t.data_ptr() for t in state.values()]
    assert len(set(ptrs)) == len(ptrs)
    # a deep copy keeps one block behind every place
    twin = copy.deepcopy(model)
    assert all(twin.layers[i].block is twin.shared for i in places)
    assert twin.shared is not model.shared


def test_shared_places_keep_a_cache_each():
    """Each application of the shared block keeps its own KV cache: after
    prefill the places' caches differ (they saw different inputs)."""
    cfg, _, model = _zamba()
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 10))
    _, caches = prefill(model, {"tokens": toks}, 12)
    kv = [caches[i] for i, layer in enumerate(model.layers) if isinstance(layer, SharedPlace)]
    assert len(kv) == cfg.repeats and kv[0].k.data_ptr() != kv[1].k.data_ptr()
    assert not torch.equal(kv[0].k, kv[1].k)


def test_param_count_at_full_width_equals_the_reference():
    """zamba2-7b at full width and depth, counted without storage (the
    port's LM on the meta device, the reference's `jax.eval_shape`):
    5,622,728,000, the shared block counted once."""
    cfg, ref_cfg = ARCHS["zamba2-7b"], REF_ARCHS["zamba2-7b"]
    shapes = jax.eval_shape(lambda k: ref_api.init_model(k, ref_cfg), jax.random.key(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    model = LM(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == want == 5_622_728_000
    assert sum(p.numel() for p in model.shared.parameters()) == 205_528_064


def test_init_model_draws_the_shared_block_once():
    cfg = ARCHS["zamba2-7b"].smoke()
    model = init_model(cfg, seed=2, device="cpu")
    again = init_model(cfg, seed=2, device="cpu")
    assert torch.equal(model.shared.attn.wq, again.shared.attn.wq)
    wq = model.shared.attn.wq
    assert float(wq.std()) > 0 and float(model.shared.ln1_scale.abs().max()) == 0.0
    ssm = model.layers[0].ssm
    assert bool((ssm.D_h == 1).all()) and not bool(ssm.A_log_h.any())
