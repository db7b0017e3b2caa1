"""Port parity for the model substrate (`repro_torch.models`, `.configs`):
the reference's weights are carried across (`params_from_reference`, or the
same arrays set on one block), the same numpy inputs go through both, and
the outputs agree within rtol 1e-4 / atol 1e-5 (float32 through a few
layers: matmul summation order, and the port's attention and scan run their
plain versions, which sum in another order than the reference's scans);
zamba2-7b's 13-layer smoke LM within ZAMBA_TOL (tests/test_torch_zamba.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import api as ref_api
from repro.models import lm as ref_lm
from repro.models.attention import AttnConfig as RefAttnConfig
from repro.models.attention import attention_block, init_attn
from repro.models.ffn import init_mlp, mlp_block
from repro.models.ssm import Mamba1Config as RefMamba1Config
from repro.models.ssm import init_mamba1, mamba1_block
from repro_torch.configs import ARCHS, ModelConfig
from repro_torch.kernels import common
from repro_torch.models import caches_from_reference, init_model, params_from_reference
from repro_torch.models.attention import Attention, AttnConfig
from repro_torch.models.blocks import Block
from repro_torch.models.ffn import MLP
from repro_torch.models.ssm import Mamba1, Mamba1Config
from test_torch_zamba import ZAMBA_TOL

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
PORTED = ("gemma-2b", "falcon-mamba-7b", "gemma2-9b", "qwen2-7b", "gemma3-1b",
          "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "zamba2-7b")


def _set(module: torch.nn.Module, params: dict) -> None:
    """Copy a reference parameter dict onto a module by name."""
    named = dict(module.named_parameters())
    assert sorted(named) == sorted(params)
    with torch.no_grad():
        for name, arr in params.items():
            named[name].copy_(torch.from_numpy(np.array(arr)))


def _x(B, S, D, seed=0):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(n_heads=4, n_kv=1, head_dim=16),                                   # MQA (gemma-2b)
    dict(n_heads=4, n_kv=2, head_dim=16, window=8, softcap=50.0),           # gemma2 local
    dict(n_heads=4, n_kv=4, head_dim=8, qkv_bias=True, rope_theta=1e6),     # bias, MHA
    dict(n_heads=2, n_kv=1, head_dim=16, causal=False, rope_theta=0.0),     # no rope
])
def test_attention_block_matches_reference(kw):
    ref_cfg = RefAttnConfig(d_model=32, **kw)
    p = init_attn(jax.random.key(1), ref_cfg)
    mod = Attention(AttnConfig(d_model=32, **kw))
    _set(mod, jax.tree.map(np.asarray, p))
    x = _x(2, 20, 32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    want = attention_block(p, jnp.asarray(x), ref_cfg, jnp.asarray(pos), kv_chunk=8)
    got = mod(torch.from_numpy(x), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("gated,activation", [(True, "gelu"), (True, "silu"), (False, "gelu")])
def test_mlp_block_matches_reference(gated, activation):
    p = init_mlp(jax.random.key(2), 32, 64, gated=gated)
    mod = MLP(32, 64, gated=gated, activation=activation)
    _set(mod, jax.tree.map(np.asarray, p))
    x = _x(2, 7, 32, seed=1)
    want = mlp_block(p, jnp.asarray(x), activation)
    got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("L", [19, 8])
def test_mamba1_block_matches_reference(fused, L):
    kw = dict(d_model=32, d_inner=64, d_state=16, dt_rank=8, d_conv=4)
    p = init_mamba1(jax.random.key(3), RefMamba1Config(**kw))
    # non-trivial biases and skip, so every parameter is exercised
    rng = np.random.default_rng(4)
    p = jax.tree.map(np.asarray, p)
    p = dict(p, conv_b=rng.normal(size=64).astype(np.float32) * 0.1,
             dt_bias=rng.normal(size=64).astype(np.float32) * 0.1,
             D=rng.normal(size=64).astype(np.float32))
    mod = Mamba1(Mamba1Config(**kw))
    _set(mod, p)
    x = _x(3, L, 32, seed=2)
    want = mamba1_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x), RefMamba1Config(**kw),
                        chunk=8, fused=fused)
    before = common.launch_counts()["ssm_scan"]
    got = mod(torch.from_numpy(x))
    assert common.launch_counts()["ssm_scan"] == before  # CPU: the plain scan
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_lm_forward_matches_reference(arch):
    ref_cfg = REF_ARCHS[arch].smoke()
    cfg = ARCHS[arch].smoke()
    params = ref_api.init_model(jax.random.key(0), ref_cfg)
    model = params_from_reference(cfg, jax.tree.map(np.asarray, params), "cpu")
    assert len(model.layers) == cfg.n_layers
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (3, 21)).astype(np.int32)
    want, _ = ref_lm.forward(params, jnp.asarray(toks), ref_cfg)
    got = model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(ZAMBA_TOL if arch == "zamba2-7b" else TOL))


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_and_smoke_equal_reference(arch, smoke):
    """Every architecture of the reference's registry is in the port's, equal
    field for field."""
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    ref, ours = REF_ARCHS[arch], ARCHS[arch]
    if smoke:
        ref, ours = ref.smoke(), ours.smoke()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.vocab_padded == ref.vocab_padded
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(type(ref))]


def test_unported_kinds_raise():
    cfg = ARCHS["gemma-2b"].smoke()
    with pytest.raises(ValueError, match="pattern"):
        dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)


def test_init_model_follows_the_reference_distributions():
    cfg = dataclasses.replace(ARCHS["gemma-2b"].smoke(), d_model=256, d_ff=512)
    model = init_model(cfg, seed=3, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    assert abs(float(model.embedding.std()) - 0.02) < 0.002
    wq = model.layers[0].attn.wq
    assert abs(float(wq.std()) * np.sqrt(wq.shape[0]) - 1.0) < 0.05
    assert float(model.layers[1].ln2_scale.abs().max()) == 0.0
    again = init_model(cfg, seed=3, device="cpu")
    assert torch.equal(again.layers[1].mlp.w_down, model.layers[1].mlp.w_down)
    m1 = init_model(ARCHS["falcon-mamba-7b"].smoke(), seed=0, device="cpu").layers[0].ssm
    assert torch.allclose(m1.A_log[5], torch.log(torch.arange(1, 17, dtype=torch.float32)))
    assert bool((m1.D == 1).all()) and bool((m1.dt_bias == 0).all())


def test_params_from_reference_rejects_a_wrong_shape():
    ref_cfg = REF_ARCHS["gemma-2b"].smoke()
    params = jax.tree.map(np.asarray, ref_api.init_model(jax.random.key(0), ref_cfg))
    params["final_norm"]["fn_scale"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="fn_scale"):
        params_from_reference(ARCHS["gemma-2b"].smoke(), params, "cpu")


def test_params_from_reference_carries_an_untied_head():
    ref_cfg, cfg = REF_ARCHS["qwen2-7b"].smoke(), ARCHS["qwen2-7b"].smoke()
    params = jax.tree.map(np.asarray, ref_api.init_model(jax.random.key(0), ref_cfg))
    model = params_from_reference(cfg, params, "cpu")
    assert model.lm_head is not None
    assert np.array_equal(model.lm_head.numpy(), params["head"]["lm_head"])
    x = np.random.default_rng(0).normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    want = ref_lm.unembed(ref_cfg, params, jnp.asarray(x))
    np.testing.assert_allclose(model.unembed(torch.from_numpy(x)).numpy(), np.asarray(want),
                               **TOL)
    params.pop("head")
    with pytest.raises(KeyError, match="lm_head"):
        params_from_reference(cfg, params, "cpu")


@pytest.mark.parametrize("key", ["shared", "head"])
def test_params_from_reference_rejects_a_key_it_does_not_read(key):
    """A top-level key the port does not read (zamba's `shared`), or a head
    on a model whose embeddings are tied, is an error, not a silent drop."""
    ref_cfg = REF_ARCHS["gemma-2b"].smoke()
    params = jax.tree.map(np.asarray, ref_api.init_model(jax.random.key(0), ref_cfg))
    params[key] = {"lm_head": np.zeros((ref_cfg.d_model, ref_cfg.vocab_padded), np.float32)}
    with pytest.raises(KeyError, match="shared" if key == "shared" else "no place"):
        params_from_reference(ARCHS["gemma-2b"].smoke(), params, "cpu")


def test_caches_from_reference_follows_the_layer_order():
    """gemma3-1b's smoke pattern (6 slots x 2 repeats, then a tail block):
    port cache r * 6 + j is the reference's slot j at repeat r, then the
    tail's; each tagged here by its layer number."""
    ref_cfg, cfg = REF_ARCHS["gemma3-1b"].smoke(), ARCHS["gemma3-1b"].smoke()
    caches = jax.tree.map(np.asarray, ref_api.init_caches(ref_cfg, 1, 4))
    n_pat = len(cfg.pattern)
    for j in range(n_pat):
        k, v, _ = caches["pattern"][f"slot{j}"]
        tags = np.arange(cfg.repeats, dtype=np.float32) * n_pat + j
        caches["pattern"][f"slot{j}"] = (k + tags[:, None, None, None, None], v,
                                         np.arange(cfg.repeats, dtype=np.int32) + 5)
    k, v, _ = caches["tail"]["tail0"]
    caches["tail"]["tail0"] = (k + cfg.repeats * n_pat, v, np.int32(9))
    got = caches_from_reference(cfg, caches, "cpu")
    assert [float(c.k[0, 0, 0, 0]) for c in got] == list(range(cfg.n_layers))
    assert [c.length for c in got] == [5 + i // n_pat for i in range(cfg.n_layers - 1)] + [9]
    assert all(c.k.dtype == torch.bfloat16 for c in got)


def test_attn_kinds_are_the_references_minus_the_unported():
    """Every block kind of the reference is ported: the attention kinds are
    the reference's, and the moe, m2 and shared_attn blocks hold what the
    reference's do."""
    from repro.models.blocks import ATTN_KINDS as REF_ATTN_KINDS
    from repro_torch.models.blocks import ATTN_KINDS

    assert ATTN_KINDS == REF_ATTN_KINDS
    block = Block("moe", ARCHS["qwen3-moe-235b-a22b"].smoke())
    assert hasattr(block, "moe") and not hasattr(block, "mlp")
    zamba = ARCHS["zamba2-7b"].smoke()
    block = Block("shared_attn", zamba)
    assert hasattr(block, "attn") and hasattr(block, "mlp") and block.attn.cfg.window == 0
    assert type(Block("m2", zamba).ssm).__name__ == "Mamba2"


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"])
def test_params_from_reference_carries_the_moe_tensors(arch):
    """Every MoE tensor of every MoE layer, the shared expert's too, from
    the stacked pattern slot at its repeat; a key the port does not read
    inside the MoE subtree is refused."""
    ref_cfg, cfg = REF_ARCHS[arch].smoke(), ARCHS[arch].smoke()
    params = jax.tree.map(np.asarray, ref_api.init_model(jax.random.key(0), ref_cfg))
    model = params_from_reference(cfg, params, "cpu")
    n_pat, seen = len(cfg.pattern), 0
    for i, layer in enumerate(model.layers):
        if layer.kind != "moe":
            continue
        ref = params["pattern"][f"slot{i % n_pat}"]["moe"]
        names = ["router", "e_gate", "e_up", "e_down"]
        if cfg.shared_expert_ff:
            names += [f"shared.{w}" for w in ("w_gate", "w_up", "w_down")]
        for name in names:
            want = ref["shared"][name[7:]] if name.startswith("shared.") else ref[name]
            got = layer.moe.get_parameter(name)
            assert np.array_equal(got.numpy(), want[i // n_pat]), name
            seen += 1
    assert seen == len(names) * cfg.repeats
    slot = next(j for j, kind in enumerate(cfg.pattern) if kind == "moe")
    params["pattern"][f"slot{slot}"]["moe"]["e_bias"] = np.zeros((cfg.repeats, 8), np.float32)
    with pytest.raises(KeyError, match="no place"):
        params_from_reference(cfg, params, "cpu")
