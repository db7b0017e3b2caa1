"""The port's sharding specs (`repro_torch.sharding`, `launch.shardings`)
against the reference's (`repro.sharding`, `repro.launch.shardings`), and
its meshes (`launch.mesh`) and the train launcher's `--mesh`, on the CPU:

  * for every architecture at full size, on the (16, 16) and (2, 16, 16)
    production meshes (jax's AbstractMesh, the port's `AbstractMesh`): each
    port parameter's spec, each `state_specs` leaf, `batch_specs` of every
    shape cell's `input_specs` (their shapes and dtypes too), and
    `cache_specs` at batch 128 and 1 equal the reference's, a port leaf's
    spec being the reference leaf's without the dim the reference stacks
    (port parameters on the meta device, the reference's through
    `jax.eval_shape`);
  * `to_placements`, `local_shape`, `with_logical_constraint` without a
    mesh or on a plain tensor;
  * the meshes: a fake production mesh, a debug mesh over gloo; a fake
    group never under a real one and the reverse; a mesh larger than the
    group raises; a kernel wrapper on real multi-rank DTensor shards raises;
  * `launch.train --mesh 1x1` on gloo (world size 1) loses bit for bit
    what it loses without a mesh; `--mesh 2x1` raises; an MoE model under
    a mesh raises NotImplementedError citing A9b."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as RefAbstractMesh

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import input_specs as ref_input_specs
from repro.launch import shardings as ref_shardings
from repro.models import api as ref_api
from repro.sharding import param_specs as ref_param_specs
from repro.train.step import init_train_state as ref_init_train_state
from repro_torch.configs import ARCHS, SHAPES, cell_applicable, input_specs
from repro_torch.launch import shardings
from repro_torch.launch.dryrun import decode_caches
from repro_torch.models.convert import _layer_sources, reference_path
from repro_torch.models.lm import LM
from repro_torch.models.whisper import Whisper
from repro_torch.sharding import (AbstractMesh, P, param_specs, shard_ctx, to_placements,
                                  with_logical_constraint)
from repro_torch.sharding.specs import local_shape
from repro_torch.train.step import TrainState

torch.set_num_threads(2)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def meshes(name):
    shape, names = MESHES[name]
    return RefAbstractMesh(shape, names), AbstractMesh(shape, names)


def _tree_get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _meta_model(cfg):
    return (Whisper if cfg.enc_dec else LM)(cfg, device="meta")


def _check_param_specs(cfg, mine: dict, ref_tree) -> int:
    n = 0
    for name, spec in mine.items():
        path, r = reference_path(cfg, name)
        want = tuple(_tree_get(ref_tree, path))
        assert tuple(spec) == (want[1:] if r is not None else want), name
        n += 1
    return n


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_state_specs_equal_reference(arch, mesh):
    ref_mesh, my_mesh = meshes(mesh)
    cfg, ref_cfg = ARCHS[arch], REF_ARCHS[arch]
    model = _meta_model(cfg)
    named = dict(model.named_parameters())
    ref_params = jax.eval_shape(lambda k: ref_api.init_model(k, ref_cfg), jax.random.key(0))
    assert _check_param_specs(cfg, param_specs(cfg, named, my_mesh),
                              ref_param_specs(ref_params, ref_mesh)) == len(named)
    ref_state = jax.eval_shape(lambda k: ref_init_train_state(k, ref_cfg), jax.random.key(0))
    ref_st = ref_shardings.state_specs(ref_state, ref_mesh)
    mine = shardings.state_specs(TrainState(model, None), my_mesh)
    _check_param_specs(cfg, mine.model, ref_st.params)
    _check_param_specs(cfg, mine.opt.m, ref_st.opt.m)
    _check_param_specs(cfg, mine.opt.v, ref_st.opt.v)
    assert tuple(mine.opt.step) == tuple(ref_st.opt.step) == ()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_specs_equal_reference(arch, mesh):
    ref_mesh, my_mesh = meshes(mesh)
    for shape in SHAPES:
        ref_batch = ref_input_specs(REF_ARCHS[arch], shape)
        batch = input_specs(ARCHS[arch], shape)
        assert list(batch) == list(ref_batch)
        for k, t in batch.items():
            assert tuple(t.shape) == tuple(ref_batch[k].shape), (shape, k)
            assert str(t.dtype).removeprefix("torch.") == str(ref_batch[k].dtype), (shape, k)
        want = ref_shardings.batch_specs(ref_batch, ref_mesh)
        got = shardings.batch_specs(batch, my_mesh)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


def test_cell_applicability_equals_reference():
    from repro.configs import cell_applicable as ref_cell_applicable

    for arch in ARCHS:
        for shape in SHAPES:
            assert cell_applicable(ARCHS[arch], shape) == \
                ref_cell_applicable(REF_ARCHS[arch], shape)


def _ref_caches(arch: str, B: int, max_len: int, seq: int):
    ref_cfg = REF_ARCHS[arch]
    if ref_cfg.enc_dec:
        params = jax.eval_shape(lambda k: ref_api.init_model(k, ref_cfg), jax.random.key(0))
        pre = {"frames": jax.ShapeDtypeStruct((B, ref_cfg.n_audio_frames, ref_cfg.d_model),
                                              jax.numpy.float32),
               "tokens": jax.ShapeDtypeStruct((B, seq), jax.numpy.int32)}
        return jax.eval_shape(lambda p, b: ref_api.prefill(p, b, ref_cfg, max_len), params,
                              pre)[1]
    return jax.eval_shape(lambda: ref_api.init_caches(ref_cfg, B, max_len))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("B", [128, 1])
@pytest.mark.parametrize("arch", sorted(a for a in ARCHS if ARCHS[a].supports_decode))
def test_cache_specs_equal_reference(arch, B, mesh):
    ref_mesh, my_mesh = meshes(mesh)
    cfg = ARCHS[arch]
    seq = 512
    max_len = seq + 64
    ref = ref_shardings.cache_specs(_ref_caches(arch, B, max_len, seq), ref_mesh)
    mine = shardings.cache_specs(cfg, decode_caches(cfg, B, max_len, seq), my_mesh)
    if cfg.enc_dec:
        pairs = []
        for i, c in enumerate(mine.self_kv):
            pairs += [(c.k, ref["self"].k, i), (c.v, ref["self"].v, i)]
        pairs += [(t, ref["ck"], i) for i, t in enumerate(mine.ck)]
        pairs += [(t, ref["cv"], i) for i, t in enumerate(mine.cv)]
        for got, want, _ in pairs:
            assert tuple(got) == tuple(want)[1:]
        return
    for c, (tree, slot, r) in zip(mine, _layer_sources(cfg)):
        ref_c = ref[tree][slot]
        for field in c._fields:
            if field == "length":
                continue
            want = tuple(getattr(ref_c, field))
            assert tuple(getattr(c, field)) == (want[1:] if r is not None else want), \
                (tree, slot, field)


def test_to_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    spec = P(("pod", "data"), None, "model")
    assert to_placements(spec, mesh) == [Shard(0), Shard(0), Shard(2)]
    assert to_placements(P(None, None), mesh) == [Replicate()] * 3
    # whisper's vocab of 51,865 over 16: rank 0 holds ceil(51865 / 16) rows
    assert local_shape((51865, 384), P("model", None), mesh) == (3242, 384)
    assert local_shape((256, 4096), spec[:2], mesh) == (8, 4096)
    with pytest.raises(ValueError):
        to_placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError):
        to_placements(P("model", "model"), mesh)


def test_constraint_is_a_noop_without_a_mesh_or_on_a_plain_tensor():
    x = torch.randn(4, 8, 16)
    assert with_logical_constraint(x, "batch", "seq", None) is x
    with shard_ctx(AbstractMesh((16, 16), ("data", "model"))):
        assert with_logical_constraint(x, "batch", "seq", None) is x


# ---------------------------------------------------------------------------
# meshes and the launcher
# ---------------------------------------------------------------------------


@pytest.fixture
def no_group():
    import torch.distributed as dist

    from repro_torch.launch.mesh import release_fake_group

    assert not dist.is_initialized()
    yield
    release_fake_group()
    if dist.is_initialized():
        dist.destroy_process_group()


def test_fake_mesh_and_debug_mesh(no_group):
    import torch.distributed as dist

    from repro_torch.launch.mesh import (init_group, make_debug_mesh, make_fake_mesh,
                                         make_production_mesh, release_fake_group)

    mesh = make_production_mesh(multi_pod=True)
    assert mesh.mesh_dim_names == ("pod", "data", "model") and mesh.size() == 512
    assert make_production_mesh().shape == (16, 16)
    assert dist.get_world_size() == 256
    with pytest.raises(RuntimeError, match="fake"):
        make_debug_mesh(1, 1)
    release_fake_group()
    assert not dist.is_initialized()
    init_group(torch.device("cpu"))
    try:
        assert dist.get_backend() == "gloo"
        assert make_debug_mesh(1, 1).shape == (1, 1)
        with pytest.raises(RuntimeError, match="need 2 ranks"):
            make_debug_mesh(2, 1)
        with pytest.raises(RuntimeError, match="gloo"):
            make_fake_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def test_kernel_wrapper_refuses_real_multi_rank_shards(no_group):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.launch.mesh import make_fake_mesh

    mesh = make_fake_mesh((2, 4), ("data", "model"))

    def placed(t, placements):
        return DTensor.from_local(t, mesh, placements, run_check=False)

    q = placed(torch.randn(2, 8, 4, 16), [Shard(0), Shard(1)])
    k = placed(torch.randn(2, 32, 1, 16), [Shard(0), Replicate()])
    with pytest.raises(NotImplementedError, match="A9b"):
        flash_attention(q, k, k)
    dt = placed(torch.rand(2, 8, 16), [Shard(0), Shard(2)])
    bc = placed(torch.randn(2, 8, 4), [Shard(0), Replicate()])
    a = placed(-torch.rand(16, 4), [Replicate(), Shard(0)])
    h0 = placed(torch.zeros(2, 16, 4), [Shard(0), Shard(1)])
    with pytest.raises(NotImplementedError, match="A9b"):
        ssm_scan(dt, dt, bc, bc, a, h0)


def test_train_mesh_1x1_bit_for_bit_and_larger_mesh_raises(tmp_path, no_group):
    from repro_torch.launch import train

    base = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--steps", "3",
            "--ckpt-every", "100"]
    a = train.main([*base, "--ckpt-dir", str(tmp_path / "a")])
    b = train.main([*base, "--ckpt-dir", str(tmp_path / "b"), "--mesh", "1x1"])
    assert [h["loss"] for h in a["history"]] == [h["loss"] for h in b["history"]]
    assert np.float64(a["final_loss"]).tobytes() == np.float64(b["final_loss"]).tobytes()
    with pytest.raises(RuntimeError, match="need 2 ranks"):
        train.main([*base, "--ckpt-dir", str(tmp_path / "c"), "--mesh", "2x1"])


def test_moe_under_a_mesh_raises(tmp_path, no_group):
    from repro_torch.launch import train

    with pytest.raises(NotImplementedError, match="A9b"):
        train.main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu", "--steps",
                    "1", "--ckpt-dir", str(tmp_path), "--mesh", "1x1"])
