"""The port's checkpoint manager (`repro_torch.checkpoint`) on the CPU: round
trip, keep-K, the async write, a leftover `.tmp` never read, the data
step in meta, and interchange with the reference's manager both ways --
a tree of arrays, and a whole train state (parameters stacked as the
reference stacks them, m, v, step) of gemma-2b, zamba2-7b (whose shared
block's pattern slot is empty in the reference's tree) and whisper-tiny
(encoder and decoder stacked over layers).  Every restored value equals
the saved one bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_train_cases import batch, configs, leaves, ref_state, ref_step

from repro.checkpoint import CheckpointManager as RefManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models import init_model
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(2)


def _tree(scale):
    return {"a": torch.arange(6.0).reshape(2, 3) * scale,
            "b": {"c": torch.ones(4) * scale, "d": torch.tensor(3, dtype=torch.int32)},
            "e": (torch.zeros(2, 2) + scale, None)}


def test_roundtrip_keep_k_and_meta(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (10, 20, 30):
        mgr.save(s, _tree(float(s)), extra={"data": {"step": s}})
    assert mgr.steps() == [20, 30] and mgr.latest_step() == 30
    restored, meta = mgr.restore(_tree(0.0))
    assert meta["step"] == 30 and meta["extra"]["data"]["step"] == 30
    want = jax.tree_util.tree_leaves(_tree(30.0))
    for got, w in zip(jax.tree_util.tree_leaves(restored), want):
        assert torch.equal(got, w)
    assert restored["e"][1] is None
    old, _ = mgr.restore(_tree(0.0), step=20)
    assert torch.equal(old["a"], _tree(20.0)["a"])
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"a": torch.zeros(1)})


def test_async_write_and_leftover_tmp_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    t = {"w": torch.ones((128, 128))}
    mgr.save(1, t, blocking=False)
    t["w"] += 1.0  # the snapshot was taken at save(): a later in-place update is not in it
    mgr.wait()
    assert mgr.latest_step() == 1
    (tmp_path / "step_7.tmp").mkdir()  # a writer preempted mid-write
    (tmp_path / "step_7.tmp" / "arrays.npz").write_bytes(b"torn")
    assert mgr.steps() == [1]
    restored, _ = mgr.restore({"w": torch.zeros((128, 128))})
    assert torch.equal(restored["w"], torch.ones((128, 128)))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(t)


def test_tree_interchange_with_the_reference(tmp_path):
    tree = {"x": np.arange(12.0, dtype=np.float32).reshape(3, 4), "y": {"z": np.int32(5)}}
    RefManager(tmp_path / "ref").save(3, tree, extra={"data": {"step": 3}})
    mine, meta = CheckpointManager(tmp_path / "ref").restore(
        {"x": torch.zeros(3, 4), "y": {"z": torch.tensor(0)}})
    assert meta["extra"]["data"]["step"] == 3
    np.testing.assert_array_equal(mine["x"].numpy(), tree["x"])
    CheckpointManager(tmp_path / "port").save(4, {k: v for k, v in mine.items()})
    theirs, _ = RefManager(tmp_path / "port").restore(tree)
    np.testing.assert_array_equal(np.asarray(theirs["x"]), tree["x"])
    assert int(theirs["y"]["z"]) == 5


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-7b", "whisper-tiny"])
def test_train_state_interchange_both_ways(arch, tmp_path):
    ref_cfg, cfg = configs(arch)
    rs, _ = ref_step(ref_cfg, ref_state(ref_cfg), batch(cfg), compute_dtype=jnp.float32)
    # the reference writes, the port restores
    RefManager(tmp_path / "ref").save(1, rs, extra={"data": {"step": 1}})
    like = init_train_state(cfg, seed=5, device="cpu")
    mine, meta = CheckpointManager(tmp_path / "ref").restore(like)
    assert meta["step"] == 1
    want = leaves(rs)
    got = leaves(mine)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the port writes (after a step of its own), the reference restores
    mine, _ = make_train_step(cfg, lambda s: 1e-3, compute_dtype=torch.float32)(
        mine, batch(cfg, step=1))
    CheckpointManager(tmp_path / "port").save(2, mine, extra={"data": {"step": 2}})
    theirs, meta = RefManager(tmp_path / "port").restore(rs)
    assert meta["step"] == 2
    for a, b in zip(leaves(theirs), leaves(mine)):
        np.testing.assert_array_equal(a, b)
    # a served model reads only the parameters
    model = init_model(cfg, seed=9, device="cpu")
    CheckpointManager(tmp_path / "port").restore_model(model)
    for (name, p), (_, q) in zip(model.named_parameters(), mine.model.named_parameters()):
        assert torch.equal(p, q), name


def test_bf16_moments_round_trip(tmp_path):
    _, cfg = configs("gemma-2b")
    st = init_train_state(cfg, seed=0, device="cpu", opt_dtype=torch.bfloat16)
    st, _ = make_train_step(cfg, lambda s: 1e-3)(st, batch(cfg))
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, st)
    back, _ = mgr.restore(init_train_state(cfg, seed=1, device="cpu",
                                           opt_dtype=torch.bfloat16))
    for name in st.opt.m:
        assert back.opt.m[name].dtype == torch.bfloat16
        assert torch.equal(back.opt.m[name], st.opt.m[name])
        assert torch.equal(back.opt.v[name], st.opt.v[name])
    assert int(back.opt.step) == 1
