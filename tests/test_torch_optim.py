"""The port's optimizer substrate (`repro_torch.optim`) against the
reference's (`repro.optim`), numpy inputs from a seed: AdamW over several
steps with float32 and bf16 moments, the global-norm clip, the cosine
schedule, int8 quantisation bit for bit, and `compress_psum_int8` in four
gloo processes against the reference's over four fake devices
(`tests/conftest.py:run_multidevice`).

Tolerances: AdamW's parameters and moments rtol 1e-5 / atol 1e-7 with
float32 moments (the same ops in the same order; XLA's and torch's
float32 pow, sqrt and division round alike or an ulp apart), and one bf16
ulp (2^-8 relative) with bf16 moments, where one ulp apart before the
rounding can round to neighbours; the schedule and the clip's norm rtol
1e-6; the int8 values and the all-reduced int32 sums exactly."""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import SRC, run_multidevice

from repro.optim import adamw as ref_adamw
from repro.optim import schedule as ref_schedule
from repro.optim.grad_compress import dequantize_int8 as ref_dequantize
from repro.optim.grad_compress import quantize_int8 as ref_quantize
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm, cosine_schedule,
                               dequantize_int8, quantize_int8)

torch.set_num_threads(2)

SHAPES = {"w": (6, 5), "b": (5,), "e": (3, 2, 4)}


def _tree(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_matches_reference(state_dtype, weight_decay):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
    ref_s = ref_adamw.adamw_init(ref_p, getattr(jnp, state_dtype))
    p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    s = adamw_init(p, getattr(torch, state_dtype))
    tol = (dict(rtol=1e-5, atol=1e-7) if state_dtype == "float32"
           else dict(rtol=2 ** -8, atol=1e-7))
    for i in range(5):
        g = _tree(rng, 10.0 ** (i - 2))
        lr = 1e-3 * (i + 1)
        ref_p, ref_s = ref_adamw.adamw_update({k: jnp.asarray(v) for k, v in g.items()}, ref_s,
                                              ref_p, lr, weight_decay=weight_decay)
        p, s = adamw_update({k: torch.from_numpy(v) for k, v in g.items()}, s, p, lr,
                            weight_decay=weight_decay)
        assert int(s.step) == int(ref_s.step) == i + 1
        for k in SHAPES:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(ref_p[k]), **tol)
            for mine, theirs in ((s.m[k], ref_s.m[k]), (s.v[k], ref_s.v[k])):
                assert str(mine.dtype).endswith(state_dtype)
                np.testing.assert_allclose(mine.float().numpy(),
                                           np.asarray(theirs, np.float32), **tol)


def test_adamw_reduces_quadratic():
    """The reference's own sanity case, on the port."""
    params = {"w": torch.ones(8) * 5.0}
    state = adamw_init(params)
    for _ in range(200):
        params, state = adamw_update({"w": 2 * params["w"]}, state, params, lr=0.05,
                                     weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.5


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(1)
    g = _tree(rng, 3.0)
    ref, ref_norm = ref_adamw.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                                  max_norm)
    mine, norm = clip_by_global_norm({k: torch.from_numpy(v.copy()) for k, v in g.items()},
                                     max_norm)
    assert float(norm) == pytest.approx(float(ref_norm), rel=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(mine[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 7), (5, 5)])
def test_cosine_schedule_matches_reference(warmup, total):
    for step in (0, 1, warmup // 2, warmup, warmup + 1, (warmup + total) // 2, total, total + 3):
        want = float(ref_schedule.cosine_schedule(jnp.asarray(step), peak_lr=3e-4,
                                                  warmup=warmup, total=total))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = cosine_schedule(arg, peak_lr=3e-4, warmup=warmup, total=total)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), (step, arg)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4, 0.0])
def test_quantize_int8_is_the_reference_bit_for_bit(scale):
    g = (np.random.default_rng(2).normal(size=(37, 11)) * scale).astype(np.float32)
    g[0, :3] = [0.5, -0.5, 1.5]  # halves: round to even, as jnp.round
    q, s = quantize_int8(torch.from_numpy(g))
    rq, rs = ref_quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert np.float32(s) == np.float32(rs)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(ref_dequantize(rq, rs)))


N_DEV = 4
PSUM_SHAPES = {"a": (4, 16), "b": (33,), "c": (2, 3, 5)}


def _psum_inputs():
    rng = np.random.default_rng(3)
    grads = {k: rng.normal(size=(N_DEV, *s)).astype(np.float32) * (1 + i)
             for i, (k, s) in enumerate(PSUM_SHAPES.items())}
    errs = {k: (rng.normal(size=(N_DEV, *s)) * 0.01).astype(np.float32)
            for k, s in PSUM_SHAPES.items()}
    return grads, errs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


PORT_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.optim import compress_psum_int8
rank, world = int(sys.argv[1]), int(sys.argv[2])
port, inp, out = sys.argv[3:6]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=world)
z = np.load(inp)
names = sorted({k.split("/")[1] for k in z.files})
grads = {k: torch.from_numpy(z[f"g/{k}"][rank]) for k in names}
errs = {k: torch.from_numpy(z[f"e/{k}"][rank]) for k in names}
red, new_e = compress_psum_int8(grads, errs)
red2, new_e2 = compress_psum_int8(grads, new_e)  # a second step, on the feedback
np.savez(out, **{f"r/{k}": red[k].numpy() for k in names},
         **{f"e/{k}": new_e[k].numpy() for k in names},
         **{f"r2/{k}": red2[k].numpy() for k in names},
         **{f"e2/{k}": new_e2[k].numpy() for k in names})
dist.destroy_process_group()
"""


def test_compress_psum_int8_matches_reference_over_four_processes(tmp_path):
    """Four gloo processes (one a rank, as one process a device) against
    the reference's shard_map over four fake CPU devices, two steps (the
    second on the error feedback): every rank's reduced mean and residual
    equal (the same int8 values and int32 sums; rtol 1e-6 for the scale's
    product)."""
    grads, errs = _psum_inputs()
    inp = tmp_path / "in.npz"
    np.savez(inp, **{f"g/{k}": v for k, v in grads.items()},
             **{f"e/{k}": v for k, v in errs.items()})
    ref_out = run_multidevice(f"""
        import numpy as np, jax, jax.numpy as jnp, json
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P
        from repro.launch.mesh import make_debug_mesh
        from repro.optim import compress_psum_int8
        mesh = make_debug_mesh({N_DEV}, 1)
        z = np.load({str(inp)!r})
        names = sorted({{k.split("/")[1] for k in z.files}})
        g = {{k: jnp.asarray(z["g/" + k]) for k in names}}
        e = {{k: jnp.asarray(z["e/" + k]) for k in names}}
        spec = {{k: P("data") for k in names}}
        fn = shard_map(lambda a, b: compress_psum_int8(a, b, ("data",)), mesh=mesh,
                       in_specs=(spec, spec), out_specs=(spec, spec), check_rep=False)
        # shard_map hands each device a leading axis of 1: squeeze it back out
        red, new_e = fn({{k: v[:, None] for k, v in g.items()}},
                        {{k: v[:, None] for k, v in e.items()}})
        red2, new_e2 = fn({{k: v[:, None] for k, v in g.items()}}, new_e)
        out = {{}}
        for tag, t in (("r", red), ("e", new_e), ("r2", red2), ("e2", new_e2)):
            for k in names:
                out[tag + "/" + k] = np.asarray(t[k])[:, 0].tolist()
        print("OUT" + json.dumps(out))
    """, N_DEV)
    ref = json.loads(ref_out.split("OUT", 1)[1])
    port = _free_port()
    env = {**{k: os.environ[k] for k in ("HOME", "TMPDIR") if k in os.environ},
           "PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(PORT_WORKER), str(r),
                               str(N_DEV), str(port), str(inp), str(tmp_path / f"out{r}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(N_DEV)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    for r in range(N_DEV):
        z = np.load(tmp_path / f"out{r}.npz")
        for key in z.files:
            np.testing.assert_allclose(z[key], np.asarray(ref[key], np.float32)[r], rtol=1e-6,
                                       atol=1e-7, err_msg=f"rank {r} {key}")
    # every rank holds the same mean, close to the exact one
    z0 = np.load(tmp_path / "out0.npz")
    for k, g in grads.items():
        exact = (g + errs[k]).mean(0)
        assert np.linalg.norm(z0[f"r/{k}"] - exact) / np.linalg.norm(exact) < 0.02


def test_package_exports_match_reference():
    import repro.optim
    import repro_torch.optim

    assert set(repro.optim.__all__) <= set(repro_torch.optim.__all__)
    assert Path(repro_torch.optim.__file__).parent.name == "optim"
