"""Port hygiene: `repro_torch` (and chip_smoke.py) never import JAX or the
reference package -- neither the index path, nor the serving engine, nor the
serve CLI, synchronous or behind the async router with its metrics
endpoint, nor the LM's loss, prefill and decode, nor the train CLI and
its trainer --, entry points default to CUDA and refuse to fall back to the
CPU, the serve CLI restores what the train CLI wrote, and the kernel loader
fails clearly without nvcc."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import LCCSIndex
from repro_torch.kernels import common

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
# the caller's own HOME and TMPDIR, so no run points at a shared fixed path
ENV = {**{k: os.environ[k] for k in ("HOME", "TMPDIR") if k in os.environ},
       "PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\.|import repro\s*$|"
                       r"from repro |from repro\.)", re.M)


def test_cpu_build_and_search_loads_no_jax_or_reference():
    code = """
import sys
import numpy as np
import torch
torch.set_num_threads(2)
import repro_torch
from repro_torch import LCCSIndex, SearchParams
from repro_torch.data import clustered_vectors
X = clustered_vectors(800, 16, n_clusters=8, seed=0)
for store in ("fp32", "int8"):
    idx = LCCSIndex.build(X, m=8, family="euclidean", w=4.0, store=store, device="cpu")
    for source in ("lccs", "multiprobe-skip"):
        ids, _ = idx.search(X[:4], SearchParams(k=3, lam=32, width=32, source=source, probes=5))
        assert ids.shape == (4, 3)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("arch", ["gemma-2b", "falcon-mamba-7b"])
def test_cpu_engine_build_and_serve_loads_no_jax_or_reference(arch):
    code = f"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from repro_torch.configs import ARCHS
from repro_torch.data import lm_token_batches
from repro_torch.models import init_model
from repro_torch.serve import RetrievalEngine
cfg = ARCHS[{arch!r}].smoke()
eng = RetrievalEngine(cfg, init_model(cfg, device="cpu"), m=8, max_batch=8, device="cpu")
corpus, _ = lm_token_batches(cfg.vocab, seed=0)(0, 24, 16)
eng.build_index(corpus, dynamic=True)
out = eng.serve_stream([corpus[0], ("insert", corpus[:2]), ("delete", [1]), ("compact",),
                        corpus[2]])
assert len(out) == 5 and out[0][0].shape == (5,)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_serve_cli_loads_no_jax_or_reference():
    code = """
import runpy
import sys
sys.argv = ["serve", "--arch", "gemma-2b", "--smoke", "--device", "cpu", "--corpus", "32",
            "--requests", "8", "--m", "8", "--dynamic"]
runpy.run_module("repro_torch.launch.serve", run_name="__main__")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr
    assert "self-retrieval" in out.stdout and "churn" in out.stdout, out.stdout
    assert "BAD []" in out.stdout, out.stdout


def test_async_serve_cli_loads_no_jax_or_reference():
    code = """
import runpy
import sys
sys.argv = ["serve", "--arch", "gemma-2b", "--smoke", "--device", "cpu", "--corpus", "32",
            "--requests", "16", "--m", "8", "--async", "--replicas", "2", "--instrument",
            "--metrics-port", "0", "--drift-probe", "4"]
runpy.run_module("repro_torch.launch.serve", run_name="__main__")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr
    assert "async: 16 completed" in out.stdout and "metrics on" in out.stdout, out.stdout
    assert "recall-drift probe" in out.stdout, out.stdout
    assert "BAD []" in out.stdout, out.stdout


def test_no_source_file_imports_jax_or_reference():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py")))
    assert len(files) > 20
    offenders = [str(f) for f in files if FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_build_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to CUDA")
    X = np.zeros((10, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LCCSIndex.build(X, m=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LCCSIndex.build(X, m=4, device="cuda")


def test_out_of_core_and_sharded_paths_load_no_jax_or_reference():
    code = """
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from repro_torch import LCCSIndex, SearchParams, SegmentedLCCSIndex
from repro_torch.core.index import iter_row_blocks
from repro_torch.data import clustered_vector_chunks
from repro_torch.shard import ShardedLCCSIndex
X = np.concatenate(list(clustered_vector_chunks(600, 16, chunk_rows=200, n_clusters=8)))
idx = LCCSIndex.build(X, m=8, family="euclidean", w=4.0, store="int8", chunk_rows=256,
                      device="cpu")
dyn = SegmentedLCCSIndex.create(16, m=8, family="euclidean", w=4.0, device="cpu")
dyn.ingest_chunks(iter_row_blocks(X, 256))
sh = idx.shard(3)
p = SearchParams(k=3, lam=32, width=32)
for index in (idx, dyn, sh, ShardedLCCSIndex.build(X, shards=2, m=8, device="cpu")):
    assert index.search(X[:4], p)[0].shape == (4, 3)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_out_of_core_and_sharded_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to CUDA")
    from repro_torch import SegmentedLCCSIndex
    from repro_torch.core.csa import build_csa_chunked
    from repro_torch.shard import ShardedLCCSIndex

    X = np.zeros((10, 4), np.float32)
    h = np.zeros((10, 4), np.int32)
    for call in (lambda: LCCSIndex.build(X, m=4, chunk_rows=4),
                 lambda: LCCSIndex.build_streaming(iter([X]), m=4),
                 lambda: ShardedLCCSIndex.build(X, shards=2, m=4),
                 lambda: build_csa_chunked(h, chunk_rows=4),
                 lambda: SegmentedLCCSIndex.create(4, m=4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_model_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to CUDA")
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_model, params_from_reference

    cfg = ARCHS["gemma-2b"].smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_reference(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_reference(cfg, {}, device="cuda")


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma3-1b", "falcon-mamba-7b"])
def test_cpu_loss_prefill_and_decode_load_no_jax_or_reference(arch):
    code = f"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from repro_torch.configs import ARCHS
from repro_torch.models import decode_step, init_caches, init_model, loss_fn, prefill
cfg = ARCHS[{arch!r}].smoke()
model = init_model(cfg, seed=0, device="cpu")
toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 20))
loss, _ = loss_fn(model, {{"tokens": toks, "labels": toks}})
assert bool(torch.isfinite(loss))
logits, caches = prefill(model, {{"tokens": toks}}, 24)
for _ in range(3):
    logits, caches = decode_step(model, logits.argmax(-1, keepdim=True), caches)
assert logits.shape == (2, cfg.vocab_padded) and caches[0].length == 23
assert len(init_caches(cfg, 2, 24, device="cpu")) == cfg.n_layers
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-tiny"])
def test_cpu_vlm_and_whisper_load_no_jax_or_reference(arch):
    code = f"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from repro_torch.configs import ARCHS
from repro_torch.models import decode_step, init_model, loss_fn, prefill
cfg = ARCHS[{arch!r}].smoke()
model = init_model(cfg, seed=0, device="cpu")
rng = np.random.default_rng(0)
toks = rng.integers(0, cfg.vocab, (2, 12))
if cfg.vlm:
    batch = {{"tokens": toks, "patch_embeds": rng.normal(size=(2, cfg.n_patches, cfg.d_model))}}
    labels = rng.integers(0, cfg.vocab, (2, cfg.n_patches + 12))
else:
    batch = {{"tokens": toks, "frames": rng.normal(size=(2, cfg.n_audio_frames, cfg.d_model))}}
    labels = toks
loss, _ = loss_fn(model, dict(batch, labels=labels))
assert bool(torch.isfinite(loss))
logits, caches = prefill(model, batch, 32)
for _ in range(3):
    logits, caches = decode_step(model, logits.argmax(-1, keepdim=True), caches)
assert logits.shape == (2, cfg.vocab_padded) and bool(torch.isfinite(logits).all())
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_decode_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to CUDA")
    from repro_torch.configs import ARCHS
    from repro_torch.models import caches_from_reference, init_caches

    cfg = ARCHS["qwen2-7b"].smoke()
    for call in (lambda: init_caches(cfg, 1, 8), lambda: init_caches(cfg, 1, 8, device="cuda"),
                 lambda: caches_from_reference(cfg, {})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_train_cli_and_trainer_load_no_jax_or_reference(tmp_path):
    """`launch.train --device cpu --smoke --dedup` (the Trainer, the
    pipeline with the near-dup filter, the train step, AdamW and the
    checkpoint manager) loads neither JAX nor the reference package."""
    code = f"""
import sys
import torch
torch.set_num_threads(2)
from repro_torch.launch.train import main
out = main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--steps", "3",
            "--global-batch", "4", "--seq-len", "16", "--ckpt-every", "2", "--dedup",
            "--ckpt-dir", {str(tmp_path / "ck")!r}])
assert out["final_step"] == 3
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr
    assert "[launch.train] gemma-2b: step=3" in out.stdout, out.stdout
    assert "BAD []" in out.stdout, out.stdout


def test_train_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to CUDA")
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataPipeline, lm_token_batches
    from repro_torch.data.dedup import NearDupFilter
    from repro_torch.launch.train import main
    from repro_torch.train import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = ARCHS["gemma-2b"].smoke()
    pipe = DataPipeline(lm_token_batches(cfg.vocab), global_batch=2, seq_len=8)
    tcfg = TrainerConfig(steps=1, ckpt_dir=str(tmp_path / "ck"))
    for call in (lambda: init_train_state(cfg), lambda: init_train_state(cfg, 0, "cuda"),
                 lambda: Trainer(cfg, pipe, tcfg), lambda: NearDupFilter(),
                 lambda: main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path / "c")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # --mesh is ported (A12): a mesh of more ranks than the one-rank group raises
    with pytest.raises(RuntimeError, match="need 2 ranks"):
        main(["--smoke", "--device", "cpu", "--mesh", "2x1", "--ckpt-dir", str(tmp_path / "m")])


def test_serve_restores_what_train_wrote(tmp_path):
    """`launch.serve --ckpt-dir` on the CPU serves the latest step that
    `launch.train --device cpu` wrote there, and says so."""
    ck = str(tmp_path / "ck")
    train = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gemma-2b", "--smoke",
         "--device", "cpu", "--steps", "4", "--ckpt-every", "3", "--global-batch", "4",
         "--seq-len", "16", "--ckpt-dir", ck], capture_output=True, text=True, timeout=300,
        env=ENV)
    assert train.returncode == 0, train.stderr
    serve = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma-2b", "--smoke",
         "--device", "cpu", "--corpus", "32", "--requests", "8", "--m", "8", "--ckpt-dir", ck],
        capture_output=True, text=True, timeout=300, env=ENV)
    assert serve.returncode == 0, serve.stderr
    assert f"restored step 4 from {ck}" in serve.stdout, serve.stdout
    assert "self-retrieval" in serve.stdout, serve.stdout


def test_loader_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(common, "DEFAULT_NVCC", tmp_path / "missing" / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        common.build(build_dir=tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_kernel_argument_checker():
    t = torch.zeros((3, 4), dtype=torch.int32)
    common.check("t", t, device=t.device, dtype=torch.int32, shape=(3, 4))
    with pytest.raises(TypeError):
        common.check("t", t, device=t.device, dtype=torch.float32, shape=(3, 4))
    with pytest.raises(ValueError, match="shape"):
        common.check("t", t, device=t.device, dtype=torch.int32, shape=(4, 3))
    with pytest.raises(ValueError, match="contiguous"):
        common.check("t", t.t(), device=t.device, dtype=torch.int32, shape=(4, 3))
    with pytest.raises(ValueError, match="expected meta"):
        common.check("t", t, device=torch.device("meta"), dtype=torch.int32, shape=(3, 4))
