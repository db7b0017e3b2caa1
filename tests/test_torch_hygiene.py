"""Port hygiene: `repro_torch` (and chip_smoke.py) never import JAX or the
reference package, entry points default to CUDA and refuse to fall back to
the CPU, and the kernel loader fails clearly without nvcc."""
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
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "HOME": "/tmp"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_no_source_file_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
