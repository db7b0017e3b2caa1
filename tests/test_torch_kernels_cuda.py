"""On-card checks: each hand-written CUDA kernel against its plain PyTorch
version on the same CUDA tensors (csa_probe bit-identical; the gathers
within rtol 1e-5 / atol 1e-5, fp32 summation order).  They need a card and
skip without one; `python3 chip_smoke.py` is the authoritative on-card run."""
import numpy as np
import pytest
import torch

from repro_torch import LCCSIndex, SearchParams
from repro_torch.core.search import doubled
from repro_torch.exec import stages
from repro_torch.kernels import common
from repro_torch.kernels.csa_probe import csa_probe, csa_probe_plain
from repro_torch.kernels.gather_l2 import gather_dist_kernel, gather_dist_ref
from repro_torch.kernels.gather_q import gather_dist_q_kernel, gather_dist_q_ref
from repro_torch.store.stores import _quantize_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,m,width", [(5000, 16, 8), (777, 40, 64), (64, 64, 100)])
def test_csa_probe_kernel_bit_identical(dev, n, m, width):
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, 24)).astype(np.float32)
    idx = LCCSIndex.build(X, m=m, family="euclidean", w=4.0, device=dev)
    q = idx.family.hash(torch.from_numpy(X[:50] + 0.1).to(dev))
    q[0] = -10**6  # insertion at 0
    q[1] = 10**6   # insertion at n
    R = 3000
    shifts = torch.from_numpy(rng.integers(0, m, R).astype(np.int32)).to(dev)
    qidx = torch.from_numpy(rng.integers(0, 50, R).astype(np.int32)).to(dev)
    qidx[:2] = torch.tensor([0, 1], dtype=torch.int32)
    c = idx.csa
    before = common.launch_counts()["csa_probe"]
    ki, kl = csa_probe(c.I, c.L, c.Hd, doubled(q), shifts, qidx, width)
    torch.cuda.synchronize()
    assert common.launch_counts()["csa_probe"] == before + 1
    pi, pl = csa_probe_plain(c.I, c.L, c.Hd, doubled(q), shifts, qidx, width)
    assert torch.equal(ki, pi) and torch.equal(kl, pl)


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("d", [128, 13, 48])
def test_gather_kernels_match_plain(dev, metric, d):
    rng = np.random.default_rng(d)
    data = torch.from_numpy(rng.normal(size=(2000, d)).astype(np.float32)).to(dev)
    data[7] = 0.0
    ids = torch.from_numpy(rng.integers(-1, 2000, size=(33, 70)).astype(np.int32)).to(dev)
    ids[0, 0] = 7
    queries = torch.from_numpy(rng.normal(size=(33, d)).astype(np.float32)).to(dev)
    k = gather_dist_kernel(data, ids, queries, metric=metric)
    p = gather_dist_ref(data, ids, queries, metric=metric)
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    torch.testing.assert_close(k.nan_to_num(), p.nan_to_num(), rtol=1e-5, atol=1e-5)
    codes, scale = _quantize_rows(data)
    k = gather_dist_q_kernel(codes, scale, ids, queries, metric=metric)
    p = gather_dist_q_ref(codes, scale, ids, queries, metric=metric)
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    torch.testing.assert_close(k.nan_to_num(), p.nan_to_num(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("store", ["fp32", "int8"])
def test_search_on_card_matches_cpu(dev, store, tmp_path):
    """The same index on both devices: the kernel path's candidates equal the
    plain path's for the same query hash strings, and results agree."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 32)).astype(np.float32)
    cpu = LCCSIndex.build(X, m=16, family="euclidean", w=4.0, store=store, device="cpu")
    cpu.save(tmp_path / "i.pkl")
    gpu = LCCSIndex.load(tmp_path / "i.pkl", device=dev)
    Q = torch.from_numpy(X[:40])
    qh = stages.hash_queries(cpu.family, Q)
    for source in ("lccs", "multiprobe-skip"):
        p = SearchParams(k=5, lam=64, width=64, source=source, probes=9,
                         use_probe_kernel=True, use_gather_kernel=True)
        ci, cl = stages.probe(cpu, Q, qh, p)
        gi, gl = stages.probe(gpu, Q.to(dev), qh.to(dev), p)
        assert torch.equal(ci, gi.cpu()) and torch.equal(cl, gl.cpu())
        _, cd = cpu.search(Q, p)
        _, gd = gpu.search(Q, p)
        torch.testing.assert_close(cd, gd.cpu(), rtol=1e-5, atol=1e-5)
