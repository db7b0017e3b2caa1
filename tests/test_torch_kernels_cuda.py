"""On-card checks: each hand-written CUDA kernel against its plain PyTorch
version on the same CUDA tensors (csa_probe and circrun bit-identical; the
gathers within rtol 1e-5 / atol 1e-5, fp32 summation order; hash_rp and
hash_xp may differ only at a bucket boundary or a near tie, see
`_rp_boundary` and `_xp_near_tie`).  They need a card and skip without one;
`python3 chip_smoke.py` is the authoritative on-card run."""
import numpy as np
import pytest
import torch

from repro_torch import LCCSIndex, SearchParams, SegmentedLCCSIndex
from repro_torch.core import lsh
from repro_torch.core.search import doubled
from repro_torch.exec import stages
from repro_torch.kernels import common
from repro_torch.kernels.circrun import circrun, circrun_ref
from repro_torch.kernels.csa_probe import csa_probe, csa_probe_plain
from repro_torch.kernels.gather_l2 import gather_dist_kernel, gather_dist_ref
from repro_torch.kernels.gather_q import gather_dist_q_kernel, gather_dist_q_ref
from repro_torch.kernels.hash_rp import hash_rp, hash_rp_ref
from repro_torch.kernels.hash_xp import hash_xp, hash_xp_ref
from repro_torch.store.stores import _quantize_rows

# a hash may differ between kernel and plain version only where the float64
# value lies this close (relative) to a bucket boundary or a tie, and in at
# most this share of the outputs
BOUNDARY_RTOL = 1e-5
MAX_MISMATCH_SHARE = 1e-4

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
        # verify on the shared candidates: end to end, `search` on the card
        # hashes through hash_rp, which may move a boundary projection
        _, cd = stages.verify(cpu.store, cpu.tail, Q, ci, p, "euclidean")
        _, gd = stages.verify(gpu.store, gpu.tail, Q.to(dev), gi, p, "euclidean")
        torch.testing.assert_close(cd, gd.cpu(), rtol=1e-5, atol=1e-5)


def test_small_index_verify_card_vs_cpu_repeated(dev, tmp_path):
    """chip_smoke.py's card-vs-CPU check on a 4,000-row index (its rows,
    d = 128, m = 64, w = 16), repeated with a fresh load onto the card each
    time: equal candidates and verify distances within rtol/atol 1e-5, every
    time."""
    from repro_torch.data import clustered_vectors

    X = clustered_vectors(1_000_000, 128, n_clusters=100, seed=0)[:4000]
    cpu = LCCSIndex.build(X, m=64, family="euclidean", w=16.0, device="cpu")
    cpu.save(tmp_path / "small.pkl")
    Q = torch.from_numpy(X[:64] + 0.05)
    qh = stages.hash_queries(cpu.family, Q)
    params = [SearchParams(k=10, lam=100, width=100, source="lccs", use_probe_kernel=True,
                           use_gather_kernel=True),
              SearchParams(k=10, lam=200, width=64, source="multiprobe-skip", probes=17,
                           use_probe_kernel=True, use_gather_kernel=True)]
    expect = []
    for p in params:
        ci, cl = stages.probe(cpu, Q, qh, p)
        expect.append((ci, cl, stages.verify(cpu.store, cpu.tail, Q, ci, p, "euclidean")[1]))
    for _ in range(50):
        gpu = LCCSIndex.load(tmp_path / "small.pkl", device=dev)
        for p, (ci, cl, cd) in zip(params, expect):
            gi, gl = stages.probe(gpu, Q.to(dev), qh.to(dev), p)
            assert torch.equal(ci, gi.cpu()) and torch.equal(cl, gl.cpu())
            _, gd = stages.verify(gpu.store, gpu.tail, Q.to(dev), gi, p, "euclidean")
            torch.testing.assert_close(cd, gd.cpu(), rtol=1e-5, atol=1e-5)


def _rp_boundary(x, a, b, w, k, p):
    """Mismatches of RP hashes k (kernel) and p (plain) are +-1 and lie where
    the float64 value of (x.a + b) / w is within BOUNDARY_RTOL of an
    integer; returns the mismatch share."""
    v = (x.double() @ a.double() + b.double()) / w
    diff = k != p
    near = (v - torch.round(v)).abs() <= BOUNDARY_RTOL * torch.clamp(v.abs(), min=1.0)
    assert bool(((k - p).abs() <= 1).all())
    assert not bool((diff & ~near).any())
    return float(diff.float().mean())


def _xp_near_tie(x, rot, k, p):
    """Mismatches of XP hashes lie where the two largest of cat([y, -y]) in
    float64 are within BOUNDARY_RTOL (relative); returns the share."""
    y = torch.einsum("nd,mde->nme", x.double(), rot.double())
    top2 = torch.topk(torch.cat([y, -y], dim=-1), 2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= BOUNDARY_RTOL * top2[..., 0].abs()
    diff = k != p
    assert not bool((diff & ~near).any())
    return float(diff.float().mean())


@pytest.mark.parametrize("n,d,m,w", [(5000, 128, 64, 16.0), (777, 13, 7, 0.5),
                                     (300, 200, 100, 4.0)])
def test_hash_rp_kernel_matches_plain(dev, n, d, m, w):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) * 5).to(dev)
    a = torch.from_numpy(rng.normal(size=(d, m)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(0, w, size=m).astype(np.float32)).to(dev)
    before = common.launch_counts()["hash_rp"]
    k = hash_rp(x, a, b, w=w)
    torch.cuda.synchronize()
    assert common.launch_counts()["hash_rp"] == before + 1
    p = hash_rp_ref(x, a, b, w=w)
    assert k.dtype == torch.int32 and k.shape == (n, m)
    assert _rp_boundary(x, a, b, w, k, p) <= MAX_MISMATCH_SHARE


@pytest.mark.parametrize("n,d,dr,m", [(4000, 128, 128, 16), (500, 13, 40, 5),
                                      (300, 64, 200, 3)])
def test_hash_xp_kernel_matches_plain(dev, n, d, dr, m):
    rng = np.random.default_rng(dr)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    x[0] = 0.0  # all-zero y: every value ties, index 0 wins
    rot = torch.from_numpy((rng.normal(size=(m, d, dr)) / np.sqrt(d)).astype(np.float32)).to(dev)
    k = hash_xp(x, rot)
    p = hash_xp_ref(x, rot)
    assert k.dtype == torch.int32 and k.shape == (n, m)
    assert bool((k[0] == 0).all()) and bool(((k >= 0) & (k < 2 * dr)).all())
    assert _xp_near_tie(x, rot, k, p) <= MAX_MISMATCH_SHARE


@pytest.mark.parametrize("m", [5, 16, 64, 100, 300])
def test_circrun_kernel_bit_identical(dev, m):
    rng = np.random.default_rng(m)
    n, B = 1000 + m, 45
    h = rng.integers(-3, 3, size=(n, m)).astype(np.int32)
    q = rng.integers(-3, 3, size=(B, m)).astype(np.int32)
    h[0] = q[0]  # all-match row: m
    h[1] = np.iinfo(np.int32).max  # a segment's sentinel row
    q[1] = np.iinfo(np.int32).max
    h, q = torch.from_numpy(h).to(dev), torch.from_numpy(q).to(dev)
    before = common.launch_counts()["circrun"]
    k = circrun(h, q)
    assert common.launch_counts()["circrun"] == before + 1
    assert torch.equal(k, circrun_ref(h, q))
    assert int(k[0, 0]) == m and int(k[1, 1]) == m
    assert torch.equal(circrun(h, q[3]), k[3])


@pytest.mark.parametrize("family,kw", [("euclidean", dict(w=4.0)),
                                       ("angular", dict(rotation="gaussian"))])
def test_multiprobe_alternatives_never_equal_base(dev, family, kw):
    rng = np.random.default_rng(5)
    fam = lsh.make_family(family, 3, 32, 16, device=dev, **kw)
    Q = torch.from_numpy(rng.normal(size=(2000, 32)).astype(np.float32)).to(dev)
    qh = fam.hash(Q)
    vals, scores = fam.alternatives(Q, 4)
    assert not bool((vals == qh[..., None]).any())
    assert bool(torch.isfinite(scores).all())


def _dyadic(x, bits=4):
    """Round to multiples of 2^-bits: products and sums stay exact in fp32,
    so every summation order hashes alike on both devices."""
    return np.round(np.asarray(x, np.float64) * 2 ** bits) / 2 ** bits


def test_segmented_on_card_matches_cpu(dev):
    rng = np.random.default_rng(7)
    X = _dyadic(rng.normal(size=(3000, 32)) * 3).astype(np.float32)
    idxs = []
    for device in ("cpu", dev):
        idx = SegmentedLCCSIndex.create(32, m=16, family="euclidean", w=4.0, seed=1,
                                        device=device)
        idx.family.a = torch.from_numpy(_dyadic(idx.family.a.cpu()).astype(np.float32)).to(device)
        idx.family.b = torch.from_numpy(_dyadic(idx.family.b.cpu()).astype(np.float32)).to(device)
        idx.insert(X[:2000])
        idx.compact()
        idx.insert(X[2000:2600])
        idx.delete(np.arange(0, 2600, 7))
        idx.insert(X[2600:])
        idxs.append(idx)
    cpu, gpu = idxs
    assert torch.equal(cpu.buf_h, gpu.buf_h.cpu())
    for s_c, s_g in zip(cpu.segments, gpu.segments, strict=True):
        for t_c, t_g in zip(s_c.csa.tables(), s_g.csa.tables()):
            assert torch.equal(t_c, t_g.cpu())
    Q = torch.from_numpy(X[:64] + 0.25)
    qh = cpu.family.hash(Q)
    assert torch.equal(qh, gpu.family.hash(Q.to(dev)).cpu())
    before = common.launch_counts()
    for source in ("lccs", "bruteforce", "multiprobe-skip"):
        p = SearchParams(k=5, lam=64, width=64, source="segmented", inner=source, probes=9)
        ci, cl = stages.probe(cpu, Q, qh, p)
        gi, gl = stages.probe(gpu, Q.to(dev), qh.to(dev), p)
        assert torch.equal(ci, gi.cpu()) and torch.equal(cl, gl.cpu())
    after = common.launch_counts()
    assert after["circrun"] > before["circrun"] and after["csa_probe"] > before["csa_probe"]
