"""On-card checks: each hand-written CUDA kernel against its plain PyTorch
version on the same CUDA tensors (csa_probe and circrun bit-identical; the
gathers within rtol 1e-5 / atol 1e-5, fp32 summation order; hash_rp and
hash_xp may differ only at a bucket boundary or a near tie, see
`_rp_boundary` and `_xp_near_tie`; flash_attn within rtol/atol 1e-4 and
ssm_scan within rtol/atol 1e-5, fp32 summation order and expf/tanhf ulps).  They need a card and skip without one;
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
from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
from repro_torch.kernels.csa_probe import csa_probe, csa_probe_plain
from repro_torch.kernels.gather_l2 import gather_dist_kernel, gather_dist_ref
from repro_torch.kernels.gather_q import gather_dist_q_kernel, gather_dist_q_ref
from repro_torch.kernels.hash_rp import hash_rp, hash_rp_ref
from repro_torch.kernels.hash_xp import hash_xp, hash_xp_ref
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_batched_ref
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


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,dh,causal,window,softcap", [
    (32, 32, 32, 8, 1, 256, True, 0, 0.0),      # gemma-2b's serving shape
    (2, 77, 77, 4, 2, 16, True, 0, 0.0),        # odd length, several tiles
    (2, 40, 40, 4, 4, 64, False, 0, 0.0),       # non-causal, padded tail
    (1, 8, 40, 2, 1, 40, True, 0, 0.0),         # Sq < Skv: the ends aligned
    (2, 100, 100, 6, 3, 256, True, 33, 50.0),   # window + softcap (gemma2)
    (1, 130, 130, 2, 2, 100, False, 17, 0.0),   # non-causal window
    (1, 1, 1, 1, 1, 1, True, 0, 0.0),
])
def test_flash_attn_kernel_matches_plain(dev, B, Sq, Skv, Hq, Hkv, dh, causal, window, softcap):
    rng = np.random.default_rng(Sq * dh + Hq)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, dh)).astype(np.float32)).to(dev)
               for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    before = common.launch_counts()["flash_attn"]
    out = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert common.launch_counts()["flash_attn"] == before + 1
    ref = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    assert out.shape == (B, Sq, Hq, dh) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_flash_attn_kernel_rejects_what_it_does_not_take(dev):
    q, kv = torch.zeros((1, 4, 2, 300), device=dev), torch.zeros((1, 4, 1, 300), device=dev)
    with pytest.raises(ValueError, match="dh"):
        flash_attention(q, kv, kv)
    q, kv = torch.zeros((1, 4, 3, 8), device=dev), torch.zeros((1, 4, 2, 8), device=dev)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), kv, kv)


@pytest.mark.parametrize("B,L,D,N,seq_chunk", [
    (32, 32, 8192, 16, 2048),   # falcon-mamba-7b's serving shape
    (3, 77, 200, 16, 2048),     # odd L and D
    (2, 100, 130, 5, 33),       # chunked: h carried across 4 chunks
    (1, 1, 1, 1, 1),
])
def test_ssm_scan_kernel_matches_plain(dev, B, L, D, N, seq_chunk):
    rng = np.random.default_rng(L * D + N)
    f = lambda *shape, s=1.0: torch.from_numpy(  # noqa: E731
        (rng.normal(size=shape) * s).astype(np.float32)).to(dev)
    dt = torch.nn.functional.softplus(f(B, L, D))
    x, Bc, Cc = f(B, L, D), f(B, L, N), f(B, L, N)
    A = -torch.exp(f(D, N, s=0.5))
    h0 = f(B, D, N)
    before = common.launch_counts()["ssm_scan"]
    y, h = ssm_scan(dt, x, Bc, Cc, A, h0, seq_chunk=seq_chunk)
    torch.cuda.synchronize()
    assert common.launch_counts()["ssm_scan"] == before + -(-L // seq_chunk)
    y_ref, h_ref = ssm_scan_batched_ref(dt, x, Bc, Cc, A, h0)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, h_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,D", [(0, 64), (2, 0)])
def test_ssm_scan_empty_launches_nothing(dev, B, D):
    L, N = 5, 16
    z = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    h0 = z(B, D, N)
    before = common.launch_counts()["ssm_scan"]
    y, h = ssm_scan(z(B, L, D), z(B, L, D), z(B, L, N), z(B, L, N), z(D, N), h0)
    assert common.launch_counts()["ssm_scan"] == before
    assert y.shape == (B, L, D) and h.shape == (B, D, N)


@pytest.mark.parametrize("arch", ["gemma-2b", "falcon-mamba-7b", "gemma2-9b"])
def test_smoke_model_on_card_matches_cpu(dev, arch):
    """The same smoke-size weights on both devices: the forward through the
    kernels equals the plain CPU forward within rtol/atol 1e-4, and it
    launched the model's kernel once per layer."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_model

    cfg = ARCHS[arch].smoke()
    cpu = init_model(cfg, seed=0, device="cpu")
    card = init_model(cfg, seed=0, device="cpu").to(dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 33)))
    before = common.launch_counts()
    out = card(toks.to(dev))
    after = common.launch_counts()
    kernel = "ssm_scan" if cfg.family == "ssm" else "flash_attn"
    assert after[kernel] - before[kernel] == cfg.n_layers
    torch.testing.assert_close(out.cpu(), cpu(toks), rtol=1e-4, atol=1e-4)
