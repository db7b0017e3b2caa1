"""On-card checks: each hand-written CUDA kernel against its plain PyTorch
version on the same CUDA tensors (csa_probe, pool_topk, circrun and
circrun_topk bit-identical, csa_probe also on tests/torch_probe_cases.py,
pool_topk also against the scatter-max dedupe; the gather scans within
rtol 1e-5 / atol 1e-5, fp32 summation order, and the fused verify bit for
bit against the scan + its plain epilogue, also on
tests/torch_verify_cases.py; hash_rp and hash_xp may differ only at a
bucket boundary or a near tie, see `_rp_boundary` and `_xp_near_tie`;
flash_attn within rtol/atol 1e-4 (its 3xTF32 products and the float32
summation order, ex2 and rcp ulps; also on tests/torch_flash_cases.py, and
bit for bit from one launch to the next), its backward kernel within 2e-4
of each gradient's largest entry (BWD_CASES and a few forward cases, bit
for bit from one launch to the next; a smoke model's train step on the card
against the CPU) and ssm_scan within rtol/atol 1e-5,
fp32 summation order and ex2 ulps; ssm_scan also on
tests/torch_scan_cases.py and against the plain mirror of its lanes).  They
need a card and skip without one; `python3 chip_smoke.py` is the
authoritative on-card run."""
import numpy as np
import pytest
import torch
from torch_flash_cases import BWD_CASES, FLASH_CASES, make_bwd_case
from torch_flash_cases import make_case as make_flash_case
from torch_pool_cases import POOL_CASES, make_pool
from torch_probe_cases import PROBE_CASES, make_case
from torch_scan_cases import SCAN_CASES, lanes_mirror
from torch_scan_cases import make_case as make_scan_case
from torch_verify_cases import VERIFY_CASES, survivor_budget
from torch_verify_cases import make_case as make_verify_case

from repro_torch import LCCSIndex, SearchParams, SegmentedLCCSIndex
from repro_torch.core import lsh
from repro_torch.core.csa import build_csa
from repro_torch.core.search import doubled
from repro_torch.exec import stages
from repro_torch.kernels import common
from repro_torch.kernels.circrun import circrun, circrun_ref, circrun_topk, circrun_topk_plain
from repro_torch.kernels.circrun import ops as circrun_ops
from repro_torch.kernels.flash_attn import (flash_attention, flash_attention_bwd,
                                            flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.csa_probe import (
    csa_probe,
    csa_probe_plain,
    dedupe_topk_scatter,
    pool_topk,
    pool_topk_plain,
)
from repro_torch.kernels.csa_probe import ref as probe_ref
from repro_torch.kernels.csa_probe.ops import POOL_MAX_K
from repro_torch.kernels.csa_probe.ref import pool_levels
from repro_torch.kernels.gather_l2 import gather_dist_kernel, gather_dist_ref
from repro_torch.kernels.gather_l2 import ops as l2_ops
from repro_torch.kernels.gather_q import gather_dist_q_kernel, gather_dist_q_ref
from repro_torch.kernels.hash_rp import hash_rp, hash_rp_ref
from repro_torch.kernels.hash_xp import hash_xp, hash_xp_ref
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_batched_ref
from repro_torch.store.stores import Fp32Store, Int8Store, _quantize_rows

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


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_csa_probe_kernel_on_the_probe_cases(dev, case):
    """The shared probe cases (tests/torch_probe_cases.py): every group
    width, unaligned shifts, equal rows, pos 0 and pos n, W > n."""
    h, qd, shifts, qidx, width = make_case(case)
    c = build_csa(torch.from_numpy(h).to(dev))
    args = (c.I, c.L, c.Hd, *(torch.from_numpy(a).to(dev) for a in (qd, shifts, qidx)), width)
    before = common.launch_counts()["csa_probe"]
    ki, kl = csa_probe(*args)
    torch.cuda.synchronize()
    assert common.launch_counts()["csa_probe"] == before + 1
    pi, pl = csa_probe_plain(*args)
    assert torch.equal(ki, pi) and torch.equal(kl, pl)


def _pool_check(ids, lcps, n, lam, scatter=True):
    """pool_topk's kernel equals its plain version (and the scatter-max
    dedupe) bit for bit, in as many launches as `pool_levels` promises."""
    before = common.launch_counts()["pool_topk"]
    ki, kv = pool_topk(ids, lcps, n, lam)
    torch.cuda.synchronize()
    B, pool = ids.shape
    want = len(pool_levels(pool, min(lam, n), n)) if B and pool else 0
    assert common.launch_counts()["pool_topk"] == before + want
    assert ki.shape == (B, lam) and ki.dtype == torch.int32
    pi, pv = pool_topk_plain(ids, lcps, n, lam)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    if scatter:
        si, sv = dedupe_topk_scatter(ids, lcps, n, lam)
        assert torch.equal(ki, si) and torch.equal(kv, sv)


@pytest.mark.parametrize("name", list(POOL_CASES))
def test_pool_topk_kernel_bit_identical(dev, monkeypatch, name):
    _, _, n, lam, tile, _, _ = POOL_CASES[name]
    if tile is not None:  # the wrapper's tiles
        monkeypatch.setattr(probe_ref, "POOL_TILE", tile)
    ids, lcps = (torch.from_numpy(a).to(dev) for a in make_pool(name))
    _pool_check(ids, lcps, n, lam)


@pytest.mark.parametrize("spread", [1_000_000, 20_000])
def test_pool_topk_kernel_at_the_lccs_pool(dev, spread):
    """The lccs pool at n = 10^6, m 64, W 100: 1,000 x 12,800 entries, one
    tile a row (one launch); ids over the whole corpus, then crowded (many
    repeats)."""
    rng = np.random.default_rng(spread)
    ids = torch.from_numpy(rng.integers(0, spread, (1000, 12_800)).astype(np.int32)).to(dev)
    lcps = torch.from_numpy(rng.integers(0, 65, (1000, 12_800)).astype(np.int32)).to(dev)
    _pool_check(ids, lcps, 1_000_000, 100)


@pytest.mark.parametrize("n,lam", [(1_000_000, 1024), (2**31 - 1, 1024), (1_000_000, 4096)])
def test_pool_topk_kernel_several_tiles_large_lam(dev, n, lam):
    """A multiprobe-skip sized pool (139,264 entries: 9 tiles of 16,384 and
    one merge at lam 1,024); n past 2^23 takes the kernel's 8-byte keys
    (and tiles of 8,192); lam 4,096 places the chosen ids by a sort."""
    rng = np.random.default_rng(7)
    ids = rng.integers(n - 200_000, n, (6, 139_264))
    ids[:, ::5] = -1
    lcps = rng.integers(0, 65, (6, 139_264))
    lcps[ids < 0] = -1
    ids, lcps = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (ids, lcps))
    _pool_check(ids, lcps, n, lam, scatter=n < 2**23)


@pytest.mark.parametrize("n", [10**6, 2**24])
def test_pool_topk_kernel_rejects_what_it_does_not_take(dev, monkeypatch, n):
    """k up to 4,096; tiles up to 16,384 entries, or 8,192 where ids reach
    2^23 and take 8-byte keys (POOL_TILE // 2), so that a tile fits the
    kernel's registers and its table's capacity (1.25 x the tile's entries)
    its shared memory."""
    z = torch.zeros((2, 20_000), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=str(POOL_MAX_K)):
        pool_topk(z, z, n, POOL_MAX_K + 1)
    with pytest.raises(TypeError, match="dtype"):
        pool_topk(z.long(), z, n, 100)
    assert pool_topk(z, z, n, POOL_MAX_K)[0].shape == (2, POOL_MAX_K)
    monkeypatch.setattr(probe_ref, "POOL_TILE", 16_384)  # the largest tiles it takes
    assert torch.equal(pool_topk(z, z, n, 100)[0], pool_topk_plain(z, z, n, 100)[0])
    monkeypatch.setattr(probe_ref, "POOL_TILE", 16_386)  # one entry over, either key width
    with pytest.raises(RuntimeError, match="cudaError"):
        pool_topk(z, z, n, 100)


def _scan_inputs(case, dev):
    """(data, ids, queries) on the card: a verify case of
    tests/torch_verify_cases.py, or "d <d>", 33 x 70 candidates of 2,000 rows
    (row 7 zero, the first candidate)."""
    if case in VERIFY_CASES:
        data, ids, _, queries, _ = make_verify_case(case)
    else:
        d = int(case.split()[1])
        rng = np.random.default_rng(d)
        data = rng.normal(size=(2000, d)).astype(np.float32)
        data[7] = 0.0
        ids = rng.integers(-1, 2000, size=(33, 70)).astype(np.int32)
        ids[0, 0] = 7
        queries = rng.normal(size=(33, d)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (data, ids, queries))


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("case", ["d 128", "d 13", "d 48", *VERIFY_CASES])
def test_gather_kernels_match_plain(dev, metric, case):
    data, ids, queries = _scan_inputs(case, dev)
    k = gather_dist_kernel(data, ids, queries, metric=metric)
    p = gather_dist_ref(data, ids, queries, metric=metric)
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    torch.testing.assert_close(k.nan_to_num(), p.nan_to_num(), rtol=1e-5, atol=1e-5)
    codes, scale = _quantize_rows(data)
    k = gather_dist_q_kernel(codes, scale, ids, queries, metric=metric)
    p = gather_dist_q_ref(codes, scale, ids, queries, metric=metric)
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    torch.testing.assert_close(k.nan_to_num(), p.nan_to_num(), rtol=1e-5, atol=1e-5)


def _verify_store(case, kind, dev):
    data, ids, report, queries, k = make_verify_case(case)
    cls = Fp32Store if kind == "fp32" else Int8Store
    st = cls.from_dense(torch.from_numpy(data).to(dev))
    return st, *(torch.from_numpy(a).to(dev) for a in (ids, report, queries)), k


def _same_bits(a, b):
    """Equal dtype, shape and bits (floats compared as their int32 words)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("tile", [None, 64, 2])
@pytest.mark.parametrize("kind", ["fp32", "int8"])
@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("case", list(VERIFY_CASES))
def test_fused_verify_kernel_equals_unfused_route(dev, monkeypatch, case, metric, kind, tile):
    """gather_topk / gather_topk_q (exact and survivors modes) against the
    scan kernel + the store's epilogue + `topk_ids` / `_smallest`, bit for
    bit; tile 64 and 2 (the wrapper's TOPK_TILE) take the tiled sort and its
    merge stages at every L above them."""
    if tile is not None:
        monkeypatch.setattr(l2_ops, "TOPK_TILE", tile)
    st, ids, report, queries, k = _verify_store(case, kind, dev)
    name = "gather_l2_topk" if kind == "fp32" else "gather_q_topk"
    dist = st.gather_dist(ids, queries, metric=metric, use_kernel=True)
    before = common.launch_counts()[name]
    got = st.gather_topk(ids, queries, k, metric=metric, report_ids=report)
    assert common.launch_counts()[name] == before + 1
    want = stages.topk_ids(dist, report, k)
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
    r = survivor_budget(case)
    vals, idx = stages._smallest(dist, r)
    got = st.gather_topk(ids, queries, r, metric=metric, survivors=True)
    assert _same_bits(got[0], torch.gather(ids, 1, idx)) and _same_bits(got[1], vals)


def _same_with_nan(a, b):
    """Equal bits, where a NaN matches any NaN (the kernel writes the
    canonical one)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and _same_bits(a[~nan], b[~nan])


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_fused_verify_kernel_orders_nan_and_inf_as_the_sort(dev, metric):
    """Rows of NaN and +inf: Euclidean distances NaN (after +inf, ties to the
    lower slot) and +inf (id -1 in exact mode), angular ones mapped to 1; the
    fused fp32 verify against the scan + the plain epilogue + the stable
    sort, all columns (k = L) and past them (k > L)."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=(50, 16)).astype(np.float32)
    data[1], data[2] = np.nan, np.inf
    ids = rng.integers(-1, 50, size=(4, 12)).astype(np.int32)
    ids[:, :5] = [1, 2, 1, 2, 3]
    st = Fp32Store(rows=torch.from_numpy(data).to(dev))
    ids, queries = (torch.from_numpy(a).to(dev) for a in
                    (ids, rng.normal(size=(4, 16)).astype(np.float32)))
    dist = st.gather_dist(ids, queries, metric=metric, use_kernel=True)
    for k in (12, 15):
        got = st.gather_topk(ids, queries, k, metric=metric)
        want = stages.topk_ids(dist, ids, k)
        assert torch.equal(got[0], want[0]) and _same_with_nan(got[1], want[1])
    got = st.gather_topk(ids, queries, 12, metric=metric, survivors=True)
    vals, idx = stages._smallest(dist, 12)
    assert torch.equal(got[0], torch.gather(ids, 1, idx)) and _same_with_nan(got[1], vals)
    if metric == "euclidean":
        assert bool(torch.isnan(got[1][:, -1]).all())  # NaN ranks last


@pytest.mark.parametrize("kind", ["fp32", "int8"])
@pytest.mark.parametrize("case", ["d 128, L 100, k 10", "d 16, L 10000 (several tiles)"])
def test_fused_verify_kernel_repeats(dev, case, kind):
    """100 runs of the fused verify on one input give the first run's bits
    (one kernel, no atomics), both modes, both metrics."""
    st, ids, report, queries, k = _verify_store(case, kind, dev)
    for metric in ("euclidean", "angular"):
        for kw in (dict(report_ids=report), dict(survivors=True)):
            first = st.gather_topk(ids, queries, k, metric=metric, **kw)
            for _ in range(100):
                again = st.gather_topk(ids, queries, k, metric=metric, **kw)
                assert _same_bits(again[0], first[0]) and _same_bits(again[1], first[1])


def test_fused_verify_kernel_rejects_what_it_does_not_take(dev):
    st, ids, report, queries, k = _verify_store("d 16, L 7, k > L", "fp32", dev)
    with pytest.raises(ValueError, match="metric"):
        st.gather_topk(ids, queries, k, metric="hamming")
    with pytest.raises(TypeError, match="dtype"):
        st.gather_topk(ids.long(), queries, k, metric="euclidean")
    with pytest.raises(ValueError, match="shape"):
        st.gather_topk(ids, queries, k, metric="euclidean", report_ids=report[:, :3])
    empty = st.gather_topk(ids[:, :0].contiguous(), queries, k, metric="euclidean")
    assert bool((empty[0] == -1).all()) and bool(torch.isinf(empty[1]).all())


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


def _on_card(arr, dev, offset):
    """`arr` as a contiguous card tensor that starts `offset` floats into its
    buffer: offset 1 leaves it 4-byte aligned only, so the kernels take
    their 4-byte copy path."""
    buf = torch.empty(arr.size + offset, dtype=torch.float32, device=dev)
    t = buf[offset:].view(arr.shape)
    t.copy_(torch.from_numpy(arr))
    return t


@pytest.mark.parametrize("n,d,m,w,offset", [
    (5000, 128, 64, 16.0, 0), (777, 13, 7, 0.5, 0), (300, 200, 100, 4.0, 0),
    (1, 128, 64, 16.0, 0),                                  # one row
    (1_000_003, 128, 64, 16.0, 0),                          # a partial last row tile
    (3000, 100, 64, 16.0, 0), (3000, 256, 64, 16.0, 0),     # the paper's widths
    (3000, 420, 64, 16.0, 0), (3000, 960, 64, 16.0, 0),
    (3000, 128, 65, 16.0, 0), (3000, 128, 300, 16.0, 0),    # several column tiles
    (3000, 128, 64, 16.0, 1),                               # x 4-byte aligned only
])
def test_hash_rp_kernel_matches_plain(dev, n, d, m, w, offset):
    rng = np.random.default_rng(d)
    x = _on_card((rng.normal(size=(n, d)) * 5).astype(np.float32), dev, offset)
    a = torch.from_numpy(rng.normal(size=(d, m)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(0, w, size=m).astype(np.float32)).to(dev)
    before = common.launch_counts()["hash_rp"]
    k = hash_rp(x, a, b, w=w)
    torch.cuda.synchronize()
    assert common.launch_counts()["hash_rp"] == before + 1
    p = hash_rp_ref(x, a, b, w=w)
    assert k.dtype == torch.int32 and k.shape == (n, m)
    assert _rp_boundary(x, a, b, w, k, p) <= MAX_MISMATCH_SHARE


def _f32(v):
    return np.float32(v)


# w for the division checks: the fast path's range [2^-60, 2^60] and its
# ends, one float inside and outside each end, far outside, reciprocals that
# are not exact, and w with an all-ones mantissa (the hardest case for the
# Newton step), then a few hundred log-uniform over the range
_W_EDGES = [16.0, 3.0, _f32(0.1), 2.0 ** -70, 2.0 ** 70, 2.0 ** -60, 2.0 ** 60,
            np.nextafter(_f32(2.0 ** -60), _f32(1)), np.nextafter(_f32(2.0 ** -60), _f32(0)),
            np.nextafter(_f32(2.0 ** 60), _f32(0)), np.nextafter(_f32(2.0 ** 60), _f32(np.inf)),
            np.nextafter(_f32(2), _f32(0)), np.nextafter(_f32(2), _f32(0)) * _f32(2.0 ** -45),
            np.nextafter(_f32(2), _f32(0)) * _f32(2.0 ** 45)]
_W_SWEEP = [float(w) for w in _W_EDGES] + [
    float(w) for w in (2.0 ** np.random.default_rng(60).uniform(-60, 60, 300)).astype(np.float32)]


def _ieee_buckets(t, b, w):
    """floor((t + b) / w) in IEEE float32 arithmetic on the host (numpy)."""
    q = (t[:, None] + b[None, :]) / _f32(w)
    assert q.dtype == np.float32
    return np.floor(q).astype(np.int32)


@pytest.mark.parametrize("d", [1, 4])
def test_hash_rp_kernel_buckets_like_ieee_division(dev, d):
    """With the projection exact (x = [t, 0, ...], a = 1 in its first row),
    the kernel's buckets equal floor((t + b) / w) in IEEE float32 arithmetic,
    bit for bit, on and off the division's fast path: t of every magnitude,
    zero and subnormal t, quotients next to an integer (b = 0 in column 0),
    and w over [2^-60, 2^60], at its ends and outside it.  m = 64 fills a
    thread's 8 columns, the fast path's unit.  d = 1 takes the 4-byte copy
    path, d = 4 the 16-byte one."""
    rng = np.random.default_rng(d)
    m = 64
    a = np.zeros((d, m), np.float32)
    a[0] = 1.0
    at = torch.from_numpy(a).to(dev)
    for w in _W_SWEEP:
        b = rng.uniform(0, w, m).astype(np.float32)
        b[0] = 0.0
        q = rng.uniform(-1e6, 1e6, 1000).astype(np.float32)  # |t / w| < 2^30
        on_int = (np.round(q) * _f32(w)).astype(np.float32)  # t / w next to an integer
        t = np.concatenate([
            q * _f32(w), on_int, np.nextafter(on_int, _f32(np.inf)),
            np.nextafter(on_int, _f32(-np.inf)),
            np.float32([0.0, -0.0, 1e-45, -1e-45, 2.0 ** -126, -(2.0 ** -126), 2.0 ** -60,
                        2.0 ** -61]),
        ]).astype(np.float32)
        with np.errstate(over="ignore"):
            t = t[np.isfinite(t) & (np.abs(t.astype(np.float64) / w) < 2.0 ** 30)]
        x = np.zeros((t.size, d), np.float32)
        x[:, 0] = t
        k = hash_rp(torch.from_numpy(x).to(dev), at, torch.from_numpy(b).to(dev), w=w)
        assert np.array_equal(k.cpu().numpy(), _ieee_buckets(t, b, w)), f"w={w!r}"


@pytest.mark.parametrize("w", [3.0, float(_f32(0.1)), float(np.nextafter(_f32(2), _f32(0))),
                               float(np.nextafter(_f32(2), _f32(0)) * _f32(2.0 ** -50)),
                               float(_f32(1.3 * 2.0 ** 40))])
def test_hash_rp_kernel_divides_every_mantissa_like_ieee(dev, w):
    """Every float32 t of one binade, both signs, with quotients t / w in
    [2^10, 2^12) (thousands of integers, each next to many t): the kernel's
    floor(t / w) equals IEEE float32 division's, bit for bit.  x holds 64 t
    a row and a is the identity, so each projection is exactly its t."""
    e = int(np.floor(np.log2(w))) + 11
    mant = np.arange(2 ** 23, dtype=np.uint32)
    pos = ((np.uint32(e + 127) << np.uint32(23)) | mant).view(np.float32)
    t = np.concatenate([pos, -pos])
    x = torch.from_numpy(t.reshape(-1, 64)).to(dev)
    a = torch.eye(64, device=dev)
    b = torch.zeros(64, device=dev)
    before = common.launch_counts()["hash_rp"]
    k = hash_rp(x, a, b, w=w)
    torch.cuda.synchronize()
    assert common.launch_counts()["hash_rp"] == before + 1
    ref = np.floor(t / _f32(w)).astype(np.int32)
    assert np.array_equal(k.cpu().numpy().reshape(-1), ref)


@pytest.mark.parametrize("n,d,dr,m,offset", [
    (4000, 128, 128, 16, 0), (500, 13, 40, 5, 0), (300, 64, 200, 3, 0),
    (2000, 100, 128, 16, 0), (2000, 420, 128, 16, 0),      # the paper's widths: x
    (2000, 960, 128, 16, 0),                               # streamed past d = 160
    (2000, 128, 127, 16, 0), (2000, 128, 129, 16, 0),      # ragged and several
    (2000, 128, 256, 16, 0),                               # column tiles
    (2000, 128, 128, 1, 0), (2000, 128, 128, 64, 0),       # one and 64 functions
    (2000, 128, 128, 16, 1),                               # x 4-byte aligned only
    (300, 4, 4, 70_000, 0),                                # m past 65,535
    # each of the launcher's 8 templates (x resident or streamed, 16- or
    # 4-byte copies, functions split among blocks or not) at least once:
    (2000, 421, 128, 16, 0), (2000, 960, 128, 16, 1),      # streamed, 4-byte, split
    (2000, 960, 128, 1, 0),                                # streamed, 16-byte, whole
    (2000, 421, 129, 1, 0),                                # streamed, 4-byte, whole
    (2000, 128, 129, 1, 0),                                # resident, 4-byte, whole
    (40_000, 128, 256, 4, 0),                              # full-size grid, dr > 128
])
def test_hash_xp_kernel_matches_plain(dev, n, d, dr, m, offset):
    rng = np.random.default_rng(dr)
    x_np = rng.normal(size=(n, d)).astype(np.float32)
    x_np[0] = 0.0  # all-zero y: every value ties, index 0 wins
    x = _on_card(x_np, dev, offset)
    rot = torch.from_numpy((rng.normal(size=(m, d, dr)) / np.sqrt(d)).astype(np.float32)).to(dev)
    before = common.launch_counts()["hash_xp"]
    k = hash_xp(x, rot)
    torch.cuda.synchronize()
    assert common.launch_counts()["hash_xp"] == before + 1
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


def _circ_strings(n, m, B, alpha, seed):
    """Hash strings with negative symbols, an all-match row (length m) and
    int32-max sentinel rows, as the delta buffer's free slots hold."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-alpha, alpha, size=(n, m)).astype(np.int32)
    q = rng.integers(-alpha, alpha, size=(B, m)).astype(np.int32)
    h[0] = q[0]
    h[1::97] = np.iinfo(np.int32).max
    q[1] = np.iinfo(np.int32).max
    return h, q


def _topk_check(h, q, k, ok):
    before = common.launch_counts()
    kv, kr = circrun_topk(h, q, k, ok)
    after = common.launch_counts()
    chunks = -(-q.shape[0] // circrun_ops.stored_layout(*h.shape)[2])
    assert after["circrun_topk"] == before["circrun_topk"] + chunks
    assert after["circrun"] == before["circrun"] + chunks
    pv, pr = circrun_topk_plain(h, q, k, ok)
    assert kv.dtype == torch.int32 and kv.shape == (q.shape[0], k)
    assert torch.equal(kv, pv) and torch.equal(kr, pr)
    return kv, kr


@pytest.mark.parametrize("k", [1, 100, "n", "limit"])
@pytest.mark.parametrize("m", [5, 16, 64, 100, 300])
def test_circrun_topk_kernel_bit_identical(dev, m, k):
    """The fused route against its plain version (circrun_ref + the unique-key
    top-k), bit for bit: no mask, a partly dead mask, an all-dead mask; k = 1,
    100, n and the kernel's limit; B and n off every tile."""
    n, B = (3000 if k == "n" else 5000) + m, 45
    h, q = (torch.from_numpy(a).to(dev) for a in _circ_strings(n, m, B, 3, seed=m))
    k = {"n": n, "limit": circrun_ops.MAX_K}.get(k, k)
    rng = np.random.default_rng(m + 1)
    for ok in (None, torch.from_numpy(rng.random(n) < 0.7).to(dev),
               torch.zeros(n, dtype=torch.bool, device=dev)):
        kv, kr = _topk_check(h, q, k, ok)
        if ok is not None and not bool(ok.any()):
            assert bool((kv == -1).all())
    kv, kr = _topk_check(h, q, k, None)
    assert int(kv[0, 0]) == m and int(kr[0, 0]) == 0  # the all-match row


@pytest.mark.parametrize("B,n", [(1000, 65_536), (256, 1_000_000)])
def test_circrun_topk_kernel_at_path_shapes(dev, B, n):
    """The delta buffer's shape (1,000 queries x 2^16 slots, a dead share)
    and one card chunk of the bruteforce source (256 queries x 10^6 rows),
    m = 64, k = 100, alphabet 3 (many tied lengths at the cut)."""
    h, q = (torch.from_numpy(a).to(dev) for a in _circ_strings(n, 64, B, 3, seed=n))
    ok = None
    if n < 1_000_000:
        ok = torch.from_numpy(np.random.default_rng(1).random(n) < 0.9).to(dev)
    _topk_check(h, q, 100, ok)


def test_circrun_topk_kernel_counts_a_launch_a_chunk(dev, monkeypatch):
    """Queries go in chunks of stored lengths (NARROW_BYTES, whole groups of
    32 queries): one scorer and one select launch each."""
    h, q = (torch.from_numpy(a).to(dev) for a in _circ_strings(3000, 64, 100, 3, seed=2))
    monkeypatch.setattr(circrun_ops, "NARROW_BYTES", 40 * 3008)  # 40 -> 32 queries a chunk
    assert circrun_ops.stored_layout(3000, 64) == (torch.uint8, 3008, 32)
    before = common.launch_counts()["circrun_topk"]
    _topk_check(h, q, 50, None)
    assert common.launch_counts()["circrun_topk"] == before + 4


def test_circrun_topk_kernel_rejects_what_it_does_not_take(dev):
    """k up to 4,096 and n; m up to 512; int32 strings, a bool mask."""
    h = torch.zeros((5000, 64), dtype=torch.int32, device=dev)
    q = torch.zeros((3, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=str(circrun_ops.MAX_K)):
        circrun_topk(h, q, circrun_ops.MAX_K + 1)
    with pytest.raises(ValueError, match="k must lie"):
        circrun_topk(h[:10], q, 11)
    with pytest.raises(ValueError, match="512"):
        circrun_topk(torch.zeros((10, 513), dtype=torch.int32, device=dev),
                     torch.zeros((3, 513), dtype=torch.int32, device=dev), 5)
    with pytest.raises(TypeError, match="dtype"):
        circrun_topk(h.long(), q, 5)
    with pytest.raises(TypeError, match="dtype"):
        circrun_topk(h, q, 5, torch.ones(5000, dtype=torch.int32, device=dev))
    vals, rows = circrun_topk(h, q, 0)
    assert vals.shape == (3, 0) and rows.shape == (3, 0)


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
    assert after["pool_topk"] > before["pool_topk"]
    assert after["circrun_topk"] > before["circrun_topk"]


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_attn_kernel_matches_plain(dev, name):
    """tests/torch_flash_cases.py: gemma-2b's serving shape, head widths
    padded to the kernel's 64-column steps (100 and 200 not a multiple of
    the MMA's k), lengths off its tiles, Sq > Skv (leading rows 0), GQA
    groups of 1, 2 and 8, a window narrower than a key tile, the softcap at
    scores ~100, q or v scaled by 30."""
    q, k, v, kw = make_flash_case(name)
    q, k, v = (torch.from_numpy(t).to(dev) for t in (q, k, v))
    B, Sq, Hq, dh = q.shape
    before = common.launch_counts()["flash_attn"]
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert common.launch_counts()["flash_attn"] == before + 1
    ref = flash_attention_ref(q, k, v, **kw)
    assert out.shape == (B, Sq, Hq, dh) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    empty = max(0, Sq - k.shape[1]) if kw["causal"] else 0
    assert torch.equal(out[:, :empty], torch.zeros_like(out[:, :empty]))


@pytest.mark.parametrize("name", ["gemma-2b serving", "window + softcap", "dh 100"])
def test_flash_attn_kernel_is_deterministic(dev, name):
    """Two launches on the same input give the same bits (no atomics, a
    fixed order of every sum)."""
    q, k, v, kw = make_flash_case(name)
    q, k, v = (torch.from_numpy(t).to(dev) for t in (q, k, v))
    a = flash_attention(q, k, v, **kw)
    b = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_flash_attn_kernel_rejects_what_it_does_not_take(dev):
    q, kv = torch.zeros((1, 4, 2, 300), device=dev), torch.zeros((1, 4, 1, 300), device=dev)
    with pytest.raises(ValueError, match="dh"):
        flash_attention(q, kv, kv)
    q, kv = torch.zeros((1, 4, 3, 8), device=dev), torch.zeros((1, 4, 2, 8), device=dev)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), kv, kv)


@pytest.mark.parametrize("grad_input", [0, 1, 2])
def test_flash_attn_kernel_refuses_grad(dev, grad_input):
    """The kernel no longer refuses grad: with grad mode on and an input
    that requires grad, the call goes through `FlashAttention` (one forward
    launch that also writes the log-sum-exp), its output carries a grad_fn,
    and backward launches the backward kernel once and fills only the
    inputs that require grad; under no_grad it is the plain launch."""
    q, k, v = (torch.randn((1, 4, 2, 8), device=dev) for _ in range(3))
    ins = [q, k[:, :, :1].contiguous(), v[:, :, :1].contiguous()]
    ins[grad_input].requires_grad_()
    before = common.launch_counts()
    out = flash_attention(*ins)
    assert out.grad_fn is not None
    out.sum().backward()
    torch.cuda.synchronize()
    after = common.launch_counts()
    assert after["flash_attn"] == before["flash_attn"] + 1
    assert after["flash_attn_bwd"] == before["flash_attn_bwd"] + 1
    assert [t.grad is not None for t in ins] == [i == grad_input for i in range(3)]
    with torch.no_grad():
        assert flash_attention(*ins).grad_fn is None
    assert common.launch_counts()["flash_attn_bwd"] == after["flash_attn_bwd"]


# the backward on the card against its plain version: each of dq, dk and dv
# within 2e-4 of that tensor's largest entry (the forward's 3xTF32 output
# and lse, float32 sums in the kernel's order, ex2 and rcp ulps); the lse
# within FLASH_TOL where a row sees a key, +inf exactly where it sees none
BWD_REL_TOL = 2e-4
BWD_CUDA_CASES = {**{n: ("bwd", n) for n in BWD_CASES},
                  **{n: ("fwd", n) for n in ("128-row tiles", "128-row tiles, window + softcap",
                                             "dh 200", "whisper encoder", "Sq > Skv",
                                             "gemma-2b serving")}}


def _bwd_case(dev, name):
    kind, key = BWD_CUDA_CASES[name]
    if kind == "bwd":
        q, k, v, do, kw = make_bwd_case(key)
    else:
        q, k, v, kw = make_flash_case(key)
        do = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    return (*(torch.from_numpy(t).to(dev) for t in (q, k, v, do)), kw)


@pytest.mark.parametrize("name", list(BWD_CUDA_CASES))
def test_flash_attn_bwd_kernel_matches_plain(dev, name):
    q, k, v, do, kw = _bwd_case(dev, name)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    before = common.launch_counts()
    out = flash_attention(qa, ka, va, **kw)
    out.backward(do)
    torch.cuda.synchronize()
    after = common.launch_counts()
    assert after["flash_attn"] == before["flash_attn"] + 1
    assert after["flash_attn_bwd"] == before["flash_attn_bwd"] + 1
    o_ref, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(out.detach(), o_ref, rtol=1e-4, atol=1e-4)
    _, lse = flash_ops._forward(q, k, v, kw["causal"], kw["window"], kw["softcap"], True)
    finite = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), finite) and bool(torch.isinf(lse[~finite]).all())
    torch.testing.assert_close(lse[finite], lse_ref[finite], rtol=1e-4, atol=1e-4)
    ref = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    for got, want, tag in zip((qa.grad, ka.grad, va.grad), ref, ("dq", "dk", "dv")):
        assert bool(torch.isfinite(got).all()), tag
        err = float((got - want).abs().max())
        assert err <= BWD_REL_TOL * max(float(want.abs().max()), 1e-30), (tag, err)


@pytest.mark.parametrize("name", ["causal", "window + softcap", "128-row tiles", "dh 200"])
def test_flash_attn_bwd_kernel_is_deterministic(dev, name):
    """No atomics, every sum in one order: two backward launches give the
    same bits."""
    q, k, v, do, kw = _bwd_case(dev, name)
    o, lse = flash_ops._forward(q, k, v, kw["causal"], kw["window"], kw["softcap"], True)
    a = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    b = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_flash_attn_forward_lse_leaves_serving_unchanged(dev):
    """The null lse pointer: the serving launch writes the same bits as
    the launch that also writes the lse."""
    q, k, v, kw = make_flash_case("gemma-2b serving")
    q, k, v = (torch.from_numpy(t).to(dev) for t in (q, k, v))
    plain = flash_attention(q, k, v, **kw)
    with_lse, _ = flash_ops._forward(q, k, v, kw["causal"], kw["window"], kw["softcap"], True)
    torch.cuda.synchronize()
    assert torch.equal(plain.view(torch.int32), with_lse.view(torch.int32))


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma2-9b", "qwen3-moe-235b-a22b"])
def test_train_step_smoke_card_matches_cpu(dev, arch):
    """One float32 train step of a smoke model on the card (flash_attn and
    its backward kernel once an attention layer) against the same step on
    the CPU from the same weights and batch: loss and grad norm rtol 1e-4,
    the parameters within 5e-4."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import lm_token_batches
    from repro_torch.models.convert import params_to_reference
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.step import TrainState

    cfg = ARCHS[arch].smoke()
    cpu = init_train_state(cfg, seed=0, device="cpu")
    card = init_train_state(cfg, seed=0, device=dev)
    with torch.no_grad():
        for p, c in zip(card.model.parameters(), cpu.model.parameters()):
            p.copy_(c)
    toks, labels = lm_token_batches(cfg.vocab, seed=0)(0, 4, 32)
    b = {"tokens": toks, "labels": labels}
    step = make_train_step(cfg, lambda s: 1e-3, compute_dtype=torch.float32)
    before = common.launch_counts()
    card2, mc = step(card, b)
    torch.cuda.synchronize()
    n_attn = sum(kind in ("attn", "global", "local", "dense", "moe") for kind in
                 list(cfg.pattern) * cfg.repeats + list(cfg.tail))
    after = common.launch_counts()
    assert after["flash_attn"] - before["flash_attn"] == n_attn
    assert after["flash_attn_bwd"] - before["flash_attn_bwd"] == n_attn
    cpu2, mp = step(cpu, b)
    for key in ("loss", "grad_norm"):
        assert float(mc[key]) == pytest.approx(float(mp[key]), rel=1e-4), key
    pc, pp = params_to_reference(cfg, card2.model), params_to_reference(cfg, cpu2.model)
    for a, c in zip(jax_free_leaves(pc), jax_free_leaves(pp)):
        np.testing.assert_allclose(a, c, rtol=0, atol=5e-4)
    assert isinstance(card2, TrainState)


def jax_free_leaves(tree):
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in jax_free_leaves(tree[key])]
    return [tree]


@pytest.mark.parametrize("B,L,D,N,seq_chunk", [
    (32, 32, 8192, 16, 2048),   # falcon-mamba-7b's serving shape
    (3, 77, 200, 16, 2048),     # odd L and D
    (2, 100, 130, 5, 33),       # seq_chunk < L: still one launch
    (1, 1, 1, 1, 1),
    *[(2, 33, 200, N, 2048) for N in (1, 3, 4, 5, 13, 16)],  # 1, 2 and 4 lanes a channel
    *[(3, L, 200, 16, 2048) for L in (1, 31, 32, 33)],  # around the 32-step tile
    (1, 4096, 8192, 16, 2048),  # one batch row, 128 tiles
    (4, 2048, 520, 16, 33),     # the long shape's L, D not a multiple of 64
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
    assert common.launch_counts()["ssm_scan"] == before + 1  # [0, L) in one launch
    y_ref, h_ref = ssm_scan_batched_ref(dt, x, Bc, Cc, A, h0)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, h_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_ssm_scan_kernel_on_the_scan_cases(dev, name):
    """The shared scan cases (tests/torch_scan_cases.py: N 1 to 16, L around
    the tile, exp(dt A) underflowing, h0 zero): the kernel against its plain
    version and against the plain mirror of its lanes and exp2."""
    args = [torch.from_numpy(a).to(dev) for a in make_scan_case(name)]
    y, h = ssm_scan(*args)
    for y_ref, h_ref in (ssm_scan_batched_ref(*args), lanes_mirror(*args)):
        torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(h, h_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,L,D,N", [(2, 100, 130, 16), (1, 4096, 256, 5), (32, 40, 8192, 16)])
def test_ssm_scan_kernel_ignores_seq_chunk(dev, B, L, D, N):
    """On the card seq_chunk does not split the scan: each call is one
    launch, and chunks of 33 steps give the bits of one chunk of L."""
    rng = np.random.default_rng(L + N)
    f = lambda *shape, s=1.0: torch.from_numpy(  # noqa: E731
        (rng.normal(size=shape) * s).astype(np.float32)).to(dev)
    args = (torch.nn.functional.softplus(f(B, L, D)), f(B, L, D), f(B, L, N), f(B, L, N),
            -torch.exp(f(D, N, s=0.5)), f(B, D, N))
    out = {}
    for chunk in (33, L):
        before = common.launch_counts()["ssm_scan"]
        out[chunk] = ssm_scan(*args, seq_chunk=chunk)
        torch.cuda.synchronize()
        assert common.launch_counts()["ssm_scan"] == before + 1
    assert torch.equal(out[33][0], out[L][0]) and torch.equal(out[33][1], out[L][1])


def test_ssm_scan_kernel_refuses_grad(dev):
    B, L, D, N = 2, 5, 8, 4
    ins = [torch.rand((B, L, D), device=dev), torch.randn((B, L, D), device=dev),
           torch.randn((B, L, N), device=dev), torch.randn((B, L, N), device=dev),
           -torch.rand((D, N), device=dev), torch.zeros((B, D, N), device=dev)]
    for i in range(len(ins)):
        args = [t.detach().requires_grad_(j == i) for j, t in enumerate(ins)]
        with pytest.raises(RuntimeError, match="no backward"):
            ssm_scan(*args)
        with torch.inference_mode():
            ssm_scan(*args)


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


@pytest.mark.parametrize("B,Skv,Hq,Hkv,dh,window,softcap", [
    (4, 704, 28, 4, 128, 0, 0.0),      # qwen2-7b's last decode step
    (4, 512, 4, 1, 256, 512, 0.0),     # gemma3-1b's local layer, a full window
    (3, 40, 8, 2, 256, 16, 50.0),      # window + softcap (gemma2's smoke)
    (2, 1, 4, 1, 64, 0, 30.0),         # the first token
    (4, 704, 64, 4, 128, 0, 0.0),      # qwen3-moe's last decode step, G 16
    (4, 704, 40, 8, 128, 0, 0.0),      # llama4-maverick's, G 5
    (4, 704, 32, 32, 112, 0, 0.0),     # zamba2-7b's shared block, G 1, dh 112
])
def test_flash_attn_kernel_at_one_query(dev, B, Skv, Hq, Hkv, dh, window, softcap):
    """Decode's shape: one query at key position Skv - 1 (the aligned ends)
    over the cache's live keys, within rtol/atol 1e-4 of the plain version."""
    g = torch.Generator(device=dev)
    g.manual_seed(Skv)
    q, k, v = (torch.randn((B, S, H, dh), generator=g, device=dev)
               for S, H in ((1, Hq), (Skv, Hkv), (Skv, Hkv)))
    kw = dict(causal=True, window=window, softcap=softcap)
    before = common.launch_counts()["flash_attn"]
    out = flash_attention(q, k, v, **kw)
    assert common.launch_counts()["flash_attn"] == before + 1
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, **kw), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma3-1b", "gemma2-9b", "falcon-mamba-7b",
                                  "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                                  "zamba2-7b"])
def test_smoke_decode_on_card_matches_cpu(dev, arch):
    """The same smoke-size weights on both devices, with the CPU tests'
    tolerances (tests/test_torch_decode.py): the loss and prefill of 24
    tokens (past the smoke window of 16) within rtol 1e-4 / atol 1e-5, then
    8 decode steps fed the CPU's greedy tokens, their logits within 2^-8 of
    the largest CPU logit (a cache entry may round one bf16 step apart) and
    the card's greedy token the CPU's unless the CPU's top two are closer
    than that; each step on the card launched the model's kernel once a
    layer that runs it (zamba2-7b: flash_attn at its two shared places, its
    Mamba-2 layers plain torch).  After the steps, K and V at the prompt's positions within one
    bf16 step + rtol 1e-4 / atol 1e-5 (prefill's bound: decode must leave
    them as they were); at the decode positions, and the conv tail and
    state, within 2^-8 of the largest CPU value (+ one bf16 step for K and
    V): decode computes them from hidden states that the steps' bf16 reads
    move apart by more than rtol 1e-4."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import decode_step, init_model, loss_fn, prefill
    from repro_torch.models.attention import KVCache
    from repro_torch.models.blocks import ATTN_KINDS

    tol, rel = dict(rtol=1e-4, atol=1e-5), 2.0 ** -8
    cfg = ARCHS[arch].smoke()
    cpu = init_model(cfg, seed=0, device="cpu")
    card = init_model(cfg, seed=0, device="cpu").to(dev)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, 25))
    kernel = "ssm_scan" if cfg.family == "ssm" else "flash_attn"
    kinds = [layer.kind for layer in card.layers]
    layers = kinds.count("m1") if kernel == "ssm_scan" else sum(k in ATTN_KINDS for k in kinds)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.no_grad():
        torch.testing.assert_close(loss_fn(card, batch)[0].cpu(), loss_fn(cpu, batch)[0], **tol)
    lc, cc = prefill(cpu, {"tokens": toks[:, :-1]}, 32)
    lg, cg = prefill(card, {"tokens": toks[:, :-1]}, 32)
    torch.testing.assert_close(lg.cpu(), lc, **tol)
    for _ in range(8):
        top2 = lc.topk(2, dim=-1).values
        near_tie = (top2[:, 0] - top2[:, 1]) <= 2 * rel * float(lc.abs().max())
        tc = lc.argmax(-1, keepdim=True)
        assert bool(((tc == lg.argmax(-1, keepdim=True).cpu())[:, 0] | near_tie).all())
        before = common.launch_counts()[kernel]
        lg, cg = decode_step(card, tc, cg)
        assert common.launch_counts()[kernel] - before == layers
        lc, cc = decode_step(cpu, tc, cc)
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=rel * float(lc.abs().max()))
    prompt = toks.shape[1] - 1
    for a, b in zip(cg, cc):
        for x, y in zip(a[:2], b[:2]):
            x, y = x.cpu().float(), y.float()
            loose = torch.full_like(x, rel * float(y.abs().max()))
            if isinstance(a, KVCache):
                mag = torch.maximum(x.abs(), y.abs())
                _, e = torch.frexp(mag)
                step = torch.ldexp(torch.ones_like(x), e - 8)
                tight = step + tol["atol"] + tol["rtol"] * mag
                bound = torch.cat([tight[:, :prompt], (loose + step)[:, prompt:]], 1)
            else:
                bound = loose
            over = float(((x - y).abs() / bound).max())
            assert over <= 1.0, f"a cache {over} x its bound apart"


def _family_on(fam, device):
    import dataclasses

    fields = {f.name: getattr(fam, f.name) for f in dataclasses.fields(fam)}
    return lsh.family_from_arrays(type(fam).__name__, {
        k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in fields.items()},
        device)


@pytest.mark.parametrize("method,metric,kw", [
    ("E2LSH", "euclidean", dict(K=4, L=8)), ("MultiProbeLSH", "euclidean", dict(K=4, L=4)),
    ("C2LSH", "euclidean", dict(m=32, l_threshold=2)), ("LinearScan", "euclidean", {}),
    ("E2LSH", "angular", dict(K=1, L=16)), ("MultiProbeLSH", "angular", dict(K=2, L=8)),
    ("FALCONNLike", "angular", dict(K=2, L=8)), ("C2LSH", "angular", dict(m=32)),
    ("LinearScan", "angular", {}),
])
def test_baseline_on_card_matches_cpu(dev, method, metric, kw):
    """Each baseline built on the card and on the CPU over one family: ids
    and last_cands equal, distances within rtol/atol 1e-5; the card's query
    launched its hash kernel and the fused verify (no plain route).  Rows
    and family are dyadic, so projections are exact on both devices."""
    from repro_torch import baselines

    rng = np.random.default_rng(11)
    X = rng.normal(size=(3000, 32)) * 3
    if metric == "angular":
        X = _dyadic(X / np.linalg.norm(X, axis=1, keepdims=True), bits=10).astype(np.float32)
        Q = X[:40] + 2.0 ** -8
    else:
        X = _dyadic(X).astype(np.float32)
        Q = X[:40] + 0.25
    cls = getattr(baselines, method)
    if method == "LinearScan":
        built = [cls.build(X, metric=metric, device=d) for d in ("cpu", dev)]
    else:
        m = kw["m"] if method == "C2LSH" else kw["K"] * kw["L"]
        if metric == "euclidean":
            fam = lsh.make_family("euclidean", 2, 32, m, device="cpu", w=4.0)
            fam.a = torch.from_numpy(_dyadic(fam.a).astype(np.float32))
            fam.b = torch.from_numpy(_dyadic(fam.b).astype(np.float32))
        else:
            fam = lsh.make_family("angular", 2, 32, m, device="cpu", rotation="gaussian")
            fam.rot = torch.from_numpy(_dyadic(fam.rot, bits=12).astype(np.float32))
        built = [cls.build(X, family=_family_on(fam, d), device=d, **kw) for d in ("cpu", dev)]
    cpu, card = built
    q = dict(k=10, lam=200, cap_per_table=64)
    ci, cd = cpu.query(Q, **q)
    before = common.launch_counts()
    gi, gd = card.query(Q, **q)
    after = common.launch_counts()
    assert gi.device.type == "cuda"
    assert torch.equal(ci, gi.cpu())
    torch.testing.assert_close(gd.cpu(), cd, rtol=1e-5, atol=1e-5)
    assert getattr(cpu, "last_cands", None) == getattr(card, "last_cands", None)
    if method != "LinearScan":
        hash_kernel = "hash_xp" if metric == "angular" else "hash_rp"
        assert after[hash_kernel] > before[hash_kernel]
        assert after["gather_l2_topk"] > before["gather_l2_topk"]
