"""Port parity for the paper's comparison set (`repro_torch.baselines`) and
the pieces it shares with the index, on the CPU against the reference:

  * each baseline, built over the reference's family carried across
    (`core.lsh.family_from_arrays`), on tests/test_baselines.py's fixtures:
    ids equal, distances within rtol 1e-5 / atol 1e-6, `stats()` and
    `last_cands` equal;
  * `verify_candidates` (-1 padded), `circ_run_lengths`, the families'
    `query_alternatives`, `paper_dataset_analogue`;
  * tests/test_paper_claims.py's four non-slow claims that touch these
    modules, run on the port at the reference's thresholds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.baselines as ref_baselines
from repro.core import circ_run_lengths as ref_circ_run_lengths
from repro.core import lsh as ref_lsh
from repro.core.index import verify_candidates as ref_verify_candidates
from repro.data.synthetic import paper_dataset_analogue as ref_analogue
import repro_torch.baselines as baselines
from repro_torch.baselines import methods
from repro_torch.core import (
    LCCSIndex,
    SearchParams,
    candidates,
    circ_run_lengths,
    lsh,
    multiprobe,
    theory,
    verify_candidates,
)
from repro_torch.data import paper_dataset_analogue

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)  # fp32 summation order (tests/test_torch_gather.py)
STATIC_Q = dict(k=10, lam=300, cap_per_table=128)
# name -> (method, dataset, build kwargs, query kwargs): tests/test_baselines.py's
# cases, plus the angular E2LSH / MultiProbeLSH / C2LSH and a gaussian FALCONN-like
CASES = {
    "LinearScan": ("LinearScan", "euclidean", {}, dict(k=10)),
    "LinearScan angular": ("LinearScan", "angular", dict(metric="angular"), dict(k=10)),
    "E2LSH": ("E2LSH", "euclidean", dict(K=4, L=16, w=16.0, seed=0), STATIC_Q),
    "E2LSH, the multiprobe test's base": ("E2LSH", "euclidean", dict(K=4, L=4, w=4.0, seed=1),
                                          STATIC_Q),
    "MultiProbeLSH": ("MultiProbeLSH", "euclidean",
                      dict(K=4, L=4, w=4.0, seed=1, n_probes=8), STATIC_Q),
    "C2LSH": ("C2LSH", "euclidean", dict(m=48, w=4.0, seed=2, l_threshold=2),
              dict(k=10, lam=300)),
    "FALCONNLike": ("FALCONNLike", "angular", dict(K=1, L=16, seed=0, n_probes=4), STATIC_Q),
    "FALCONNLike gaussian": ("FALCONNLike", "angular",
                             dict(K=2, L=8, seed=0, n_probes=8, rotation="gaussian"), STATIC_Q),
    "E2LSH angular": ("E2LSH", "angular", dict(K=1, L=16, seed=0, family="angular"), STATIC_Q),
    "MultiProbeLSH angular gaussian": ("MultiProbeLSH", "angular",
                                       dict(K=2, L=8, seed=0, family="angular",
                                            rotation="gaussian", n_probes=8), STATIC_Q),
    "C2LSH angular gaussian": ("C2LSH", "angular",
                               dict(m=32, seed=0, family="angular", rotation="gaussian",
                                    l_threshold=2), dict(k=10, lam=300)),
}


@pytest.fixture(scope="module")
def data():
    """tests/test_baselines.py's two datasets: (X, Q) by metric."""
    rng = np.random.default_rng(0)
    n, d = 2000, 32
    centers = rng.normal(size=(25, d)) * 5
    X = (centers[rng.integers(0, 25, n)] + rng.normal(size=(n, d))).astype(np.float32)
    Q = X[:8] + rng.normal(size=(8, d)).astype(np.float32) * 0.05
    rng = np.random.default_rng(3)
    n, d = 1500, 64
    centers = rng.normal(size=(20, d))
    Xa = centers[rng.integers(0, 20, n)] + rng.normal(size=(n, d)) * 0.2
    Xa = (Xa / np.linalg.norm(Xa, axis=1, keepdims=True)).astype(np.float32)
    Qa = Xa[:8] + rng.normal(size=(8, d)).astype(np.float32) * 0.02
    Qa = (Qa / np.linalg.norm(Qa, axis=1, keepdims=True)).astype(np.float32)
    return {"euclidean": (X, Q), "angular": (Xa, Qa)}


def _carry(fam):
    """The reference family's arrays as a port family on the CPU (what
    `LCCSIndex.load` does)."""
    fields = {k: (np.asarray(v) if isinstance(v, jax.Array) else v)
              for k, v in dataclasses.asdict(fam).items()}
    return lsh.family_from_arrays(type(fam).__name__, fields, "cpu")


def _assert_same(ours, ref):
    o_ids, o_d = ours
    r_ids, r_d = (np.asarray(x) for x in ref)
    assert o_ids.dtype == torch.int32 and o_d.dtype == torch.float32
    assert np.array_equal(o_ids.numpy(), r_ids)
    np.testing.assert_allclose(o_d.numpy(), r_d, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_baseline_matches_reference(data, case):
    method, dataset, build_kw, query_kw = CASES[case]
    X, Q = data[dataset]
    ref = getattr(ref_baselines, method).build(X, **build_kw)
    kw = dict(build_kw)
    if hasattr(ref, "family"):
        kw["family"] = _carry(ref.family)
    ours = getattr(baselines, method).build(X, device="cpu", **kw)
    _assert_same(ours.query(Q, **query_kw), ref.query(Q, **query_kw))
    assert ours.stats() == ref.stats()
    assert getattr(ours, "last_cands", None) == getattr(ref, "last_cands", None)


@pytest.mark.parametrize("method", ["LinearScan", "C2LSH"])
def test_ties_go_to_the_lower_index(data, method):
    """Duplicated rows tie in LinearScan's distances, and C2LSH's counts are
    full of ties: both rank as `lax.top_k` does (ROADMAP C1)."""
    X, Q = data["euclidean"]
    X = np.repeat(X[:300], 4, axis=0)
    kw = {} if method == "LinearScan" else dict(m=16, w=4.0, seed=3, l_threshold=1)
    ref = getattr(ref_baselines, method).build(X, **kw)
    if method == "C2LSH":
        kw["family"] = _carry(ref.family)
    ours = getattr(baselines, method).build(X, device="cpu", **kw)
    _assert_same(ours.query(Q, k=10, lam=64), ref.query(Q, k=10, lam=64))
    assert getattr(ours, "last_cands", None) == getattr(ref, "last_cands", None)


@pytest.mark.parametrize("method", ["LinearScan", "C2LSH"])
def test_chunked_scans_equal_one_chunk(data, method, monkeypatch):
    """LinearScan's and C2LSH's chunks of queries (and rows) give the
    one-chunk result."""
    X, Q = data["euclidean"]
    Q = np.concatenate([Q, X[100:107]])
    m = baselines.LinearScan.build(X, device="cpu") if method == "LinearScan" else \
        baselines.C2LSH.build(X, m=24, w=4.0, seed=1, device="cpu")
    whole = m.query(Q, k=10, lam=50)
    monkeypatch.setattr(methods, "_SCAN_BYTES", 3 * 256 * 4 * X.shape[1])  # 3 queries x 256 rows
    monkeypatch.setattr(methods, "_COUNT_KEYS", 2 * X.shape[0] + 5)  # 2 queries
    chunked = m.query(Q, k=10, lam=50)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


@pytest.mark.parametrize("method", ["LinearScan", "E2LSH", "MultiProbeLSH", "FALCONNLike",
                                    "C2LSH"])
def test_baselines_default_to_cuda_and_raise_without_it(method):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to CUDA")
    X = np.zeros((10, 8), np.float32)
    cls = getattr(baselines, method)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls.build(X)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls.build(X, device="cuda")


def test_a_family_of_the_wrong_size_is_refused(data):
    X, _ = data["euclidean"]
    fam = lsh.make_family("euclidean", 0, X.shape[1], 12, device="cpu", w=4.0)
    with pytest.raises(ValueError, match="12 functions"):
        baselines.E2LSH.build(X, K=4, L=4, family=fam, device="cpu")


# ---------------------------------------------------------------------------
# what the baselines share with the index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_verify_candidates_matches_reference(metric):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(500, 24)).astype(np.float32)
    X[7] = 0.0  # a zero row: finite under angular
    Q = rng.normal(size=(6, 24)).astype(np.float32)
    ids = rng.integers(0, 500, size=(6, 40)).astype(np.int32)
    ids[:, 30:] = -1
    ids[1, 5:] = -1  # fewer than k candidates: id -1, dist inf
    ids[2, 0] = 7
    ids[3, :] = -1
    ref = ref_verify_candidates(jnp.asarray(X), jnp.asarray(Q), jnp.asarray(ids), 10, metric)
    ours = verify_candidates(torch.from_numpy(X), torch.from_numpy(Q), torch.from_numpy(ids),
                             10, metric)
    _assert_same(ours, ref)
    assert (ours[0][1, 5:] == -1).all() and torch.isinf(ours[1][3]).all()


def test_circ_run_lengths_matches_reference():
    rng = np.random.default_rng(5)
    h = rng.integers(0, 3, size=(300, 16)).astype(np.int32)
    h[0] = 1  # a full match: capped at m
    for q in (np.ones(16, np.int32), rng.integers(0, 3, size=16).astype(np.int32)):
        ours = circ_run_lengths(torch.from_numpy(h), torch.from_numpy(q))
        assert ours.dtype == torch.int32
        assert np.array_equal(ours.numpy(), np.asarray(ref_circ_run_lengths(h, q)))


@pytest.mark.parametrize("kind,kw", [("euclidean", dict(w=4.0)), ("angular", {}),
                                     ("angular", dict(rotation="gaussian")), ("hamming", {})])
def test_query_alternatives_match_reference(kind, kw):
    # FALCONNLike's shapes (d 64, m 16): the reference's eager ops are traced once
    ref = ref_lsh.make_family(kind, jax.random.key(6), 64, 16, **kw)
    fam = _carry(ref)
    X = np.random.default_rng(6).normal(size=(12, 64)).astype(np.float32)
    if kind == "hamming":
        X = (X > 0).astype(np.float32)
    same_hash = (fam.hash(torch.from_numpy(X)).numpy() == np.asarray(ref.hash(X))).all(axis=1)
    assert same_hash.sum() >= 10
    for q in X[same_hash]:
        v, s = fam.query_alternatives(q)
        v_ref, s_ref = ref.query_alternatives(q)
        assert isinstance(v, np.ndarray) and v.dtype == np.int32 and v.shape == v_ref.shape
        assert np.array_equal(v, np.asarray(v_ref))
        np.testing.assert_allclose(s, np.asarray(s_ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind,kw,K", [("euclidean", dict(w=4.0), 4), ("angular", {}, 2),
                                       ("angular", dict(rotation="gaussian"), 2)])
def test_batched_alternatives_give_the_per_query_probes(kind, kw, K):
    """MultiProbeLSH computes the whole batch's alternatives in one call.
    Row b equals `query_alternatives(q_b)`: the values bit for bit, the
    scores to the float32 rounding of a one-row against a many-row matmul,
    and each table's probing sequence is the same."""
    L = 8
    fam = lsh.make_family(kind, 7, 32, K * L, device="cpu", **kw)
    Q = np.random.default_rng(7).normal(size=(64, 32)).astype(np.float32)
    vals, scores = fam.alternatives(torch.from_numpy(Q))
    for b in range(Q.shape[0]):
        v, s = fam.query_alternatives(Q[b])
        assert np.array_equal(vals[b].numpy(), v)
        np.testing.assert_allclose(scores[b].numpy(), s, rtol=1e-4, atol=1e-4)
        sb, s1 = scores[b].numpy().reshape(L, K, -1), s.reshape(L, K, -1)
        for t in range(L):
            assert (multiprobe.generate_perturbations(sb[t], 8, max_gap=K)
                    == multiprobe.generate_perturbations(s1[t], 8, max_gap=K))


@pytest.mark.parametrize("name", ["sift", "sift-angular"])
def test_paper_dataset_analogue_matches_reference(name):
    X, cfg = paper_dataset_analogue(name, scale=0.002)
    X_ref, cfg_ref = ref_analogue(name, scale=0.002)
    assert X.dtype == X_ref.dtype and np.array_equal(X, X_ref)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_ref)
    assert X.shape == (2000, 128)


# ---------------------------------------------------------------------------
# tests/test_paper_claims.py's claims on these modules, run on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def claims_data():
    """tests/test_paper_claims.py's data."""
    rng = np.random.default_rng(0)
    n, d = 4000, 64
    centers = rng.normal(size=(40, d)) * 5
    X = (centers[rng.integers(0, 40, n)] + rng.normal(size=(n, d))).astype(np.float32)
    Q = X[:24] + rng.normal(size=(24, d)).astype(np.float32) * 0.1
    d2 = ((X[None] - Q[:, None]) ** 2).sum(-1)
    return X, Q, np.argsort(d2, axis=1)[:, :10]


def _recall(ids, gt):
    ids = np.asarray(ids)
    return np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist())) / gt.shape[1]
                    for i in range(gt.shape[0])])


def test_fig45_lccs_competitive_at_matched_hash_budget(claims_data):
    X, Q, gt = claims_data
    m = 64
    lccs = LCCSIndex.build(X, m=m, family="euclidean", w=16.0, seed=0, device="cpu")
    r_lccs = _recall(lccs.search(Q, SearchParams(k=10, lam=200))[0], gt)
    e2 = baselines.E2LSH.build(X, K=4, L=m // 4, w=16.0, seed=0, device="cpu")
    r_e2 = _recall(e2.query(Q, k=10, lam=200, cap_per_table=64)[0], gt)
    assert r_lccs >= r_e2 - 0.05, (r_lccs, r_e2)
    assert r_lccs >= 0.5


def test_c2lsh_counting_touches_linear_candidates(claims_data):
    X, Q, gt = claims_data
    m = 32
    c2 = baselines.C2LSH.build(X, m=m, w=16.0, seed=0, l_threshold=2, device="cpu")
    c2.query(Q, k=10, lam=200)
    counts_work = X.shape[0]  # the count runs over all n rows a query
    assert c2.h.shape[0] == counts_work
    lccs = LCCSIndex.build(X, m=m, family="euclidean", w=16.0, seed=0, device="cpu")
    lam = 200
    ids, _ = candidates(lccs, Q, SearchParams(lam=lam))
    lccs_work = int((ids >= 0).sum(dim=1).max())
    assert lccs_work <= lam < counts_work


def test_lccs_collision_statistics_monotone_in_similarity():
    rng = np.random.default_rng(0)
    d, m, w = 32, 4096, 4.0
    fam = lsh.make_family("euclidean", 5, d, m, device="cpu", w=w)
    taus = [0.25, 0.5, 1.0, 2.0, 4.0, 8.0]
    n_pairs = 24
    coll, lccs_mean = [], []
    for tau in taus:
        x = rng.normal(size=(n_pairs, d)).astype(np.float32)
        u = rng.normal(size=(n_pairs, d))
        y = x + (u / np.linalg.norm(u, axis=1, keepdims=True) * tau).astype(np.float32)
        hx, hy = fam.hash(torch.from_numpy(x)), fam.hash(torch.from_numpy(y))
        coll.append(float((hx == hy).double().mean()))
        lccs_mean.append(float(np.mean([
            int(circ_run_lengths(hx[i:i + 1], hy[i])[0]) for i in range(n_pairs)
        ])))
    assert all(a >= b - 0.02 for a, b in zip(coll, coll[1:])), coll
    assert all(a >= b - 0.5 for a, b in zip(lccs_mean, lccs_mean[1:])), lccs_mean
    assert coll[0] > coll[-1] + 0.3 and lccs_mean[0] > lccs_mean[-1] + 2.0
    for tau, c in zip(taus, coll):
        assert abs(c - theory.rp_collision_prob(tau, w)) < 0.03, (tau, c)


def test_theorem41_window_search_reaches_bruteforce_recall_floor(claims_data):
    X, Q, gt = claims_data
    idx = LCCSIndex.build(X, m=32, family="euclidean", w=16.0, seed=4, device="cpu")
    lam = 200
    r_bf = _recall(idx.search(Q, SearchParams(k=10, lam=lam, source="bruteforce"))[0], gt)
    r_win = _recall(idx.search(Q, SearchParams(k=10, lam=lam, source="lccs", width=lam))[0], gt)
    assert r_win >= r_bf - 0.02, (r_win, r_bf)
    assert r_bf >= 0.5
