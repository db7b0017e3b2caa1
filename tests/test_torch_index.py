"""Port parity for the slice as a whole: an index built and saved by the
reference, loaded by the port, searched by both.

  * given the same query hash strings, the candidate sets (ids and lcps) are
    identical, for every source x store x `use_probe_kernel`;
  * final ids are identical except where two distances differ by < 1e-6,
    and distances agree within rtol 1e-5 / atol 1e-5 (fp32 summation order);
  * the port's `save` is read back by the reference's `load`.
"""
import numpy as np
import pytest
import torch

from repro.core import LCCSIndex as RefIndex
from repro.core import SearchParams as RefParams
from repro.exec import stages as ref_stages
from repro_torch.core import LCCSIndex, SearchParams
from repro_torch.exec import stages

torch.set_num_threads(2)

N, D, M = 1200, 16, 12
SOURCES = ["lccs", "multiprobe-skip", "multiprobe-full", "bruteforce"]


def _data(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, D)) * 3.0
    X = (centers[rng.integers(0, 20, N)] + rng.normal(size=(N, D))).astype(np.float32)
    Q = (X[rng.choice(N, 12, replace=False)]
         + 0.05 * rng.normal(size=(12, D))).astype(np.float32)
    return X, Q


@pytest.fixture(scope="module", params=["fp32", "bf16", "int8"])
def pair(request, tmp_path_factory):
    X, Q = _data()
    ref = RefIndex.build(X, m=M, family="euclidean", w=4.0, seed=1, store=request.param)
    path = tmp_path_factory.mktemp("idx") / f"{request.param}.pkl"
    ref.save(path)
    return ref, LCCSIndex.load(path, device="cpu"), Q


def _assert_same_results(ref_out, ours, tol=1e-6):
    r_ids, r_d = (np.asarray(x) for x in ref_out)
    o_ids, o_d = ours[0].numpy(), ours[1].numpy()
    assert o_ids.dtype == np.int32 and o_ids.shape == r_ids.shape
    np.testing.assert_allclose(o_d, r_d, rtol=1e-5, atol=1e-5)
    for b, j in zip(*np.nonzero(o_ids != r_ids)):
        near = [abs(r_d[b, j] - r_d[b, jj]) for jj in (j - 1, j + 1) if 0 <= jj < r_d.shape[1]]
        assert min(near) < tol, (b, j, r_ids[b], o_ids[b])


@pytest.mark.parametrize("use_probe_kernel", [False, True])
@pytest.mark.parametrize("source", SOURCES)
def test_candidates_and_results_match(pair, source, use_probe_kernel):
    ref, ours, Q = pair
    kw = dict(k=5, lam=48, width=24, source=source, probes=5,
              use_probe_kernel=use_probe_kernel, use_gather_kernel=use_probe_kernel)
    # the same query hash strings into both probe stages
    qh = ref_stages.hash_queries(ref.family, Q)
    r_ids, r_lcps = ref_stages.probe(ref, Q, qh, RefParams(**kw))
    o_ids, o_lcps = stages.probe(ours, torch.from_numpy(Q),
                                 torch.from_numpy(np.array(qh)), SearchParams(**kw))
    assert np.array_equal(o_ids.numpy(), np.asarray(r_ids))
    assert np.array_equal(o_lcps.numpy(), np.asarray(r_lcps))
    _assert_same_results(ref.search(Q, RefParams(**kw)), ours.search(Q, SearchParams(**kw)))


def test_self_retrieval_and_bytes(pair):
    ref, ours, Q = pair
    X = ours.data[:8].clone()
    ids, _ = ours.search(X, SearchParams(k=3, lam=32, width=32))
    assert (ids[:, 0].numpy() == np.arange(8)).mean() >= 0.75
    assert ours.index_bytes() == ref.index_bytes()
    assert ours.store_bytes() == ref.store_bytes()


@pytest.mark.parametrize("family,kw", [("euclidean", dict(w=4.0)), ("angular", {}),
                                       ("angular", dict(rotation="gaussian"))])
def test_port_save_reference_load(tmp_path, family, kw):
    X, Q = _data(1)
    ours = LCCSIndex.build(X, m=M, family=family, seed=2, store="int8", device="cpu", **kw)
    ours.save(tmp_path / "p.pkl")
    ref = RefIndex.load(tmp_path / "p.pkl")
    assert np.array_equal(np.asarray(ref.h), ours.h.numpy())
    for a, b in zip(ref.csa, ours.csa.tables()):
        assert np.array_equal(np.asarray(a), b.numpy())
    p = dict(k=5, lam=48, width=24)
    _assert_same_results(ref.search(Q, RefParams(**p)), ours.search(Q, SearchParams(**p)))
    back = LCCSIndex.load(tmp_path / "p.pkl", device="cpu")
    assert torch.equal(back.search(Q, SearchParams(**p))[0], ours.search(Q, SearchParams(**p))[0])


def test_disk_tail_roundtrip(tmp_path):
    X, Q = _data(2)
    ref = RefIndex.build(X, m=M, family="euclidean", w=4.0, store="int8",
                         tail_path=tmp_path / "ref_tail.npy")
    ref.save(tmp_path / "r.pkl")
    ours = LCCSIndex.load(tmp_path / "r.pkl", device="cpu")
    assert ours.tail is None and ours.tail_path
    p = dict(k=5, lam=48, width=24, source="multiprobe-skip", probes=5)
    _assert_same_results(ref.search(Q, RefParams(**p)), ours.search(Q, SearchParams(**p)))
    built = LCCSIndex.build(X, m=M, family="euclidean", w=4.0, store="int8", device="cpu",
                            tail_path=tmp_path / "port_tail")
    assert built.tail is None and built.tail_path.endswith(".npy")
    assert built.search(Q, SearchParams(**p))[0].shape == (12, 5)


def test_kernel_toggles_resolve_from_env_and_device(monkeypatch):
    monkeypatch.delenv(stages.ENV_PROBE_KERNEL, raising=False)
    monkeypatch.delenv(stages.ENV_GATHER_KERNEL, raising=False)
    assert stages.resolve_use_probe_kernel(None, torch.device("cpu")) is False
    assert stages.resolve_use_probe_kernel(None, "cuda") is True
    assert stages.resolve_use_kernel(None, "cuda:0") is True
    assert stages.resolve_use_kernel(False, "cuda") is False
    monkeypatch.setenv(stages.ENV_PROBE_KERNEL, "1")
    monkeypatch.setenv(stages.ENV_GATHER_KERNEL, "off")
    assert stages.resolve_use_probe_kernel(None, "cpu") is True
    assert stages.resolve_use_kernel(None, "cuda") is False
