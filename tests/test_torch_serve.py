"""Port parity for the serving path (`repro_torch.serve`, `repro_torch.launch`):

  1. The port's engine embeds like the reference's engine, with the weights
     carried across: rtol 1e-4 / atol 1e-5 (float32 through the smoke
     models, another summation order).
  2. Fed the reference's embeddings and its LSH family (carried across with
     `family_from_arrays`), the port's engine serves the same ids as the
     reference's engine -- `serve_batch` on a static index, and a
     `serve_stream` with an insert / delete / compact burst on a dynamic
     one -- with distances within rtol/atol 1e-5.
  3. The CLI serves a smoke model on the CPU, and the engine refuses a
     sharded or chunked dynamic build, updates to a static index and,
     without a device, a missing CUDA.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.core import SearchParams as RefParams
from repro.data.synthetic import lm_token_batches as ref_lm_token_batches
from repro.models import api as ref_api
from repro.serve import RetrievalEngine as RefEngine
from repro_torch.configs import ARCHS
from repro_torch.core import SearchParams, family_from_arrays
from repro_torch.core import lsh as lsh_mod
from repro_torch.data import lm_token_batches
from repro_torch.launch.serve import request_stream
from repro_torch.models import init_model, params_from_reference
from repro_torch.serve import RetrievalEngine

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
EMB_TOL = dict(rtol=1e-4, atol=1e-5)
N_CORPUS, N_REQ, M, MAX_BATCH = 64, 24, 16, 16


def _engines(arch):
    ref_cfg, cfg = REF_ARCHS[arch].smoke(), ARCHS[arch].smoke()
    params = ref_api.init_model(jax.random.key(0), ref_cfg)
    model = params_from_reference(cfg, jax.tree.map(np.asarray, params), "cpu")
    kw = dict(m=M, metric="angular", max_batch=MAX_BATCH)
    ref = RefEngine(ref_cfg, params, search_params=RefParams(k=5, lam=32), **kw)
    ours = RetrievalEngine(cfg, model, search_params=SearchParams(k=5, lam=32),
                           device="cpu", **kw)
    corpus, _ = lm_token_batches(vocab=cfg.vocab, seed=0)(0, N_CORPUS, 32)
    return ref, ours, corpus


@pytest.fixture(scope="module", params=["gemma-2b", "falcon-mamba-7b"])
def engines(request):
    return _engines(request.param)


def test_embeddings_match_reference(engines):
    ref, ours, corpus = engines
    want = np.asarray(ref.embed(corpus))
    got = ours.embed(corpus)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **EMB_TOL)
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=1).numpy(), 1.0, rtol=1e-5)


def _carry_reference(ref, ours, monkeypatch):
    """Let the port's engine embed through the reference's embeddings and
    build its index with the reference's family."""
    ours.embed = lambda toks: torch.from_numpy(np.array(ref.embed(toks)))

    def carried(*args, **kw):
        fam = ref.index.family
        fields = {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
                  for f in dataclasses.fields(fam) for v in [getattr(fam, f.name)]}
        return family_from_arrays(type(fam).__name__, fields, "cpu")

    monkeypatch.setattr(lsh_mod, "make_family", carried)


def test_serve_batch_matches_reference(engines, monkeypatch):
    ref, ours, corpus = engines
    ref.build_index(corpus)
    _carry_reference(ref, ours, monkeypatch)
    ours.build_index(corpus)
    picks, reqs = request_stream(corpus, N_REQ)
    r_ids, r_d = ref.serve_batch(np.stack(reqs))
    o_ids, o_d = ours.serve_batch(np.stack(reqs))
    np.testing.assert_array_equal(o_ids, r_ids)
    np.testing.assert_allclose(o_d, r_d, rtol=1e-5, atol=1e-5)
    assert sum(int(p in ids) for p, ids in zip(picks, o_ids)) >= 0.9 * N_REQ
    assert ours.stats.requests == N_REQ and ours.stats.batches == 1


def test_serve_stream_with_churn_matches_reference(engines, monkeypatch):
    ref, ours, corpus = engines
    ref.build_index(corpus, dynamic=True)
    _carry_reference(ref, ours, monkeypatch)
    ours.build_index(corpus, dynamic=True)
    extra, _ = lm_token_batches(vocab=ours.cfg.vocab, seed=0)(1, MAX_BATCH, 32)
    picks, stream = request_stream(corpus, N_REQ, extra)  # the launcher's stream
    mid = N_REQ // 2
    assert stream[mid][0] == "insert" and stream[mid + 2] == ("compact",)
    deleted = stream[mid + 1][1]
    np.testing.assert_array_equal(deleted, np.arange(0, N_CORPUS, N_CORPUS // 8))
    r_out = ref.serve_stream(stream)
    o_out = ours.serve_stream(stream)
    assert len(o_out) == len(r_out) == len(stream)
    for r, o in zip(r_out, o_out):
        if isinstance(r[0], str):
            assert o[0] == r[0]
            np.testing.assert_array_equal(np.asarray(o[1]), np.asarray(r[1]))
        else:
            np.testing.assert_array_equal(o[0], r[0])
            np.testing.assert_allclose(o[1], r[1], rtol=1e-5, atol=1e-5)
    after = [o for o in o_out[mid + 3:]]
    assert not any(np.isin(ids, deleted).any() for ids, _ in after)
    s = ours.stats
    assert (s.inserts, s.deletes, s.compactions) == (MAX_BATCH, len(deleted), 1)


@pytest.mark.parametrize("vocab,seed,step", [(512, 0, 0), (256000, 0, 1), (65024, 3, 7)])
def test_lm_token_batches_equal_reference(vocab, seed, step):
    got = lm_token_batches(vocab, seed=seed)(step, 9, 32)
    want = ref_lm_token_batches(vocab, seed=seed)(step, 9, 32)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_cli_serves_a_smoke_model_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma-2b", "--smoke",
         "--device", "cpu", "--corpus", "64", "--requests", "32", "--m", "16"],
        capture_output=True, text=True, timeout=300,
        env={**{k: os.environ[k] for k in ("HOME", "TMPDIR") if k in os.environ},
             "PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "indexed 64 docs" in out.stdout
    hits = re.search(r"self-retrieval (\d+)/32", out.stdout)
    assert hits and int(hits.group(1)) >= 29, out.stdout


def test_engine_refuses_what_is_not_ported():
    """What the engine refuses: a sharded or chunked *dynamic* build (the
    sharded layout is static, and a dynamic corpus ingests out of core
    through `ingest_chunks`), and corpus updates against a static index."""
    cfg = ARCHS["gemma-2b"].smoke()
    model = init_model(cfg, device="cpu")
    toks = np.zeros((4, 8), np.int32)
    with pytest.raises(ValueError, match="mutually exclusive"):
        RetrievalEngine(cfg, model, m=8, shards=2, device="cpu").build_index(toks, dynamic=True)
    eng = RetrievalEngine(cfg, model, m=8, device="cpu")
    with pytest.raises(ValueError, match="ingest_chunks"):
        eng.build_index(toks, dynamic=True, chunk_rows=2)
    eng.build_index(toks)
    with pytest.raises(ValueError, match="dynamic=True"):
        eng.serve_stream([toks[0], ("delete", [0])])
    with pytest.raises(TypeError, match="dynamic=True"):
        eng.insert(toks)


def test_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to CUDA")
    cfg = ARCHS["gemma-2b"].smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalEngine(cfg, init_model(cfg, device="cpu"))
