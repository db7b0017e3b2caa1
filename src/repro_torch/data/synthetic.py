"""Synthetic corpora (numpy; copy of `repro.data.synthetic`'s vector
generators, their chunked forms for out-of-core builds, and its token
stream, so the same seed gives the same data in both packages).

Vector datasets are Gaussian-mixture clones shaped like the paper's datasets;
token documents follow a Zipf marginal with a deterministic "grammar".
"""
from __future__ import annotations

import numpy as np


def clustered_vectors(
    n: int,
    d: int,
    *,
    n_clusters: int = 100,
    cluster_scale: float = 5.0,
    noise: float = 1.0,
    seed: int = 0,
    normalize: bool = False,
    dtype=np.float32,
):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * cluster_scale
    assign = rng.integers(0, n_clusters, n)
    X = centers[assign] + rng.normal(size=(n, d)) * noise
    if normalize:
        X /= np.linalg.norm(X, axis=1, keepdims=True)
    return X.astype(dtype)


def clustered_vector_chunks(
    n: int,
    d: int,
    *,
    chunk_rows: int,
    n_clusters: int = 100,
    cluster_scale: float = 5.0,
    noise: float = 1.0,
    seed: int = 0,
    normalize: bool = False,
    dtype=np.float32,
):
    """Chunked `clustered_vectors` for out-of-core builds: yields
    (<=chunk_rows, d) blocks from the same mixture (shared centers), O(chunk)
    memory, deterministic in (seed, chunk index).  The draws are per-chunk
    RNG streams, NOT the monolithic function's single stream -- same
    distribution, different samples."""
    rng0 = np.random.default_rng(seed)
    centers = rng0.normal(size=(n_clusters, d)) * cluster_scale
    for ci, lo in enumerate(range(0, n, chunk_rows)):
        c = min(chunk_rows, n - lo)
        rng = np.random.default_rng((seed, 1 + ci))
        assign = rng.integers(0, n_clusters, c)
        X = centers[assign] + rng.normal(size=(c, d)) * noise
        if normalize:
            X /= np.linalg.norm(X, axis=1, keepdims=True)
        yield X.astype(dtype)


def _embedding_basis(d: int, decay: float, seed: int):
    """Shared structure of the embedding-like distribution: a power-law
    singular spectrum mixed through a random orthogonal basis, plus a common
    mean offset (real encoder embeddings are anisotropic and non-centred)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    spectrum = (1.0 + np.arange(d)) ** (-decay / 2.0)
    mean = rng.normal(size=d) * 0.5
    return q * spectrum, mean


def embedding_vectors(
    n: int,
    d: int,
    *,
    decay: float = 1.0,
    seed: int = 0,
    dtype=np.float32,
):
    """An embedding-distribution stand-in (LM / encoder retrieval vectors):
    anisotropic Gaussian with power-law spectrum (std_j ~ (j+1)^(-decay/2))
    in a random basis, shifted off-centre and L2-normalized."""
    basis, mean = _embedding_basis(d, decay, seed)
    rng = np.random.default_rng((seed, 0))
    X = rng.normal(size=(n, d)) @ basis + mean
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return X.astype(dtype)


def embedding_vector_chunks(
    n: int,
    d: int,
    *,
    chunk_rows: int,
    decay: float = 1.0,
    seed: int = 0,
    dtype=np.float32,
):
    """Chunked `embedding_vectors` (shared basis/mean, per-chunk RNG
    streams): yields (<=chunk_rows, d) blocks, O(chunk) memory."""
    basis, mean = _embedding_basis(d, decay, seed)
    for ci, lo in enumerate(range(0, n, chunk_rows)):
        c = min(chunk_rows, n - lo)
        rng = np.random.default_rng((seed, 1 + ci))
        X = rng.normal(size=(c, d)) @ basis + mean
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        yield X.astype(dtype)


def paper_dataset_analogue(name: str, *, scale: float = 1.0, seed: int = 0):
    """A scaled synthetic stand-in for one of the paper's datasets
    (`configs.lccs_ann.DATASETS[name]`), with its config.  `scale` shrinks n
    (1.0 = paper size, at least 1,000 rows)."""
    from ..configs.lccs_ann import DATASETS

    cfg = DATASETS[name]
    n = max(1000, int(cfg.n * scale))
    return (
        clustered_vectors(
            n, cfg.d, seed=seed, normalize=(cfg.metric == "angular")
        ),
        cfg,
    )


def queries_from(X: np.ndarray, n_queries: int, *, jitter: float = 0.05, seed: int = 1):
    rng = np.random.default_rng(seed)
    idx = rng.choice(X.shape[0], n_queries, replace=False)
    Q = X[idx] + rng.normal(size=(n_queries, X.shape[1])).astype(X.dtype) * jitter
    return Q.astype(X.dtype)


def lm_token_batches(vocab: int, *, seed: int = 0):
    """Infinite deterministic stream factory: batch(step) -> (tokens, labels).

    Tokens follow a Zipf marginal with a deterministic "grammar": with prob
    0.5 the next token is f(prev) = (prev * 31 + 7) % vocab, else a fresh
    Zipf draw."""

    def batch(step: int, batch_size: int, seq_len: int):
        rng = np.random.default_rng((seed << 32) ^ step)
        fresh = rng.zipf(1.3, size=(batch_size, seq_len + 1)).astype(np.int64)
        fresh = np.minimum(fresh, vocab - 1)
        keep = rng.random((batch_size, seq_len + 1)) < 0.5
        toks = fresh.copy()
        for t in range(1, seq_len + 1):
            follow = (toks[:, t - 1] * 31 + 7) % vocab
            toks[:, t] = np.where(keep[:, t], follow, fresh[:, t])
        return (
            toks[:, :-1].astype(np.int32),
            toks[:, 1:].astype(np.int32),
        )

    return batch
