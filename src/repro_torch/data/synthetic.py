"""Synthetic corpora (numpy; copy of `repro.data.synthetic`'s vector
generators and its token stream, so the same seed gives the same data in
both packages).

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
