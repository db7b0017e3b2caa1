"""Synthetic corpora (numpy; copy of `repro.data.synthetic`'s vector
generators, so the same seed gives the same data in both packages).

Vector datasets are Gaussian-mixture clones shaped like the paper's datasets.
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


def queries_from(X: np.ndarray, n_queries: int, *, jitter: float = 0.05, seed: int = 1):
    rng = np.random.default_rng(seed)
    idx = rng.choice(X.shape[0], n_queries, replace=False)
    Q = X[idx] + rng.normal(size=(n_queries, X.shape[1])).astype(X.dtype) * jitter
    return Q.astype(X.dtype)
