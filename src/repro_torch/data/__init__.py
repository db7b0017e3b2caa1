"""Synthetic corpora for tests and the on-card smoke run."""
from .synthetic import clustered_vectors, queries_from

__all__ = ["clustered_vectors", "queries_from"]
