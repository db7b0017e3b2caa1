"""Synthetic corpora and token documents for tests, the serving launcher and
the on-card smoke run."""
from .synthetic import clustered_vectors, lm_token_batches, paper_dataset_analogue, queries_from

__all__ = ["clustered_vectors", "lm_token_batches", "paper_dataset_analogue", "queries_from"]
