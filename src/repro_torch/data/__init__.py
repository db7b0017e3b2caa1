"""Synthetic corpora and token documents for tests, the serving launcher and
the on-card smoke run (the chunked generators feed out-of-core builds); the
training data path: the deterministic `DataPipeline` and the LCCS near-dup
filter (`data.dedup.NearDupFilter`)."""
from .pipeline import DataPipeline
from .synthetic import (
    clustered_vector_chunks,
    clustered_vectors,
    embedding_vector_chunks,
    embedding_vectors,
    lm_token_batches,
    paper_dataset_analogue,
    queries_from,
)

__all__ = [
    "DataPipeline",
    "clustered_vector_chunks",
    "clustered_vectors",
    "embedding_vector_chunks",
    "embedding_vectors",
    "lm_token_batches",
    "paper_dataset_analogue",
    "queries_from",
]
