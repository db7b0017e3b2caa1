"""Retrieval serving over the port's models and indexes."""
from .engine import PendingBatch, RetrievalEngine, ServeStats

__all__ = ["PendingBatch", "RetrievalEngine", "ServeStats"]
