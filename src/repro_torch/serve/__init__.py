"""Retrieval serving over the port's models and indexes."""
from .engine import RetrievalEngine, ServeStats

__all__ = ["RetrievalEngine", "ServeStats"]
