"""Fault-tolerant checkpoints of the port, in the reference's format
(PyTorch counterpart of `repro.checkpoint`)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
