"""Disk-lazy fp32 tail for the two-stage rerank path (PyTorch port of
`repro.store.tail`; numpy only, the same on-disk `.npy` format).

A quantized store answers the stage-1 approximate scan; the exact rerank of
the few surviving candidates needs the original fp32 rows, which can live on
disk as a plain ``.npy`` and be gathered lazily -- per query batch the
rerank touches only ``B * k * rerank_mult`` rows.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def write_tail(path: str | Path, rows) -> str:
    """Persist fp32 rows as an .npy memmap target; returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.asarray(rows, np.float32))
    # np.save appends .npy when missing; report the real on-disk name
    return str(path if path.suffix == ".npy" else path.with_suffix(path.suffix + ".npy"))


def gather_tail(path: str | Path, ids) -> np.ndarray:
    """Gather rows `ids` (any shape; negatives clipped to row 0) from the
    on-disk tail without loading it: (..., d) float32."""
    mm = np.load(path, mmap_mode="r")
    flat = np.maximum(np.asarray(ids, np.int64).reshape(-1), 0)
    rows = np.asarray(mm[flat], dtype=np.float32)
    return rows.reshape(*np.shape(ids), mm.shape[1])
