"""Disk-lazy fp32 tail for the two-stage rerank path (PyTorch port of
`repro.store.tail`; numpy only, the same on-disk `.npy` format).

A quantized store answers the stage-1 approximate scan; the exact rerank of
the few surviving candidates needs the original fp32 rows, which can live on
disk as a plain ``.npy`` and be gathered lazily -- per query batch the
rerank touches only ``B * k * rerank_mult`` rows.  `TailWriter` streams
the rows to such a file block by block (the out-of-core build).
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def _npy_path(path: str | Path) -> Path:
    path = Path(path)
    return path if path.suffix == ".npy" else path.with_suffix(path.suffix + ".npy")


class TailWriter:
    """Streamed .npy writer: append fp32 row blocks as they are ingested,
    then `finalize()` patches the header with the final row count.

    The header is written at a fixed 128-byte length (v1 format, shape field
    padded), so the finalize rewrite is an in-place seek -- no rewrite of the
    appended data.  Peak memory is one appended block; the finished file is
    byte-equal to the reference's `TailWriter` file for the same rows and is
    read by `gather_tail` / `np.load` unchanged."""

    _HEADER_LEN = 128  # magic(6) + version(2) + hlen(2) + dict+pad+\n (118)

    def __init__(self, path: str | Path, d: int):
        self.path = str(_npy_path(path))
        Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self.d = int(d)
        self.n = 0
        self._f = open(self.path, "wb")
        self._f.write(self._header(0))

    def _header(self, n: int) -> bytes:
        head = ("{'descr': '<f4', 'fortran_order': False, "
                f"'shape': ({n}, {self.d}), }}")
        pad = self._HEADER_LEN - 10 - len(head) - 1
        if pad < 0:  # pragma: no cover - needs a ~10^45-row shape string
            raise ValueError(f"header overflow for shape ({n}, {self.d})")
        return (b"\x93NUMPY\x01\x00" + struct.pack("<H", self._HEADER_LEN - 10)
                + (head + " " * pad + "\n").encode("latin1"))

    def append(self, rows) -> None:
        if self._f is None:
            raise ValueError(f"TailWriter({self.path}) is finalized")
        rows = np.ascontiguousarray(np.asarray(rows, dtype="<f4"))
        if rows.ndim != 2 or rows.shape[1] != self.d:
            raise ValueError(f"expected (*, {self.d}) rows, got {rows.shape}")
        self._f.write(rows.tobytes())
        self.n += rows.shape[0]

    def finalize(self) -> str:
        """Patch the header with the final shape and close; returns the
        on-disk path (idempotent)."""
        if self._f is not None:
            self._f.seek(0)
            self._f.write(self._header(self.n))
            self._f.close()
            self._f = None
        return self.path


def write_tail(path: str | Path, rows) -> str:
    """Persist fp32 rows as an .npy memmap target; returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.asarray(rows, np.float32))
    # np.save appends .npy when missing; report the real on-disk name
    return str(_npy_path(path))


def gather_tail(path: str | Path, ids) -> np.ndarray:
    """Gather rows `ids` (any shape; negatives clipped to row 0) from the
    on-disk tail without loading it: (..., d) float32."""
    mm = np.load(path, mmap_mode="r")
    flat = np.maximum(np.asarray(ids, np.int64).reshape(-1), 0)
    rows = np.asarray(mm[flat], dtype=np.float32)
    return rows.reshape(*np.shape(ids), mm.shape[1])
