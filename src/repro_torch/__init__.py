"""PyTorch/CUDA port of the LCCS-LSH system (`repro`, the JAX package, is the
reference it is held against).

Entry points run on CUDA unless the caller asks for the CPU::

    from repro_torch import LCCSIndex, SearchParams
    index = LCCSIndex.build(X, m=64, family="euclidean", w=16.0)   # CUDA
    ids, dists = index.search(Q, SearchParams(k=10, lam=100, width=100))

`SegmentedLCCSIndex` is the dynamic index (insert, delete, compact).  On a
CUDA index the hash, probe, buffer-scoring and verify stages launch
hand-written kernels (`repro_torch.kernels`, built with nvcc at first use);
on a CPU index (`device="cpu"`) their plain PyTorch versions run.
"""
from .core import LCCSIndex, SearchParams, SegmentedLCCSIndex

__all__ = ["LCCSIndex", "SearchParams", "SegmentedLCCSIndex"]
