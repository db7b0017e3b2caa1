"""Hand-written CUDA kernels for Hopper (sm_90a) on the LCCS-LSH query path,
each with its plain PyTorch version beside it.

Each subpackage: ops.py (the wrapper: the kernel on CUDA tensors, the plain
version on CPU tensors), ref.py (the plain version).  The CUDA sources live
in csrc/ and are built by `common.build` at first use.
"""
from .common import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
