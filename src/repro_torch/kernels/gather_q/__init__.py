"""gather_q: int8 gather + fused dequantize and L2/angular distance."""
from .ops import gather_dist_q, gather_dist_q_kernel
from .ref import gather_dist_q_ref

__all__ = ["gather_dist_q", "gather_dist_q_kernel", "gather_dist_q_ref"]
