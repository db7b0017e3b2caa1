"""gather_q: int8 gather + fused dequantize and L2/angular distance, and the
verify's top-k fused behind it."""
from .ops import gather_dist_q, gather_dist_q_kernel, gather_topk_q
from .ref import gather_dist_q_ref, gather_topk_q_ref

__all__ = ["gather_dist_q", "gather_dist_q_kernel", "gather_dist_q_ref", "gather_topk_q",
           "gather_topk_q_ref"]
