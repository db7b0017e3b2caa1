"""gather_l2: fp32 gather + fused L2/angular distance, and the verify's
top-k fused behind it."""
from .ops import gather_dist, gather_dist_kernel, gather_topk
from .ref import gather_dist_ref, gather_topk_ref, rank_ref

__all__ = ["gather_dist", "gather_dist_kernel", "gather_dist_ref", "gather_topk",
           "gather_topk_ref", "rank_ref"]
