"""gather_l2: fp32 gather + fused L2/angular distance."""
from .ops import gather_dist, gather_dist_kernel
from .ref import gather_dist_ref

__all__ = ["gather_dist", "gather_dist_kernel", "gather_dist_ref"]
