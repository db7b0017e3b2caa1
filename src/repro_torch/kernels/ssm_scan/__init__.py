"""ssm_scan: the Mamba-1 selective scan, batched and sequence-chunked, and its
backward."""
from .ops import ssm_scan, ssm_scan_bwd
from .ref import ssm_scan_batched_ref, ssm_scan_bwd_ref, ssm_scan_ref

__all__ = ["ssm_scan", "ssm_scan_bwd", "ssm_scan_batched_ref", "ssm_scan_bwd_ref",
           "ssm_scan_ref"]
