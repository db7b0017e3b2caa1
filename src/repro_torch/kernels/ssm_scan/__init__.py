"""ssm_scan: the Mamba-1 selective scan, batched and sequence-chunked."""
from .ops import ssm_scan
from .ref import ssm_scan_batched_ref, ssm_scan_ref

__all__ = ["ssm_scan", "ssm_scan_batched_ref", "ssm_scan_ref"]
