"""csa_probe: the fused CSA probe (binary search + adjacent-LCP window walk)
and the pool top-lam that dedupes its windows."""
from .ops import (
    csa_probe,
    csa_probe_pairs,
    csa_probe_search,
    csa_probe_search_with_lens,
    csa_probe_windows,
    pool_topk,
    supports,
)
from .ref import (
    csa_probe_plain,
    dedupe_topk_scatter,
    pool_topk_plain,
    probe_pairs_ref,
    search_windows_ref,
)

__all__ = [
    "csa_probe",
    "csa_probe_pairs",
    "csa_probe_plain",
    "csa_probe_search",
    "csa_probe_search_with_lens",
    "csa_probe_windows",
    "dedupe_topk_scatter",
    "pool_topk",
    "pool_topk_plain",
    "probe_pairs_ref",
    "search_windows_ref",
    "supports",
]
