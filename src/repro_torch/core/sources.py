"""Pluggable candidate sources for the lambda-LCCS search phase (PyTorch port
of `repro.core.sources`).

A *candidate source* maps (index, queries, query hash strings, params) to a
padded ``(ids (B, lam), lcps (B, lam))`` candidate set.  Sources are selected
by name through `SearchParams.source`; new ones plug in via
`register_source`.

Built-ins:
  "bruteforce"       dense circular-run scoring of every database string.
  "lccs"             single-probe lambda-LCCS search over the CSA
                     (`params.mode` picks the parallel or narrowed walk).
  "multiprobe-full"  MP-LCCS-LSH: every probe searches all m shifts.
  "multiprobe-skip"  MP-LCCS-LSH with §4.2 skip-unaffected-positions: probes
                     only re-search shifts whose base-query LCP window covers
                     a modified position; `params.skip_budget` caps the
                     per-(query, probe) shift worklist.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Protocol, runtime_checkable

import torch

from . import multiprobe
from .bruteforce import bruteforce_topk
from .lsh import topk_largest
from .search import dedupe_topk, klccs_search, klccs_search_pairs, klccs_search_with_lens

if TYPE_CHECKING:  # pragma: no cover
    from .index import LCCSIndex
    from .params import SearchParams


@runtime_checkable
class CandidateSource(Protocol):
    def __call__(
        self,
        index: "LCCSIndex",
        queries: torch.Tensor,  # (B, d) float32
        qh: torch.Tensor,  # (B, m) int32 hashed queries
        params: "SearchParams",
    ) -> tuple[torch.Tensor, torch.Tensor]:  # ids (B, lam), lcps (B, lam)
        ...


_REGISTRY: dict[str, CandidateSource] = {}


def register_source(name: str, fn: CandidateSource | None = None):
    """Register a candidate source under `name` (decorator or direct call).
    Re-registering a name overwrites it."""

    def deco(f: CandidateSource) -> CandidateSource:
        _REGISTRY[name] = f
        return f

    return deco(fn) if fn is not None else deco


def get_source(name: str) -> CandidateSource:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown candidate source {name!r}; available: {available_sources()}"
        ) from None


def available_sources() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Built-in sources
# ---------------------------------------------------------------------------


def _require_csa(index, name):
    if index.csa is None:
        raise ValueError(
            f"candidate source {name!r} needs a CSA; this index was built with "
            "build_csa_structure=False -- use source='bruteforce'"
        )


def _fused_probe(index, params) -> bool:
    """True when this probe runs the fused CSA probe (`kernels.csa_probe`):
    the resolved `use_probe_kernel` toggle is on AND the CSA carries the
    adjacent-LCP table.  Outputs are bit-identical either way."""
    from ..exec.stages import resolve_use_probe_kernel  # lazy: no cycle
    from ..kernels.csa_probe import supports

    return (resolve_use_probe_kernel(params.use_probe_kernel, index.device)
            and supports(index.csa))


@register_source("bruteforce")
def bruteforce_source(index, queries, qh, params):
    """Exact LCCS scoring of every database string (no CSA required)."""
    return bruteforce_topk(index.h, qh, params.lam)


@register_source("lccs")
def lccs_source(index, queries, qh, params):
    """Single-probe lambda-LCCS search (paper Algorithm 2) over the CSA."""
    _require_csa(index, "lccs")
    width = params.resolved_width()
    if params.mode == "parallel" and _fused_probe(index, params):
        from ..kernels.csa_probe import csa_probe_search

        return csa_probe_search(index.csa, qh, params.lam, width=width)
    return klccs_search(index.csa, qh, params.lam, width=width, mode=params.mode)


def _probe_batch(index, queries, qh, params):
    """Shared multiprobe front half: batched alternatives, static Algorithm-3
    schedule, and one probe-string materialisation for the batch."""
    alt_vals, alt_scores = index.family.alternatives(queries, params.n_alt)
    n_alt = alt_vals.shape[-1]
    slots, ranks, mask = multiprobe.probe_schedule(
        index.m, params.probes, n_alt, params.max_gap
    )
    # slot s of the schedule = position with the s-th cheapest best alternative
    order = torch.argsort(alt_scores[..., 0], dim=-1, stable=True)
    strings, pos = multiprobe.probe_strings_batch(qh, order, alt_vals, slots, ranks, mask)
    return strings, pos, mask


@register_source("multiprobe-full")
def multiprobe_full_source(index, queries, qh, params):
    """MP-LCCS-LSH, baseline form: every probe searches all m shifts."""
    _require_csa(index, "multiprobe-full")
    if params.probes <= 1:
        return lccs_source(index, queries, qh, params)
    width = params.resolved_width()
    strings, _, _ = _probe_batch(index, queries, qh, params)
    B, P, m = strings.shape
    if params.mode == "parallel" and _fused_probe(index, params):
        # fused: raw windows of every (probe, shift), ONE pool top-lam dedupe
        # per query over the whole P*m*2W pool (equal to the legacy two-level
        # dedupe, see the reference)
        from ..kernels.csa_probe import csa_probe_windows, pool_topk

        w_ids, w_lcps = csa_probe_windows(index.csa, strings.reshape(B * P, m), width=width)
        return pool_topk(w_ids.reshape(B, -1), w_lcps.reshape(B, -1), index.csa.n, params.lam)
    ids, lcps = klccs_search(
        index.csa, strings.reshape(B * P, m), params.lam, width=width, mode=params.mode
    )
    return dedupe_topk(ids.reshape(B, -1), lcps.reshape(B, -1), params.lam)


@register_source("multiprobe-skip")
def multiprobe_skip_source(index, queries, qh, params):
    """MP-LCCS-LSH with §4.2 skip-unaffected-positions.

    The base query searches all shifts (recording per-shift best LCPs).  A
    probe modifying positions M need only re-search shifts i whose LCP window
    [i, i + maxlen_i] covers some p in M.  The per-(query, probe) worklist is
    compacted to `skip_budget` shifts and searched as one batched
    single-shift call."""
    _require_csa(index, "multiprobe-skip")
    if params.probes <= 1:
        return lccs_source(index, queries, qh, params)
    width = params.resolved_width()
    fused = _fused_probe(index, params)
    if fused:
        from ..kernels.csa_probe import csa_probe_pairs, csa_probe_windows, pool_topk

        # raw base windows: the pool top-lam merge dedupes the whole pool at
        # once (and the per-shift max of the window LCPs IS the §4.2 bound)
        w_ids, w_lcps = csa_probe_windows(index.csa, qh, width=width)
        B0 = qh.shape[0]
        base_ids = w_ids.reshape(B0, -1)
        base_lcps = w_lcps.reshape(B0, -1)
        maxlen = w_lcps.amax(dim=2)
    else:
        base_ids, base_lcps, maxlen = klccs_search_with_lens(
            index.csa, qh, params.lam, width=width
        )
    strings, pos, mask = _probe_batch(index, queries, qh, params)
    B, P, m = strings.shape
    dev = qh.device
    shifts_all = torch.arange(m, dtype=torch.int32, device=dev)
    # probe 0 is the unperturbed base query, already searched above
    strings_p = strings[:, 1:, :]  # (B, P-1, m)
    pos_p = pos[:, 1:, :]  # (B, P-1, T)
    mask_p = torch.as_tensor(mask[1:], dtype=torch.bool, device=dev)
    # affected[b, p, i] <=> some modified position of probe p lies in shift
    # i's base LCP window: (pos - i) mod m <= min(maxlen_i + 1, m - 1)
    dist = torch.remainder(pos_p[:, :, :, None] - shifts_all, m)
    window = torch.clamp(maxlen + 1, max=m - 1)  # (B, m)
    affected = ((dist <= window[:, None, None, :]) & mask_p[None, :, :, None]).any(dim=2)
    if params.skip_budget is None:
        # heuristic static cap: 16 shifts per perturbation term (see the
        # reference); skip_budget >= m gives exact §4.2 semantics
        budget = min(m, 16 * mask.shape[1])
    else:
        budget = min(params.skip_budget, m)
    # rank affected shifts by their base LCP window (ties to the lower shift)
    score = torch.where(affected, window[:, None, :] + 1, torch.zeros_like(window[:, None, :]))
    hit, shifts = topk_largest(score, budget)  # (B, P-1, S)
    valid = hit > 0
    rows = strings_p[:, :, None, :].expand(B, P - 1, budget, m).reshape(-1, m)
    if fused:
        p_ids, p_lcps = csa_probe_pairs(
            index.csa, rows, shifts.reshape(-1), valid.reshape(-1), width=width
        )
    else:
        p_ids, p_lcps = klccs_search_pairs(
            index.csa, rows, shifts.reshape(-1), valid.reshape(-1), width=width
        )
    ids = torch.cat([base_ids, p_ids.reshape(B, -1)], dim=1)
    lcps = torch.cat([base_lcps, p_lcps.reshape(B, -1)], dim=1)
    if fused:
        return pool_topk(ids, lcps, index.csa.n, params.lam)
    return dedupe_topk(ids, lcps, params.lam)
