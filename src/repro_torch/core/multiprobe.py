"""MP-LCCS-LSH perturbation-vector generation (paper Algorithm 3); PyTorch
port of `repro.core.multiprobe` (the host schedule is the same numpy code).

A perturbation vector delta is a list of (position, alternative-rank) pairs;
probes are generated in ascending total-score order via a min-heap with the
paper's p_shift / p_expand operators and the MAX_GAP constraint on adjacent
modified positions.

Two execution forms live here:

  * `generate_perturbations`: the literal per-query Algorithm 3 (host
    numpy), which the schedule below runs once per configuration.
  * `probe_schedule` / `probe_strings_batch`: the batched form.  The heap
    runs ONCE per (m, probes, n_alt, max_gap) over *score-ranked position
    slots* with a canonical score model (the precomputed-probing-sequence
    optimisation of Lv et al. 2007 §4.4 applied to Algorithm 3).  Per query,
    slot s maps to the position with the s-th cheapest best alternative, so
    probing stays query-adaptive while the schedule -- and therefore the whole
    multiprobe candidate source -- is a static structure.
"""
from __future__ import annotations

import heapq
import itertools
from functools import lru_cache

import numpy as np
import torch

MAX_GAP = 2  # paper §4.2: "We set MAX_GAP = 2 in practice."


def generate_perturbations(
    scores: np.ndarray,  # (m, n_alt) ascending per-position alternative scores
    n_probes: int,
    max_gap: int = MAX_GAP,
) -> list[tuple[tuple[int, int], ...]]:
    """Algorithm 3.  Returns a list of perturbation vectors (the first is the
    empty "no perturbation" probe), each a tuple of (position, alt_rank).

    Probes come out in ascending order of score(delta) = sum of entry scores.
    """
    m, n_alt = scores.shape
    probes: list[tuple[tuple[int, int], ...]] = [()]
    if n_probes <= 1:
        return probes

    counter = itertools.count()  # tie-break for the heap

    def score_of(delta) -> float:
        return float(sum(scores[i, j] for i, j in delta))

    heap: list[tuple[float, int, tuple[tuple[int, int], ...]]] = []
    for i in range(m):
        delta = ((i, 0),)
        heapq.heappush(heap, (score_of(delta), next(counter), delta))

    while len(probes) < n_probes and heap:
        s, _, delta = heapq.heappop(heap)
        probes.append(delta)
        # p_shift: advance the last entry to its next alternative
        last_pos, last_rank = delta[-1]
        if last_rank + 1 < n_alt:
            shifted = delta[:-1] + ((last_pos, last_rank + 1),)
            heapq.heappush(heap, (score_of(shifted), next(counter), shifted))
        # p_expand: append (last_pos + gap, rank 0) for gap = 1..max_gap
        for gap in range(1, max_gap + 1):
            npos = last_pos + gap
            if npos < m:
                expanded = delta + ((npos, 0),)
                heapq.heappush(heap, (score_of(expanded), next(counter), expanded))
    return probes


# ---------------------------------------------------------------------------
# Batched form: static schedule + batched probe-string materialisation.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=64)
def probe_schedule(m: int, n_probes: int, n_alt: int, max_gap: int = MAX_GAP):
    """Run Algorithm 3 once over score-ranked slots with the canonical score
    model score(slot s, rank j) = (s + 1) + j * m (cheaper slots and lower
    alternative ranks first; all rank-j entries are cheaper than any rank-j+1).

    Deliberate deviation from the paper: MAX_GAP here constrains adjacency of
    *score-rank slots*, not of hash positions -- two slots adjacent in the
    schedule may map to distant hash positions for a given query (and
    vice versa).  The paper's positional MAX_GAP is only enforceable with
    per-query heap runs (`generate_perturbations`, the reference path); the
    slot form is what makes the schedule query-independent.

    Returns padded numpy arrays (constants per configuration):
      slots (P, T) int32   score-rank slot of each perturbation term,
      ranks (P, T) int32   alternative rank of each term,
      mask  (P, T) bool    validity of each padded term slot.
    Probe 0 is always the empty perturbation (the base query).
    """
    canon = np.add.outer(
        np.arange(1, m + 1, dtype=np.float64),
        np.arange(n_alt, dtype=np.float64) * m,
    )  # (m, n_alt)
    deltas = generate_perturbations(canon, n_probes, max_gap)
    P = len(deltas)
    T = max((len(d) for d in deltas), default=0) or 1
    slots = np.zeros((P, T), np.int32)
    ranks = np.zeros((P, T), np.int32)
    mask = np.zeros((P, T), bool)
    for p, delta in enumerate(deltas):
        for t, (s, r) in enumerate(delta):
            slots[p, t], ranks[p, t], mask[p, t] = s, r, True
    return slots, ranks, mask


def probe_strings_batch(
    qh: torch.Tensor,  # (B, m) int32 base hash strings
    order: torch.Tensor,  # (B, m): slot s -> hash position (score-ascending)
    alt_vals: torch.Tensor,  # (B, m, A) int32 per-position alternatives
    slots: np.ndarray,  # (P, T) static schedule
    ranks: np.ndarray,
    mask: np.ndarray,
):
    """Materialise probe strings for the whole batch.

    Returns (strings (B, P, m) int32, pos (B, P, T) int32) where pos holds the
    actual modified positions per probe (padded entries are masked by `mask`).
    """
    B, m = qh.shape
    dev = qh.device
    slots_t = torch.as_tensor(slots, dtype=torch.int64, device=dev)
    ranks_t = torch.as_tensor(ranks, dtype=torch.int64, device=dev)
    mask_t = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    P, T = slots_t.shape
    order = order.long()
    pos = order[:, slots_t]  # (B, P, T) actual positions
    bidx = torch.arange(B, device=dev)[:, None, None]
    v = alt_vals[bidx, pos, ranks_t]  # (B, P, T) replacement hash values
    # padded terms scatter into an extra column that is dropped afterwards
    pos_scatter = torch.where(mask_t, pos, m)
    strings = torch.cat(
        [qh[:, None, :].expand(B, P, m), torch.zeros((B, P, 1), dtype=qh.dtype, device=dev)],
        dim=2,
    ).scatter(2, pos_scatter, v.to(qh.dtype))
    return strings[:, :, :m].contiguous(), pos.to(torch.int32)
