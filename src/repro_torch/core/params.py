"""SearchParams -- the single static search configuration object (PyTorch
port of `repro.core.params`; field set, defaults and validation are the
reference's, so one params object means the same search in both packages).

Every query-phase knob of the LCCS-LSH scheme lives here, replacing the loose
``k=, lam=, width=, mode=, probes=`` kwarg bundles the seed copy-pasted across
`serve`, `launch`, `benchmarks`, and `examples`.  The dataclass is frozen and
hashable:

    from repro_torch.core import LCCSIndex, SearchParams
    params = SearchParams(k=10, lam=200, source="multiprobe-skip", probes=17)
    ids, dists = index.search(queries, params)

Fields
------
k            number of neighbours returned after verification.
lam          lambda: candidate-set size of the lambda-LCCS search (paper §4.1).
source       candidate-source name from the registry (`repro.core.sources`):
             "bruteforce" | "lccs" | "multiprobe-full" | "multiprobe-skip"
             | "segmented" (the dynamic index's wrapper; see `inner`).
mode         inner k-LCCS search mode: "parallel" (vmapped binary searches)
             or "narrowed" (paper-faithful Corollary 3.2 scan).
width        window half-width of the k-LCCS search; None = max(4, min(lam, 64)).
             The W >= lambda window-dominance guarantee (DESIGN.md §3: the
             returned LCCS lengths elementwise dominate exact Algorithm 2)
             only holds when the resolved width >= lam, so the default cap of
             64 silently weakens it for lam > 64: candidates beyond the
             64-wide window of some shift can be missed, trading recall for
             probe bandwidth.  Constructing such params emits a
             `WindowWidthWarning`; pass width=lam to keep the guarantee, or
             an explicit smaller width to accept the trade deliberately.
probes       number of MP-LCCS-LSH probes (Algorithm 3); only the multiprobe-*
             sources look at it.
metric       distance metric for verification; None = the index's own metric.
n_alt        alternatives per hash position offered to Algorithm 3.
max_gap      Algorithm-3 MAX_GAP constraint on adjacent modified slots.
skip_budget  static cap on re-searched shifts per (query, probe) in the
             "multiprobe-skip" source.  None = a heuristic cap (16 shifts per
             perturbation term, clipped to m); set it to m (or larger) for
             exact §4.2 semantics, or lower to trade recall for speed.
inner        per-part candidate source of the wrapping "segmented" source
             (and of the reference's "sharded" one, not yet ported); the
             segmented index sets it from `source` at search time.
shards       expected shard count of a sharded index (None accepts any);
             the monolithic index ignores it.
store        expected vector-store kind for the verify scan ("fp32" | "bf16"
             | "int8"); None accepts whatever the index holds.  A mismatch
             raises before the search runs -- the field documents (and pins) which
             representation a serving config verifies against.
rerank_mult  over-fetch factor of the two-stage verify path: an *inexact*
             (quantized) store scans approximately, keeps the best
             k * rerank_mult survivors, and reranks them in fp32 against the
             tail.  Exact stores ignore it.  Higher = closer to fp32 recall,
             lower = less rerank bandwidth; 4 recovers fp32 top-k to within
             ~1% recall on clustered data (see benchmarks/fig12_memory.py).
use_gather_kernel
             verification kernel toggle, one dispatch point for fp32
             (`kernels.gather_l2`) and int8 (`kernels.gather_q`):
             True = the gather kernels' semantics (squared distance, fixed up
             by `_fix_kernel_dist`; the hand-written CUDA kernel on a CUDA
             index, its plain torch version on a CPU index), False = the
             dense torch gather, None = the REPRO_GATHER_KERNEL env var when
             set, else on when the index lies on CUDA.
use_probe_kernel
             probe-stage kernel toggle (`kernels.csa_probe`): True = the
             fused CSA probe (binary search + adjacent-LCP window walk +
             pool top-lam dedupe -- the CUDA kernels on a CUDA index, their
             plain torch versions on a CPU index), False = the legacy
             `core.search.klccs_search*` window path, None = the
             REPRO_PROBE_KERNEL env var when set, else on when the index
             lies on CUDA.  Outputs are bit-identical either way; the "lccs" and
             "multiprobe-*" sources consult it on every topology.  Falls
             back to the legacy path for mode="narrowed" and for CSAs saved
             without the adjacent-LCP table.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import warnings
from contextlib import contextmanager
from dataclasses import dataclass

_WARN_STATE = threading.local()


def _user_stacklevel() -> int:
    """Stacklevel (relative to __post_init__) of the nearest frame that is
    user code: skips the dataclass-generated __init__ ("<string>" frames
    named __init__), dataclasses.replace, and this module (from_legacy,
    chained construction helpers), so the warning points at the line that
    actually chose the params."""
    internal = (__file__, dataclasses.__file__)
    level = 2  # __post_init__'s caller
    try:
        f = sys._getframe(3)  # 0 here, 1 __post_init__, 2 generated __init__
    except ValueError:  # pragma: no cover -- shallow stack
        return level
    while f is not None:
        fname = f.f_code.co_filename
        if not (fname in internal
                or (fname == "<string>" and f.f_code.co_name == "__init__")):
            break
        f = f.f_back
        level += 1
    return level


@contextmanager
def _suppress_width_warning():
    """Internal-rewrite scope: the exec topology adapters derive new
    SearchParams from user params (source rewrites, kernel pinning) on every
    plan resolution; the user's own construction already warned, so derived
    copies must not re-fire `WindowWidthWarning` from library frames."""
    prev = getattr(_WARN_STATE, "off", 0)
    _WARN_STATE.off = prev + 1
    try:
        yield
    finally:
        _WARN_STATE.off = prev


class WindowWidthWarning(UserWarning):
    """The resolved k-LCCS window width is smaller than lam, so the
    W >= lambda window-dominance guarantee (DESIGN.md §3) is weakened:
    recall can drop below the exact Algorithm-2 floor.  Emitted when the
    *default* width cap (64) silently does this for lam > 64; silence it by
    passing an explicit `width` (width=lam restores the guarantee)."""


@dataclass(frozen=True)
class SearchParams:
    k: int = 10
    lam: int = 100
    source: str = "lccs"
    mode: str = "parallel"
    width: int | None = None
    probes: int = 1
    metric: str | None = None
    n_alt: int = 4
    max_gap: int = 2
    skip_budget: int | None = None
    inner: str = "lccs"
    store: str | None = None
    rerank_mult: int = 4
    use_gather_kernel: bool | None = None
    use_probe_kernel: bool | None = None
    shards: int | None = None

    def __post_init__(self):
        if self.inner in ("segmented", "sharded"):
            raise ValueError(
                f"inner={self.inner!r} would recurse; pick a per-part source "
                "such as 'lccs', 'bruteforce', or 'multiprobe-skip'"
            )
        if self.shards is not None and self.shards < 1:
            raise ValueError(f"shards must be >= 1 or None, got {self.shards}")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.lam < 1:
            raise ValueError(f"lam must be >= 1, got {self.lam}")
        if self.probes < 1:
            raise ValueError(f"probes must be >= 1, got {self.probes}")
        if self.skip_budget is not None and self.skip_budget < 1:
            raise ValueError(
                f"skip_budget must be >= 1 or None, got {self.skip_budget} "
                "(use probes=1 / source='lccs' to disable probing entirely)"
            )
        if self.rerank_mult < 1:
            raise ValueError(
                f"rerank_mult must be >= 1, got {self.rerank_mult} "
                "(1 = no over-fetch: rerank exactly the top-k survivors)"
            )
        if self.mode not in ("parallel", "narrowed"):
            raise ValueError(
                f"mode must be 'parallel' or 'narrowed', got {self.mode!r} "
                "(bruteforce is a candidate *source* now: source='bruteforce')"
            )
        if self.width is not None and self.width < 1:
            raise ValueError(f"width must be >= 1 or None, got {self.width}")
        # the width<lam footgun: the default width cap (64) silently drops
        # the W >= lambda window-dominance guarantee for lam > 64 -- warn so
        # the recall implication is a documented choice, not an accident.
        # (An *explicit* width < lam is taken as that deliberate choice, and
        # "bruteforce" scores every row densely -- no window is involved;
        # for the "segmented"/"sharded" wrappers the probing source is
        # `inner`.  Params derived internally by the exec resolve never
        # re-warn -- the user's original construction already did.)
        probing = (self.inner if self.source in ("segmented", "sharded")
                   else self.source)
        if (self.width is None and self.resolved_width() < self.lam
                and probing != "bruteforce"
                and not getattr(_WARN_STATE, "off", 0)):
            warnings.warn(
                f"SearchParams(lam={self.lam}) resolves the k-LCCS window "
                f"width to {self.resolved_width()} < lam: the W >= lambda "
                "window-dominance guarantee (DESIGN.md §3) is weakened and "
                "recall may fall below the exact Algorithm-2 floor; pass "
                f"width={self.lam} to keep it, or an explicit smaller width "
                "to accept the recall/probe-bandwidth trade",
                WindowWidthWarning,
                # attribute to the user's construction line, whichever path
                # built us (direct call, .replace(), from_legacy)
                stacklevel=_user_stacklevel() + 1,
            )

    # -- derived -------------------------------------------------------------

    def resolved_width(self) -> int:
        """Window width for the k-LCCS search (seed default preserved)."""
        return self.width if self.width is not None else max(4, min(self.lam, 64))

    def replace(self, **changes) -> "SearchParams":
        return dataclasses.replace(self, **changes)

    # -- legacy kwargs bridge ------------------------------------------------

    @classmethod
    def from_legacy(
        cls,
        *,
        k: int = 10,
        lam: int = 100,
        width: int | None = None,
        mode: str = "parallel",
        probes: int = 1,
        metric: str | None = None,
        **extra,
    ) -> "SearchParams":
        """Map the seed's kwarg bundle onto (source, mode).

        mode="bruteforce"            -> source="bruteforce"
        probes>1, mode="parallel"    -> source="multiprobe-skip"   (§4.2 default)
        probes>1, other mode         -> source="multiprobe-full"
        otherwise                    -> source="lccs"
        """
        if extra:
            raise TypeError(f"unknown legacy query kwargs: {sorted(extra)}")
        skip_budget = None
        if mode == "bruteforce":
            source, mode = "bruteforce", "parallel"
        elif probes > 1:
            source = "multiprobe-skip" if mode == "parallel" else "multiprobe-full"
            # the seed searched every affected (probe, shift) pair: preserve
            # that exact behaviour for legacy callers (clips to m)
            skip_budget = 1 << 20
        else:
            source = "lccs"
        return cls(
            k=k, lam=lam, source=source, mode=mode, width=width,
            probes=probes, metric=metric, skip_budget=skip_budget,
        )
