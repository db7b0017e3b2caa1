"""LCCS-LSH core, PyTorch port of `repro.core`: `LCCSIndex`, the dynamic
`SegmentedLCCSIndex`, `SearchParams` + the candidate-source registry, the
paper's closed forms (`theory`) and the verify the baselines share
(`verify_candidates`).  Importing it also imports `repro_torch.shard`,
which registers the "sharded" candidate source and topology."""
from . import multiprobe, theory
from .bruteforce import bruteforce_topk, circ_run_lengths
from .csa import CSA, build_csa, circular_ranks
from .index import LCCSIndex, candidates, resolve_device, search, verify_candidates
from .lsh import (
    BitSamplingLSH,
    CrossPolytopeLSH,
    RandomProjectionLSH,
    distance,
    family_from_arrays,
    make_family,
)
from .params import SearchParams, WindowWidthWarning
from .search import klccs_search, klccs_search_pairs, klccs_search_with_lens
# importing .segments registers the "segmented" candidate source
from .segments import Segment, SegmentedLCCSIndex
from .sources import CandidateSource, available_sources, get_source, register_source

# importing repro_torch.shard registers the "sharded" candidate source and
# topology.  A plain submodule import, so the reentrant case -- the shard
# package importing this one first -- finds the partial module and returns;
# the sharded names live in repro_torch.shard.
from .. import shard as _shard  # noqa: E402,F401  isort: skip

__all__ = [
    "CSA",
    "BitSamplingLSH",
    "CandidateSource",
    "CrossPolytopeLSH",
    "LCCSIndex",
    "RandomProjectionLSH",
    "SearchParams",
    "Segment",
    "SegmentedLCCSIndex",
    "WindowWidthWarning",
    "available_sources",
    "bruteforce_topk",
    "build_csa",
    "candidates",
    "circ_run_lengths",
    "circular_ranks",
    "distance",
    "family_from_arrays",
    "get_source",
    "klccs_search",
    "klccs_search_pairs",
    "klccs_search_with_lens",
    "make_family",
    "multiprobe",
    "register_source",
    "resolve_device",
    "search",
    "theory",
    "verify_candidates",
]
