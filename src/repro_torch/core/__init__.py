"""LCCS-LSH core, PyTorch port of `repro.core`: `LCCSIndex` + `SearchParams`
+ the candidate-source registry."""
from . import multiprobe
from .bruteforce import bruteforce_topk, circ_run_lengths
from .csa import CSA, build_csa, circular_ranks
from .index import LCCSIndex, candidates, resolve_device, search
from .lsh import (
    BitSamplingLSH,
    CrossPolytopeLSH,
    RandomProjectionLSH,
    distance,
    make_family,
)
from .params import SearchParams, WindowWidthWarning
from .search import klccs_search, klccs_search_pairs, klccs_search_with_lens
from .sources import CandidateSource, available_sources, get_source, register_source

__all__ = [
    "CSA",
    "BitSamplingLSH",
    "CandidateSource",
    "CrossPolytopeLSH",
    "LCCSIndex",
    "RandomProjectionLSH",
    "SearchParams",
    "WindowWidthWarning",
    "available_sources",
    "bruteforce_topk",
    "build_csa",
    "candidates",
    "circ_run_lengths",
    "circular_ranks",
    "distance",
    "get_source",
    "klccs_search",
    "klccs_search_pairs",
    "klccs_search_with_lens",
    "make_family",
    "multiprobe",
    "register_source",
    "resolve_device",
    "search",
]
