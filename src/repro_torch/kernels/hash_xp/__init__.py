"""hash_xp: cross-polytope LSH hashing with a gaussian rotation."""
from .ops import hash_xp
from .ref import hash_xp_ref

__all__ = ["hash_xp", "hash_xp_ref"]
