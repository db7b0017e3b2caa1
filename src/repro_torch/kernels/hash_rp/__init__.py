"""hash_rp: random-projection LSH hashing, floor((x @ a + b) / w)."""
from .ops import hash_rp
from .ref import hash_rp_ref

__all__ = ["hash_rp", "hash_rp_ref"]
