"""Pluggable corpus-vector stores (layout + quantization + distance scan).

See `base` for the protocol/registry, `stores` for the built-in fp32 / bf16 /
int8 layouts, and `tail` for the disk-lazy fp32 rerank tail.
"""
from .base import VectorStore, available_stores, get_store_cls, make_store, register_store
from .stores import Bf16Store, Fp32Store, Int8Store, concat_stores
from .tail import TailWriter

__all__ = [
    "Bf16Store",
    "Fp32Store",
    "Int8Store",
    "TailWriter",
    "VectorStore",
    "available_stores",
    "concat_stores",
    "get_store_cls",
    "make_store",
    "register_store",
]
