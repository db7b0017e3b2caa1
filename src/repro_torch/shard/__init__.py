"""Sharded LCCS-LSH serving on one device (PyTorch port of `repro.shard`).

`ShardedLCCSIndex` partitions a corpus into S row shards -- one CSA and one
vector-store slice a shard under a single shared LSH family -- and serves
the full hash -> candidate-source -> two-stage-verify pipeline shard by
shard, finished by the reference's exact global top-k merge.  Importing
this package (which `repro_torch.core` does) registers the "sharded"
candidate source and topology.

    from repro_torch.shard import ShardedLCCSIndex

    index = ShardedLCCSIndex.build(X, shards=4, m=64)   # CUDA
    ids, dists = index.search(Q, SearchParams(k=10, lam=200))
"""
from .index import ShardedLCCSIndex, shard_index
from .search import search, sharded_source

__all__ = ["ShardedLCCSIndex", "search", "shard_index", "sharded_source"]
