"""Probe pools for the pool top-lam tests, made from a numpy seed: shared by
the CPU parity tests (tests/test_torch_pool_topk.py) and the on-card tests
(tests/test_torch_kernels_cuda.py), so that both hold the kernel's function
to the same cases.  Imports neither JAX nor the reference package."""
import numpy as np

# name -> (B, pool, n, lam, tile, lcp range [lo, hi), kind); tile None is the
# default (ref.POOL_TILE), and a tile is widened to 2 min(lam, n) entries
POOL_CASES = {
    "ties": (5, 300, 60, 20, None, (0, 2), "plain"),
    "lcp 0": (3, 200, 80, 30, None, (0, 1), "plain"),
    "padding": (4, 256, 500, 40, None, (0, 6), "padding"),
    "masked rows": (4, 384, 300, 50, None, (0, 9), "masked"),
    "pool < lam": (3, 50, 400, 100, None, (0, 6), "plain"),
    "n < lam": (4, 200, 30, 45, None, (0, 6), "plain"),
    "B = 0": (0, 128, 50, 20, None, (0, 6), "plain"),
    "pool = 0": (3, 0, 50, 20, None, (0, 6), "plain"),
    "one tile": (3, 60, 1000, 20, 64, (0, 65), "plain"),
    "two tiles": (3, 100, 1000, 20, 64, (0, 65), "plain"),
    "many tiles": (3, 1000, 5000, 20, 64, (0, 65), "masked"),
    "many tiles, ties": (2, 1500, 300, 25, 50, (0, 3), "padding"),
    "lam > tile": (3, 700, 2000, 40, 16, (0, 9), "plain"),
    "lcp 256": (2, 500, 1000, 30, 100, (200, 257), "plain"),
}


def make_pool(name: str, seed: int = 0):
    """(ids, lcps) (B, pool) int32 of case `name`: ids in [-1, n), drawn from
    a range a few times the pool so that they repeat; lcps in [lo, hi), with
    the case's masking."""
    B, pool, n, _, _, (lo, hi), kind = POOL_CASES[name]
    rng = np.random.default_rng([seed, len(name), pool])
    ids = rng.integers(-1, min(n, 3 * pool + 2), size=(B, pool))
    lcps = rng.integers(lo, hi, size=(B, pool))
    if kind == "padding":  # -1-padded slots: id and lcp both -1
        pad = rng.random((B, pool)) < 0.4
        ids[pad], lcps[pad] = -1, -1
    elif kind == "masked" and B:  # a masked row: -1 in both; live ids with lcp -1
        ids[0], lcps[0] = -1, -1
        lcps[rng.random((B, pool)) < 0.2] = -1
    return ids.astype(np.int32), lcps.astype(np.int32)
