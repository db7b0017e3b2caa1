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
    # the kernel's bands: the cut at lcp 0 (every band inserted, the lcp-0
    # ids selected), one id through a whole row, thousands of distinct ids
    # tied at the cut, fewer than k distinct ids, bands whose first passes
    # hold few distinct ids (the table resized pass after pass), a tile of
    # 16,384 entries, ids past 2^23 (8-byte keys, tiles of 8,192)
    "cut at lcp 0": (3, 3000, 10**6, 100, None, (0, 40), "cut 0"),
    "one id": (3, 2000, 1000, 50, None, (0, 65), "one id"),
    "ties at the cut": (2, 6000, 10**6, 100, None, (5, 6), "ties"),
    "fewer than k ids": (3, 2500, 10**6, 200, None, (0, 30), "few ids"),
    "band steps": (2, 16384, 10**6, 100, None, (0, 64), "steps"),
    "one tile of 16,384": (2, 16384, 10**6, 100, None, (0, 65), "plain"),
    "ids past 2^23": (2, 12000, 2**23 + 64, 100, None, (0, 65), "wide"),
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
    elif kind == "cut 0":  # 20 ids above lcp 0, half the entries at lcp 0
        lcps[rng.random((B, pool)) < 0.5] = 0
        ids[lcps > 0] = rng.integers(0, 20, size=int((lcps > 0).sum()))
    elif kind == "one id":  # one id a row, a few padded slots
        ids[:] = 7 + np.arange(B)[:, None]
        ids[rng.random((B, pool)) < 0.05] = -1
    elif kind == "ties":  # distinct ids, all at lcp lo but 30 a row above it
        ids = np.stack([rng.permutation(n)[:pool] for _ in range(B)])
        for r in range(B):
            lcps[r, rng.choice(pool, 30, replace=False)] = lo + 4
    elif kind == "few ids":  # 120 ids, fewer than k = 200
        ids = rng.integers(-1, 120, size=(B, pool))
    elif kind == "steps":  # lcps skewed low; the higher an lcp, the fewer ids hold it
        lcps = (hi * rng.random((B, pool)) ** 4).astype(np.int64)
        ids = rng.integers(0, np.maximum(2, (hi - lcps) ** 2 // 4))
    elif kind == "wide":  # ids just below n > 2^23
        ids = np.where(ids >= 0, ids + n - (3 * pool + 2), -1)
    return ids.astype(np.int32), lcps.astype(np.int32)


def bands_mirror(ids: np.ndarray, lcps: np.ndarray, k: int):
    """The pool kernel's band passes over one tile, in numpy: the entries'
    lcp histogram gives t0 = max{t : entries with lcp >= t >= k}; the
    entries with lcp >= t are deduped (each id's max lcp), and while that
    leaves fewer than k ids and some entry out, t drops to the largest t'
    whose entries >= t' at least double the band and add one an id still
    missing.  Returns (ids, lcps)
    of the first k deduped ids by (lcp descending, id ascending), -1-padded
    to k, and the passes' floors."""
    live = (ids >= 0) & (lcps >= 0)
    lcp = np.minimum(lcps, 256)
    ge = np.append(np.cumsum(np.bincount(lcp[live], minlength=257)[::-1])[::-1], 0)
    t = max([t for t in range(257) if ge[t] >= k], default=0)
    floors = []
    while True:
        floors.append(t)
        band = live & (lcp >= t)
        best = {}
        for i, v in zip(ids[band].tolist(), lcp[band].tolist()):
            best[i] = max(best.get(i, -1), v)
        if len(best) >= k or ge[t] == ge[0]:
            break
        want = max(2 * ge[t], ge[t] + k - len(best))
        t -= 1
        while t > 0 and ge[t] < want:
            t -= 1
    top = sorted(best.items(), key=lambda iv: (-iv[1], iv[0]))[:k]
    out = np.full((2, k), -1, dtype=np.int32)
    if top:
        out[:, :len(top)] = np.array(top, dtype=np.int32).T
    return out[0], out[1], floors

