"""Verify inputs for the gather tests, made from a numpy seed: shared by the
CPU parity tests (tests/test_torch_gather.py) and the on-card tests
(tests/test_torch_kernels_cuda.py), so that both hold the fused verify
(`gather_topk`, `gather_topk_q`) and the scans to the same cases.  Imports
neither JAX nor the reference package.

The cases aim at what a verify kernel can get wrong: widths that take the
16-byte or the element-by-element row path (d 13 and 16 for int8), lanes a
candidate from 1 to 32 (d 16 to 960), k below, at and above the candidate
count (padding), one candidate, a row of candidates longer than one block
sorts (TOPK_TILE), a query row of -1 ids, duplicate store rows (exact ties,
which both frameworks break to the lower slot), a zero row (NaN under
angular, mapped to 1), a query equal to a row (distance 0) and report ids
that differ from the candidate ids."""
import numpy as np

# name -> (n, d, B, L, k); k also sets the survivors budget min(4k, L)
VERIFY_CASES = {
    "d 13, L 7, k < L": (60, 13, 4, 7, 3),
    "d 16, L 1, k = L": (40, 16, 3, 1, 1),
    "d 16, L 7, k > L": (40, 16, 3, 7, 10),
    "d 128, L 100, k 10": (3000, 128, 6, 100, 10),
    "d 128, L 257, k = L": (3000, 128, 3, 257, 257),
    "d 960, L 100, k 40": (500, 960, 3, 100, 40),
    "d 16, L 10000 (several tiles)": (20000, 16, 2, 10000, 50),
}
ZERO_ROW = 3
DUP = (5, 10)  # rows 5..9 copy rows 10..14


def survivor_budget(name: str) -> int:
    _, _, _, L, k = VERIFY_CASES[name]
    return min(4 * k, L)


def make_case(name: str, seed: int = 0):
    """(data (n, d) f32, ids (B, L) i32, report (B, L) i32, queries (B, d)
    f32, k) of case `name`.  ids lie in [-1, n); the last query's row is
    all -1 (when B > 1); query 0 sees the zero row and a duplicate pair
    (slots 0, 1, 2), query 1 (when B > 2) a query equal to its first
    candidate's row; report maps ids through a permutation of [0, n)
    shifted by n, -1 staying -1."""
    n, d, B, L, k = VERIFY_CASES[name]
    rng = np.random.default_rng([seed, len(name), n, d, L])
    data = rng.normal(size=(n, d)).astype(np.float32)
    data[ZERO_ROW] = 0.0
    data[DUP[0]:DUP[0] + 5] = data[DUP[1]:DUP[1] + 5]
    ids = rng.integers(-1, n, size=(B, L))
    ids[0, :3] = [ZERO_ROW, DUP[0], DUP[1]][:L]
    if B > 1:
        ids[B - 1] = -1
    queries = rng.normal(size=(B, d)).astype(np.float32)
    if B > 2 and ids[1, 0] >= 0:
        queries[1] = data[ids[1, 0]]
    perm = rng.permutation(n) + n
    report = np.where(ids >= 0, perm[np.maximum(ids, 0)], -1)
    i32 = np.int32
    return data, ids.astype(i32), report.astype(i32), queries, k
