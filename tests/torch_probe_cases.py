"""Probe worklists for the CSA probe tests, made from a numpy seed: shared by
the CPU parity tests (tests/test_torch_probe.py) and the on-card tests
(tests/test_torch_kernels_cuda.py), so that both hold the kernel's function
to the same cases.  Imports neither JAX nor the reference package.

The cases aim at what a probe kernel can get wrong: group widths and shifts
that are not a multiple of four symbols (m), a corpus that is not a power of
two (n), long common prefixes and equal rows (a small alphabet, duplicated
rows), insertion points at 0 and at n, and windows wider than the corpus."""
import numpy as np

# name -> (n, m, width, symbols in the alphabet, share of rows duplicated);
# the first four keep the names (n-m-W-a) of the cases they grew from, whose
# alphabet was the 2a + 1 symbols -a..a
PROBE_CASES = {
    "97-8-4-1": (97, 8, 4, 3, 0.0),  # odd n, heavy ties
    "200-7-6-2": (200, 7, 6, 5, 0.0),  # m 7: shifts and m not a multiple of 4
    "64-5-40-1": (64, 5, 40, 3, 0.0),  # 2W > n: clipped windows
    "300-16-16-3": (300, 16, 16, 7, 0.0),
    "m 1": (300, 1, 8, 4, 0.0),
    "m 8": (1000, 8, 12, 2, 0.1),
    "m 33": (4097, 33, 20, 3, 0.0),
    "m 64": (4097, 64, 40, 4, 0.05),
    "m 65": (1000, 65, 24, 3, 0.0),
    "m 256": (1000, 256, 16, 3, 0.0),
    "n 1": (1, 16, 4, 3, 0.0),
    "n 2": (2, 9, 3, 2, 0.0),
    "alphabet 2, duplicate rows": (4097, 64, 32, 2, 0.3),
    "W > n": (50, 12, 80, 2, 0.2),
}
ROWS = 48  # worklist rows of a case
PROBES = 12  # probe strings of a case


def make_case(name: str, seed: int = 0):
    """(h (n, m), qd (B, 2m), shifts (R,), qidx (R,), width) int32 of case
    `name`.  The probes are: one below every symbol (pos 0 at every shift),
    one above (pos n), copies of data rows (lcp m), copies with one late
    symbol changed (long lcps), and random strings, two of them also over
    one symbol past each end of the alphabet (a mismatch anywhere against a
    symbol no row holds); the worklist reaches each probe at least once, the
    first two at several shifts."""
    n, m, width, alphabet, dup = PROBE_CASES[name]
    rng = np.random.default_rng([seed, len(name), n, m])
    lo = -(alphabet // 2)
    h = rng.integers(lo, lo + alphabet, size=(n, m))
    n_dup = int(dup * n)
    if n_dup:
        h[rng.choice(n, n_dup, replace=False)] = h[rng.integers(0, n, n_dup)]
    q = rng.integers(lo, lo + alphabet, size=(PROBES, m))
    q[0] = lo - 5
    q[1] = lo + alphabet + 5
    q[2:6] = h[rng.integers(0, n, 4)]
    q[6:9] = h[rng.integers(0, n, 3)]
    at = rng.integers(m // 2, m, 3)
    q[np.arange(6, 9), at] = q[np.arange(6, 9), at] + rng.choice([-1, 1], 3)
    q[9:11] = rng.integers(lo - 1, lo + alphabet + 1, size=(2, m))
    qd = np.concatenate([q, q], axis=1)
    shifts = rng.integers(0, m, ROWS)
    qidx = np.concatenate([np.arange(PROBES), rng.integers(0, PROBES, ROWS - PROBES)])
    qidx[PROBES:PROBES + 4] = [0, 0, 1, 1]
    i32 = np.int32
    return h.astype(i32), qd.astype(i32), shifts.astype(i32), qidx.astype(i32), width
