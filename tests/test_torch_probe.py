"""Port parity: the fused CSA probe's plain version, the scatter-max dedupe
and the legacy window search are bit-identical to the reference -- the
Pallas kernel in interpret mode, its jnp oracle, and `core.search`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.csa import build_csa as ref_build_csa
from repro.core.search import dedupe_topk as ref_dedupe
from repro.core.search import klccs_search as ref_search
from repro.core.search import klccs_search_pairs as ref_pairs
from repro.core.search import klccs_search_with_lens as ref_lens
from repro.kernels.csa_probe.csa_probe import csa_probe_pallas
from repro.kernels.csa_probe.ref import dedupe_topk_scatter as ref_scatter
from repro.kernels.csa_probe.ref import probe_pairs_ref as ref_probe_pairs
from repro_torch.core.csa import build_csa
from repro_torch.core.search import (
    dedupe_topk,
    klccs_search,
    klccs_search_pairs,
    klccs_search_with_lens,
)
from repro_torch.kernels import csa_probe as probe_mod
from repro_torch.kernels.common import launch_counts, reset_launch_counts

torch.set_num_threads(2)


def _tables(n, m, alphabet, seed):
    rng = np.random.default_rng(seed)
    h = rng.integers(-alphabet, alphabet + 1, size=(n, m)).astype(np.int32)
    return rng, ref_build_csa(jnp.asarray(h)), build_csa(torch.from_numpy(h))


def _eq(a, b):
    return np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n,m,width,alphabet", [
    (97, 8, 4, 1),     # odd n, heavy ties
    (200, 7, 6, 2),    # non-pow2 m
    (64, 5, 40, 1),    # 2W > n: clipped windows, insertion at 0 / n
    (300, 16, 16, 3),
])
def test_plain_probe_equals_pallas_interpret_and_oracle(n, m, width, alphabet):
    rng, ref, ours = _tables(n, m, alphabet, seed=n + m)
    B, R = 6, 40
    q = rng.integers(-alphabet - 1, alphabet + 2, size=(B, m)).astype(np.int32)
    q[0] = -alphabet - 5  # sorts before every string: pos == 0
    q[1] = alphabet + 5   # after every string: pos == n
    qd = np.concatenate([q, q], axis=1)
    shifts = rng.integers(0, m, R).astype(np.int32)
    qidx = rng.integers(0, B, R).astype(np.int32)
    qidx[:2] = [0, 1]
    pi, pl = csa_probe_pallas(ref.I, ref.L, ref.Hd, jnp.asarray(qd), jnp.asarray(shifts),
                              jnp.asarray(qidx), width=width, interpret=True)
    oi, ol = ref_probe_pairs(ref, jnp.asarray(qd[qidx]), jnp.asarray(shifts), width)
    reset_launch_counts()
    ti, tl = probe_mod.csa_probe(ours.I, ours.L, ours.Hd, torch.from_numpy(qd),
                                 torch.from_numpy(shifts), torch.from_numpy(qidx), width)
    assert launch_counts()["csa_probe"] == 0  # CPU tensors: the plain version
    assert ti.dtype == torch.int32 and ti.shape == (R, 2 * width)
    assert _eq(pi, ti) and _eq(pl, tl)
    assert _eq(oi, ti) and _eq(ol, tl)


@pytest.mark.parametrize("B,pool,n,lam", [(5, 300, 60, 20), (3, 50, 400, 100),
                                          (4, 200, 30, 45)])
def test_dedupe_scatter_equals_reference(B, pool, n, lam):
    rng = np.random.default_rng(pool)
    ids = rng.integers(-1, n, size=(B, pool)).astype(np.int32)
    lcps = rng.integers(0, 6, size=(B, pool)).astype(np.int32)  # full of ties
    ri, rv = ref_scatter(jnp.asarray(ids), jnp.asarray(lcps), n, lam)
    ti, tv = probe_mod.dedupe_topk_scatter(torch.from_numpy(ids), torch.from_numpy(lcps), n, lam)
    assert _eq(ri, ti) and _eq(rv, tv)  # ids, values and order
    li, lv = jax.vmap(lambda i, v: ref_dedupe(i, v, lam))(jnp.asarray(ids), jnp.asarray(lcps))
    di, dv = dedupe_topk(torch.from_numpy(ids), torch.from_numpy(lcps), lam)
    assert _eq(li, di) and _eq(lv, dv)
    assert torch.equal(ti, di) and torch.equal(tv, dv)


@pytest.mark.parametrize("mode", ["parallel", "narrowed"])
@pytest.mark.parametrize("n,m,width,lam", [(150, 8, 6, 20), (90, 6, 50, 120)])
def test_legacy_search_bit_identical(mode, n, m, width, lam):
    rng, ref, ours = _tables(n, m, 1, seed=7 * n)
    q = rng.integers(-1, 2, size=(5, m)).astype(np.int32)
    ri, rl = ref_search(ref, jnp.asarray(q), lam, width=width, mode=mode)
    ti, tl = klccs_search(ours, torch.from_numpy(q), lam, width=width, mode=mode)
    assert _eq(ri, ti) and _eq(rl, tl)
    if mode == "parallel":
        # the fused search == the legacy one, and == the reference
        fi, fl = probe_mod.csa_probe_search(ours, torch.from_numpy(q), lam, width=width)
        assert torch.equal(fi, ti) and torch.equal(fl, tl)
        # the full-shift plain form == the worklist wrapper's windows
        wi, wl = probe_mod.csa_probe_windows(ours, torch.from_numpy(q), width=width)
        si, sl = probe_mod.search_windows_ref(
            ours, torch.from_numpy(np.concatenate([q, q], axis=1)), width)
        assert torch.equal(wi, si) and torch.equal(wl, sl)
        ri, rl, rm = ref_lens(ref, jnp.asarray(q), lam, width=width)
        ti, tl, tm = klccs_search_with_lens(ours, torch.from_numpy(q), lam, width=width)
        fi, fl, fm = probe_mod.csa_probe_search_with_lens(ours, torch.from_numpy(q), lam,
                                                          width=width)
        assert _eq(ri, ti) and _eq(rl, tl) and _eq(rm, tm)
        assert torch.equal(fi, ti) and torch.equal(fl, tl) and torch.equal(fm, tm)


def test_pairs_bit_identical():
    rng, ref, ours = _tables(120, 9, 2, seed=3)
    R, width = 30, 5
    rows = rng.integers(-2, 3, size=(R, 9)).astype(np.int32)
    shifts = rng.integers(0, 9, R).astype(np.int32)
    valid = rng.random(R) < 0.7
    ri, rl = ref_pairs(ref, jnp.asarray(rows), jnp.asarray(shifts), jnp.asarray(valid),
                       width=width)
    args = (torch.from_numpy(rows), torch.from_numpy(shifts), torch.from_numpy(valid))
    ti, tl = klccs_search_pairs(ours, *args, width=width)
    fi, fl = probe_mod.csa_probe_pairs(ours, *args, width=width)
    assert _eq(ri, ti) and _eq(rl, tl)
    assert torch.equal(fi, ti) and torch.equal(fl, tl)


def test_probe_rejects_other_devices():
    _, _, ours = _tables(40, 4, 1, seed=0)
    meta = torch.empty((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        probe_mod.csa_probe(ours.I, ours.L, ours.Hd, meta,
                            torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32), 4)
