"""Port parity: the fused CSA probe's plain version, the scatter-max dedupe
and the legacy window search are bit-identical to the reference -- the
Pallas kernel in interpret mode, its jnp oracle, and `core.search`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_probe_cases import PROBE_CASES, make_case

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


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_plain_probe_equals_pallas_interpret_and_oracle(case):
    h, qd, shifts, qidx, width = make_case(case)
    ref, ours = ref_build_csa(jnp.asarray(h)), build_csa(torch.from_numpy(h))
    R = shifts.shape[0]
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
    # probe 0 sorts before every string (pos 0), probe 1 after (pos n): the
    # window holds the first / last W sorted ids, clipped to n
    I, n, jj = ours.I.numpy(), h.shape[0], np.arange(width)
    for r in np.flatnonzero(qidx == 0):
        assert np.array_equal(ti[r, width:].numpy(), I[shifts[r], np.minimum(jj, n - 1)])
    for r in np.flatnonzero(qidx == 1):
        assert np.array_equal(ti[r, :width].numpy(), I[shifts[r], np.maximum(n - width + jj, 0)])


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


def _sorted_by_shift(I, Hd):
    """True when each I[i] lists the rows in the order of their shift-i
    strings Hd[:, i:i+m] (equal strings in any order)."""
    m = I.shape[0]
    for i in range(m):
        s = Hd[I[i].long(), i:i + m].long()
        d = s[1:] - s[:-1]
        first = torch.gather(d, 1, (d != 0).int().argmax(dim=1, keepdim=True))[:, 0]
        if bool((first < 0).any()):
            return False
    return True


@pytest.mark.parametrize("source", ["lccs", "multiprobe-full", "multiprobe-skip", "dynamic"])
def test_index_path_hands_the_probe_sorted_tables(monkeypatch, source):
    """The kernel's search skips the prefix the rows around a step share with
    the probe, which holds only for tables sorted by their shift-i strings:
    every table the index path hands to `csa_probe` is (a CSA from
    `build_csa`, also after inserts and a compaction)."""
    from repro_torch import LCCSIndex, SearchParams, SegmentedLCCSIndex

    seen, real = [], probe_mod.ops.csa_probe

    def spy(I, L, Hd, *rest):
        seen.append((I, Hd))
        return real(I, L, Hd, *rest)

    monkeypatch.setattr(probe_mod.ops, "csa_probe", spy)
    rng = np.random.default_rng(7)
    X = rng.normal(size=(600, 16)).astype(np.float32)
    Q = X[:5] + 0.01
    kw = dict(m=12, family="euclidean", w=4.0, device="cpu")
    params = SearchParams(k=5, lam=40, width=8, use_probe_kernel=True,
                          source="lccs" if source == "dynamic" else source,
                          probes=1 if source in ("lccs", "dynamic") else 5)
    if source == "dynamic":
        idx = SegmentedLCCSIndex.build(X[:400], **kw)
        idx.insert(X[400:])
        idx.compact(full=True)
    else:
        idx = LCCSIndex.build(X, **kw)
    ids, _ = idx.search(Q, params)
    assert ids[:, 0].tolist() == list(range(5))
    assert seen and all(_sorted_by_shift(I, Hd) for I, Hd in seen)
    # the check itself tells an unsorted table apart
    I, Hd = seen[0]
    assert not _sorted_by_shift(I.flip(1), Hd)


def test_probe_rejects_other_devices():
    _, _, ours = _tables(40, 4, 1, seed=0)
    meta = torch.empty((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        probe_mod.csa_probe(ours.I, ours.L, ours.Hd, meta,
                            torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32), 4)
