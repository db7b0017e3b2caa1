"""Port parity for the hashing kernels' plain versions (`hash_rp_ref`,
`hash_xp_ref`), which the CPU runs in place of the CUDA kernels B4 and B5.

  * hash_xp: the port equals `hash_xp_pallas` (interpret mode) and the
    reference's `hash_xp_ref` exactly, on gaussian inputs and on small
    integer inputs, where the arithmetic is exact and ties are common (the
    first index wins);
  * hash_rp: equal except at bucket boundaries: a mismatch is +-1 and lies
    where the float64 value of (x.a + b) / w is within 1e-5 (relative) of an
    integer -- the summation orders of XLA and torch differ;
  * a gaussian family carried across with `family_from_arrays` hashes like
    the reference's `CrossPolytopeLSH.hash`, except at near ties;
  * on the CPU too, no multiprobe alternative equals the base symbol.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as ref_lsh
from repro.kernels.hash_rp.hash_rp import hash_rp_pallas
from repro.kernels.hash_rp.ref import hash_rp_ref as ref_hash_rp_ref
from repro.kernels.hash_xp.hash_xp import hash_xp_pallas
from repro.kernels.hash_xp.ref import hash_xp_ref as ref_hash_xp_ref
from repro_torch.core import lsh
from repro_torch.kernels.hash_rp import hash_rp, hash_rp_ref
from repro_torch.kernels.hash_xp import hash_xp, hash_xp_ref

torch.set_num_threads(2)

BOUNDARY_RTOL = 1e-5


def _carry(fam):
    fields = {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
              for f in dataclasses.fields(fam) for v in [getattr(fam, f.name)]}
    return lsh.family_from_arrays(type(fam).__name__, fields, "cpu")


@pytest.mark.parametrize("ints", [False, True])
@pytest.mark.parametrize("n,d,dr,m", [(1, 8, 8, 1), (300, 50, 32, 7), (130, 16, 24, 5),
                                      # the paper's glove, msong and gist widths (the CUDA
                                      # kernel keeps x in shared memory up to d = 160 and
                                      # streams it beyond)
                                      (20, 100, 32, 64), (20, 420, 32, 64), (20, 960, 32, 64)])
def test_hash_xp_plain_equals_pallas_and_reference(n, d, dr, m, ints):
    rng = np.random.default_rng(n + d)
    if ints:  # exact sums: ties between vertices are common
        x = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
        rot = rng.integers(-1, 2, size=(m, d, dr)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        rot = rng.normal(size=(m, d, dr)).astype(np.float32)
    ours = hash_xp(torch.from_numpy(x), torch.from_numpy(rot)).numpy()
    assert ours.dtype == np.int32 and ours.shape == (n, m)
    pallas = np.asarray(hash_xp_pallas(jnp.asarray(x), jnp.asarray(rot), block_n=128,
                                       interpret=True))
    ref = np.asarray(ref_hash_xp_ref(jnp.asarray(x), jnp.asarray(rot)))
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, ref)


def test_hash_xp_plain_chunks_rows(monkeypatch):
    from repro_torch.kernels.hash_xp import ref

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(50, 12)).astype(np.float32))
    rot = torch.from_numpy(rng.normal(size=(3, 12, 8)).astype(np.float32))
    whole = hash_xp_ref(x, rot)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 3 * 3 * 8 * 7)  # 7 rows a chunk
    assert torch.equal(hash_xp_ref(x, rot), whole)


@pytest.mark.parametrize("n,d,m,w", [(1, 3, 5, 1.0), (300, 50, 33, 4.0), (257, 129, 64, 16.0),
                                     # the paper's glove, msong and gist widths
                                     (20, 100, 64, 16.0), (20, 420, 64, 16.0),
                                     (20, 960, 64, 16.0)])
def test_hash_rp_plain_matches_pallas_except_boundaries(n, d, m, w):
    rng = np.random.default_rng(d)
    x = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    a = rng.normal(size=(d, m)).astype(np.float32)
    b = rng.uniform(0, w, m).astype(np.float32)
    ours = hash_rp(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b), w=w).numpy()
    assert ours.dtype == np.int32 and ours.shape == (n, m)
    v = (x.astype(np.float64) @ a.astype(np.float64) + b) / w
    near = np.abs(v - np.round(v)) <= BOUNDARY_RTOL * np.maximum(1.0, np.abs(v))
    for other in (
        hash_rp_pallas(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), w=w, block_n=128,
                       block_m=128, block_d=128, interpret=True),
        ref_hash_rp_ref(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), w=w),
    ):
        diff = ours != np.asarray(other)
        assert (np.abs(ours - np.asarray(other)) <= 1).all()
        assert not (diff & ~near).any()
    # the family's hash is the same function
    fam = lsh.RandomProjectionLSH(a=torch.from_numpy(a), b=torch.from_numpy(b), w=w)
    assert np.array_equal(fam.hash(torch.from_numpy(x)).numpy(), ours)


@pytest.mark.parametrize("d,m", [(16, 8), (24, 12)])
def test_carried_gaussian_family_hashes_like_reference(d, m):
    ref = ref_lsh.make_family("angular", jax.random.key(4), d, m, rotation="gaussian")
    fam = _carry(ref)
    assert fam.rotation == "gaussian" and fam.rot.shape == (m, d, d)
    X = np.random.default_rng(m).normal(size=(600, d)).astype(np.float32)
    X[0] = 0.0  # every vertex ties: index 0 in both
    h_ref = np.asarray(ref.hash(jnp.asarray(X)))
    h = fam.hash(torch.from_numpy(X)).numpy()
    assert h.dtype == np.int32 and (h[0] == 0).all()
    y = np.einsum("nd,mde->nme", X.astype(np.float64), np.asarray(ref.rot, np.float64))
    top2 = np.sort(np.concatenate([y, -y], axis=-1), axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= BOUNDARY_RTOL * np.abs(top2[..., 1])
    assert not ((h != h_ref) & ~near).any()


@pytest.mark.parametrize("kind,kw", [("euclidean", dict(w=1.0)), ("angular", {}),
                                     ("angular", dict(rotation="gaussian"))])
def test_alternatives_never_equal_base(kind, kw):
    fam = lsh.make_family(kind, 9, 20, 10, **kw)
    Q = torch.from_numpy(np.random.default_rng(2).normal(size=(200, 20)).astype(np.float32))
    vals, scores = fam.alternatives(Q, 4)
    assert vals.shape == (200, 10, 4)
    assert not bool((vals == fam.hash(Q)[..., None]).any())
    assert bool((scores[..., 1:] >= scores[..., :-1]).all())  # ascending penalty
