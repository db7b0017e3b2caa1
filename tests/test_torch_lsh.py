"""Port parity: LSH families carried across from the reference's arrays.

XP-pseudo (the same butterflies in the same order) and bit-sampling hash
bit-identically.  RP and XP-gaussian go through a float matmul whose
summation order differs between the two libraries, so a hash may differ only
where the projection lies within 1e-4 * w of a bucket boundary (RP) or the
top two rotated magnitudes are within 1e-5 (XP-gaussian)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as ref_lsh
from repro_torch.core import lsh

torch.set_num_threads(2)


def _carry(fam):
    """The reference family's arrays as a port family (what `load` does)."""
    import dataclasses

    fields = {k: (torch.from_numpy(np.array(v)) if isinstance(v, jax.Array) else v)
              for k, v in dataclasses.asdict(fam).items()}
    return lsh.FAMILIES[type(fam).__name__](**fields)


def _data(kind, n, d, seed):
    X = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return (X > 0).astype(np.float32) if kind == "hamming" else X


@pytest.mark.parametrize("kind,kw,d,m", [
    ("euclidean", dict(w=4.0), 24, 12), ("euclidean", dict(w=0.5), 17, 7),
    ("angular", dict(), 24, 12), ("angular", dict(), 13, 5),
    ("angular", dict(rotation="gaussian"), 16, 8),
    ("hamming", dict(), 32, 16),
])
def test_hash_and_alternatives_parity(kind, kw, d, m):
    ref = ref_lsh.make_family(kind, jax.random.key(3), d, m, **kw)
    fam = _carry(ref)
    X = _data(kind, 800, d, seed=m)
    h_ref = np.asarray(ref.hash(jnp.asarray(X)))
    h = fam.hash(torch.from_numpy(X)).numpy()
    assert h.dtype == np.int32
    diff = h != h_ref
    if isinstance(ref, ref_lsh.RandomProjectionLSH):
        proj = (X.astype(np.float64) @ np.asarray(ref.a, np.float64) + np.asarray(ref.b)) / ref.w
        near = np.abs(proj - np.round(proj)) < 1e-4
        assert not (diff & ~near).any()
    elif kind == "angular" and kw.get("rotation") == "gaussian":
        y = np.abs(np.einsum("nd,mde->nme", X.astype(np.float64), np.asarray(ref.rot, np.float64)))
        top2 = np.sort(y, axis=-1)[..., -2:]
        near = (top2[..., 1] - top2[..., 0]) < 1e-5
        assert not (diff & ~near).any()
    else:
        assert not diff.any()  # pseudo-rotation and bit sampling: exact
    # alternatives (batched multiprobe input), on rows hashed identically
    Q = X[:32]
    v_ref, s_ref = ref.alternatives(jnp.asarray(Q), 4)
    v, s = fam.alternatives(torch.from_numpy(Q), 4)
    ok = ~diff[:32].any(axis=1)
    np.testing.assert_allclose(s.numpy()[ok], np.asarray(s_ref)[ok], rtol=1e-4, atol=1e-4)
    if kind != "euclidean" and kw.get("rotation") != "gaussian":
        assert np.array_equal(v.numpy()[ok], np.asarray(v_ref)[ok])


@pytest.mark.parametrize("kind,kw", [("euclidean", dict(w=2.0)), ("angular", {}),
                                     ("angular", dict(rotation="gaussian")), ("hamming", {})])
def test_create_is_seeded_and_shaped(kind, kw):
    a = lsh.make_family(kind, 5, 20, 9, **kw)
    b = lsh.make_family(kind, 5, 20, 9, **kw)
    X = torch.from_numpy(_data(kind, 50, 20, 0))
    h = a.hash(X)
    assert h.shape == (50, 9) and h.dtype == torch.int32
    assert torch.equal(h, b.hash(X))
    assert a.m == 9


@pytest.mark.parametrize("metric", ["euclidean", "angular", "hamming"])
def test_distance_parity_with_zero_rows(metric):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 5, 16)).astype(np.float32)
    y = rng.normal(size=(6, 1, 16)).astype(np.float32)
    if metric == "hamming":
        x, y = (x > 0).astype(np.float32), (y > 0).astype(np.float32)
    x[0, 0] = 0.0  # clamped-norm angular: finite, not NaN
    ref = np.asarray(ref_lsh.distance(jnp.asarray(x), jnp.asarray(y), metric))
    ours = lsh.distance(torch.from_numpy(x), torch.from_numpy(y), metric).numpy()
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
