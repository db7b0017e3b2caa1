"""Port parity for the paper's closed forms: `repro_torch.core.theory`
against `repro.core.theory` (equal values, rtol 1e-12, and equal errors),
and each family's `collision_prob`, carried across from the reference's
arrays (equal values)."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import lsh as ref_lsh
from repro.core import theory as ref_theory
from repro_torch.core import lsh, theory

VALUE_CASES = [
    ("normal_cdf", (0.3,)),
    ("normal_cdf", (np.linspace(-6.0, 6.0, 25),)),
    ("rp_collision_prob", (0.0, 4.0)),
    ("rp_collision_prob", (-1.0, 4.0)),
    ("rp_collision_prob", (0.57, 16.0)),
    ("rp_collision_prob", (1.5, 4.0)),
    ("rp_collision_prob", (400.0, 16.0)),
    ("xp_collision_prob", (0.0, 128)),
    ("xp_collision_prob", (0.7, 128)),
    ("xp_collision_prob", (1.2, 1)),
    ("xp_collision_prob", (2.5, 64)),  # clamped below 2
    ("rho", (0.9, 0.5)),
    ("rho", (0.999, 0.001)),
    ("xp_rho", (0.5, 2.0)),
    ("xp_rho", (1.0, 1.5)),
    ("lccs_cdf", (np.arange(0, 24), 64, 0.7)),
    ("lccs_cdf", (3.5, 64, 0.5)),
    ("lccs_median", (64, 0.7)),
    ("lccs_median", (1024, 0.3)),
    ("lccs_quantile", (0.25, 64, 0.7)),
    ("lccs_quantile", (0.99, 256, 0.9)),
    ("theorem51_lambda", (64, 10**6, 0.9715, 0.943)),
    ("theorem51_lambda", (32, 4000, 0.8, 0.3)),
    ("theorem51_lambda", (10**6, 1, 0.5, 0.3)),  # kept >= 1
    ("suggest_m", (10**6, 0.5, 0.9, 0.5)),
    ("suggest_m", (100, 0.1, 0.6, 0.5)),  # kept >= 8
]

ERROR_CASES = [
    ("rho", (0.5, 0.9)),
    ("rho", (1.0, 0.5)),
    ("rho", (0.9, 0.0)),
    ("xp_rho", (2.0, 1.0)),  # 4 - R^2 = 0
    ("lccs_quantile", (0.0, 64, 0.7)),
    ("lccs_quantile", (1.0, 64, 0.7)),
    ("theorem51_lambda", (64, 100, 0.5, 0.9)),
    ("theorem51_lambda", (8, 10, 0.999999, 0.5)),  # (1 - p1)^(-1/rho) overflows
    ("suggest_m", (100, 0.5, 0.4, 0.9)),
]


@pytest.mark.parametrize("name,args", VALUE_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(VALUE_CASES)])
def test_theory_values_match_reference(name, args):
    ours = getattr(theory, name)(*args)
    ref = getattr(ref_theory, name)(*args)
    assert type(ours) is type(ref)
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)
    assert np.all(np.isfinite(ours))


@pytest.mark.parametrize("name,args", ERROR_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(ERROR_CASES)])
def test_theory_errors_match_reference(name, args):
    with pytest.raises(Exception) as ref_err:
        getattr(ref_theory, name)(*args)
    with pytest.raises(ref_err.type) as our_err:
        getattr(theory, name)(*args)
    assert str(our_err.value) == str(ref_err.value)


def _carry(fam):
    """The reference family's arrays as a port family on the CPU."""
    fields = {k: (np.asarray(v) if isinstance(v, jax.Array) else v)
              for k, v in dataclasses.asdict(fam).items()}
    return lsh.family_from_arrays(type(fam).__name__, fields, "cpu")


@pytest.mark.parametrize("kind,kw,d", [
    ("euclidean", dict(w=4.0), 24), ("euclidean", dict(w=16.0), 128),
    ("angular", {}, 24), ("angular", dict(rotation="gaussian"), 16),
    ("hamming", {}, 32),
])
def test_collision_prob_matches_reference(kind, kw, d):
    ref = ref_lsh.make_family(kind, jax.random.key(2), d, 8, **kw)
    ours = _carry(ref)
    for tau in (0.0, 0.1, 0.57, 1.0, 1.9, 3.0, 17.0):
        assert ours.collision_prob(tau) == ref.collision_prob(tau)
    # the drawn families keep the closed form of their kind and width
    drawn = lsh.make_family(kind, 2, d, 8, device="cpu", **kw)
    assert drawn.collision_prob(0.57) == ref.collision_prob(0.57)
