"""Port parity: the CSA tables built by `repro_torch.core.csa.build_csa` from
the reference's hash matrix are bit-identical to `repro.core.csa.build_csa`
(and to the literal Algorithm-1 oracle), including non-power-of-two m and
heavy ties."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as ref_lsh
from repro.core.csa import build_csa as ref_build_csa
from repro.core.csa import build_csa_oracle, circular_ranks as ref_ranks
from repro_torch.core.bruteforce import bruteforce_topk
from repro_torch.core.csa import build_csa, circular_ranks
from repro_torch.kernels.circrun import circrun

torch.set_num_threads(2)


@pytest.mark.parametrize("n,m,alphabet", [
    (500, 16, 9),     # pow2 m
    (301, 7, 3),      # non-pow2 m, odd n
    (257, 5, 1),      # heavy ties: symbols in {-1, 0, 1}
    (200, 12, 0),     # every string equal: ids break all ties
    (1000, 13, 40),   # ranks distinct after round 0 (early exit)
    (64, 1, 4),       # m == 1
])
def test_tables_bit_identical(n, m, alphabet):
    rng = np.random.default_rng(n + m)
    h = rng.integers(-alphabet, alphabet + 1, size=(n, m)).astype(np.int32)
    ref = ref_build_csa(jnp.asarray(h))
    ours = build_csa(torch.from_numpy(h))
    for name, a, b in zip("I P Hd L".split(), [ref.I, ref.P, ref.Hd, ref.L],
                          [ours.I, ours.P, ours.Hd, ours.L]):
        assert b.dtype == torch.int32, name
        assert np.array_equal(np.asarray(a), b.numpy()), name
    assert np.array_equal(circular_ranks(torch.from_numpy(h)).numpy(),
                          np.asarray(ref_ranks(jnp.asarray(h))))
    if n <= 500:
        I_o, P_o = build_csa_oracle(h)
        assert np.array_equal(ours.I.numpy(), I_o) and np.array_equal(ours.P.numpy(), P_o)


def test_from_reference_family_hash():
    """The tables from the reference's own `h` of real data (RP family)."""
    X = np.random.default_rng(0).normal(size=(1500, 16)).astype(np.float32)
    fam = ref_lsh.make_family("euclidean", jax.random.key(0), 16, 16, w=4.0)
    h = np.asarray(fam.hash(jnp.asarray(X)))
    ref = ref_build_csa(jnp.asarray(h))
    ours = build_csa(torch.from_numpy(h))
    for a, b in zip([ref.I, ref.P, ref.Hd, ref.L], [ours.I, ours.P, ours.Hd, ours.L]):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n,m,lam", [(300, 8, 20), (50, 6, 80)])
def test_bruteforce_parity(n, m, lam):
    from repro.core.bruteforce import bruteforce_topk as ref_bf
    from repro.core.bruteforce import circ_run_lengths as ref_crl

    rng = np.random.default_rng(n)
    h = rng.integers(-1, 2, size=(n, m)).astype(np.int32)
    q = rng.integers(-1, 2, size=(4, m)).astype(np.int32)
    assert np.array_equal(circrun(torch.from_numpy(h), torch.from_numpy(q[0])).numpy(),
                          np.asarray(ref_crl(jnp.asarray(h), jnp.asarray(q[0]))))
    ri, rl = ref_bf(jnp.asarray(h), jnp.asarray(q), lam)
    oi, ol = bruteforce_topk(torch.from_numpy(h), torch.from_numpy(q), lam)
    assert np.array_equal(oi.numpy(), np.asarray(ri))  # ties -> lower id, as lax.top_k
    assert np.array_equal(ol.numpy(), np.asarray(rl))
