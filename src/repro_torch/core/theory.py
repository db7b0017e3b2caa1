"""Theory module (numpy; copy of `repro.core.theory`): collision
probabilities, hash quality rho, and the Theorem 5.1 candidate budget for
LCCS-LSH.

Implements the closed forms from the paper:
  - Eq. (2): collision probability of the random-projection family
    (Datar et al. 2004) at distance tau for bucket width w.
  - Eq. (4)/(5): cross-polytope collision probability / rho
    (Andoni et al. 2015) asymptotics.
  - Lemma 5.2: extreme-value CDF F_hat_{m,p}(x) ~ exp(-p^(x - log_{1/p}(m(1-p))))
    for the LCCS length distribution.
  - Theorem 5.1: lambda = m^{1-1/rho} * n * (1-p1)^{-1/rho} * (1-p2) * (ln 2)^{1/rho} / p2.
"""
from __future__ import annotations

import math

import numpy as np


def normal_cdf(x: np.ndarray | float) -> np.ndarray | float:
    return 0.5 * (1.0 + np.vectorize(math.erf)(np.asarray(x, dtype=np.float64) / math.sqrt(2.0)))


def rp_collision_prob(tau: float, w: float) -> float:
    """Eq. (2): P[h(o) == h(q)] for the random-projection family at ||o-q|| = tau."""
    if tau <= 0.0:
        return 1.0
    r = w / tau
    term1 = 1.0 - 2.0 * float(normal_cdf(-r))
    term2 = (2.0 / (math.sqrt(2.0 * math.pi) * r)) * (1.0 - math.exp(-(r * r) / 2.0))
    return max(0.0, min(1.0, term1 - term2))


def xp_collision_prob(tau: float, d: int) -> float:
    """Eq. (4): cross-polytope family, ln(1/p) = tau^2/(4-tau^2) * ln d  (leading term).

    tau is Euclidean distance between unit vectors, 0 < tau < 2.
    """
    if tau <= 0.0:
        return 1.0
    tau = min(tau, 2.0 - 1e-9)
    ln_inv_p = (tau * tau) / (4.0 - tau * tau) * math.log(max(d, 2))
    return math.exp(-ln_inv_p)


def rho(p1: float, p2: float) -> float:
    """rho = ln(1/p1) / ln(1/p2); the LSH quality exponent."""
    if not (0.0 < p2 < p1 < 1.0):
        raise ValueError(f"need 0 < p2 < p1 < 1, got p1={p1}, p2={p2}")
    return math.log(1.0 / p1) / math.log(1.0 / p2)


def xp_rho(R: float, c: float) -> float:
    """Eq. (5): rho = (1/c^2) * (4 - c^2 R^2)/(4 - R^2) for the cross-polytope family."""
    return (1.0 / (c * c)) * (4.0 - c * c * R * R) / (4.0 - R * R)


def lccs_cdf(x: np.ndarray | float, m: int, p: float) -> np.ndarray | float:
    """Lemma 5.2 asymptotic CDF of |LCCS| for hash strings of length m and
    per-position match probability p:  F(x) ~ exp(-p^(x - log_{1/p}(m(1-p))))."""
    x = np.asarray(x, dtype=np.float64)
    shift = math.log(m * (1.0 - p)) / math.log(1.0 / p)
    return np.exp(-np.power(p, x - shift))


def lccs_median(m: int, p: float) -> float:
    """Eq. (6): median of F_hat_{m,p}."""
    return math.log(math.log(2.0)) / math.log(p) + math.log(m * (1.0 - p)) / math.log(1.0 / p)


def lccs_quantile(q: float, m: int, p: float) -> float:
    """Eq. (7)-style quantile: x such that F_hat_{m,p}(x) = q."""
    if not (0.0 < q < 1.0):
        raise ValueError("q in (0,1)")
    return math.log(-math.log(q)) / math.log(p) + math.log(m * (1.0 - p)) / math.log(1.0 / p)


def theorem51_lambda(m: int, n: int, p1: float, p2: float) -> int:
    """Theorem 5.1 candidate budget lambda ensuring (R,c)-NNS success prob >= 1/4.

    lambda = m^{1-1/rho} * n * (1-p1)^{-1/rho} * (1-p2) * (ln 2)^{1/rho} / p2
    """
    r = rho(p1, p2)
    lam = (
        (m ** (1.0 - 1.0 / r))
        * n
        * ((1.0 - p1) ** (-1.0 / r))
        * (1.0 - p2)
        * (math.log(2.0) ** (1.0 / r))
        / p2
    )
    return max(1, int(math.ceil(lam)))


def suggest_m(n: int, alpha: float, p1: float, p2: float) -> int:
    """Corollary 5.1: m = O(n^{alpha * rho}); alpha in [0, 1/(1-rho)]."""
    r = rho(p1, p2)
    m = int(round(n ** (alpha * r)))
    # round up to a multiple of 8 (lane alignment) and keep >= 8
    return max(8, (m + 7) // 8 * 8)
