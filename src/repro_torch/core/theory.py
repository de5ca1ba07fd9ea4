"""Closed-form theory quantities from the paper (used by tests/benches).

- Thm 1/2: d_min bounds for CLUGP vs Holl and the RF upper bound (Eq. 4/5).
- Thm 5:   λ range.
- Thm 6:   game round bound Σ|e(c_i, V\\c_i)|.
- Thm 7/8: PoA ≤ k+1, PoS ≤ 2.

A numpy copy of ``repro.core.theory`` on the port's host game.
"""
from __future__ import annotations

import numpy as np

from .game import ClusterGraph, global_cost


def d_min_clugp(r: np.ndarray | int, vmax: float, dmax: float) -> np.ndarray:
    """Eq. 8: min degree of a vertex replicated r≥2 times under CLUGP."""
    r = np.asarray(r, dtype=np.float64)
    return (vmax - 1.0) * (1.0 - (1.0 - 1.0 / (1.0 + dmax)) ** (r - 1.0)) + 2.0


def d_min_holl(r: np.ndarray | int) -> np.ndarray:
    """§IV-B: Holl replicates a degree-(r-1) vertex r times in the worst case."""
    return np.maximum(np.asarray(r, dtype=np.float64) - 1.0, 1.0)


def rf_upper_bound(m: int, gamma: float, alpha: float,
                   d_min_fn, **kw) -> float:
    """Eq. 4/5 with θ_r = (γ/(d_min(r)-1))^(α-1)."""
    rs = np.arange(max(2, int(gamma)), m)
    d = np.maximum(d_min_fn(rs, **kw) if kw else d_min_fn(rs), 1.0 + 1e-9)
    theta = np.minimum((gamma / (d - 1.0)) ** (alpha - 1.0), 1.0)
    return 1.0 + float(theta.sum())


def game_round_bound(cg: ClusterGraph) -> float:
    """Thm 6: rounds ≤ Σ_i |e(c_i, V\\c_i)| (symmetrized boundary /2)."""
    return float(cg.adj.sum()) / 2.0


def poa_bound(k: int) -> float:
    return k + 1.0


def pos_bound() -> float:
    return 2.0


def brute_force_optimum(cg: ClusterGraph, k: int, lam: float) -> float:
    """Exhaustive φ(Λ) minimum — only for tiny m (tests of Thm 7/8)."""
    m = cg.m
    assert m * np.log2(k) <= 22, "brute force limited to tiny instances"
    best = np.inf
    assign = np.zeros(m, dtype=np.int64)
    total = k ** m
    for code in range(total):
        x = code
        for i in range(m):
            assign[i] = x % k
            x //= k
        best = min(best, global_cost(cg, assign, k, lam))
    return best


def fit_power_law_alpha(degrees: np.ndarray, d_min: int = 2) -> float:
    """MLE α̂ = 1 + n / Σ ln(d/(d_min-0.5)) (Clauset et al.)."""
    d = degrees[degrees >= d_min].astype(np.float64)
    if d.size == 0:
        return 2.0
    return 1.0 + d.size / float(np.log(d / (d_min - 0.5)).sum())
