"""Finite-difference coefficient generation on non-uniform grids
(counterpart of fluca_tpu.ops.fdcoeffs, the same host numpy functions).

The reference computes derivative stencil coefficients by solving small
Vandermonde systems per grid point (fluca/src/fd/impls/derivative/
derivative.c:84-107 and fluca/src/fd/utils/fdutils.c:80-103). Same
approach here, with numpy in float64 at setup time.
"""

from __future__ import annotations

import math

import numpy as np


def fd_weights(xs, x0: float, m: int) -> np.ndarray:
    """Weights w such that sum_j w[j] f(xs[j]) ~= f^(m)(x0).

    Solves the Taylor-moment (Vandermonde) system
        sum_j w[j] (xs[j]-x0)^k / k! = delta_{k,m},  k = 0..len(xs)-1.
    Exact for polynomials of degree < len(xs).
    """
    xs = np.asarray(xs, dtype=np.float64)
    n = xs.size
    if m >= n:
        raise ValueError(f"derivative order {m} needs more than {n} points")
    d = xs - x0
    V = np.empty((n, n))
    for k in range(n):
        V[k] = d**k / math.factorial(k)
    rhs = np.zeros(n)
    rhs[m] = 1.0
    return np.linalg.solve(V, rhs)


def interp_weights(xs, x0: float) -> np.ndarray:
    """Polynomial interpolation weights (m = 0 case)."""
    return fd_weights(xs, x0, 0)
