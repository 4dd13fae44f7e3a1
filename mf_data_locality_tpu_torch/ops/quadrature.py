"""1D quadrature rules on the unit interval [0, 1].

Capability slot of deal.II's ``QGauss<1>`` / ``QGaussLobatto<1>`` used by the
reference benchmark (reference: ``common_code/benchmark.h:107,129,157`` — the
operator integrates with Gauss(p+2), the preconditioner diagonal with
Gauss-Lobatto(p+1)).

All rules are computed host-side in float64 NumPy; the device only sees the
matrices and weights built from them.
"""

from __future__ import annotations

import numpy as np


def gauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre rule with ``n`` points on [0, 1].

    Exact for polynomials of degree <= 2n - 1.  Returns ``(points, weights)``
    as float64 arrays; weights sum to 1.
    """
    if n < 1:
        raise ValueError(f"need at least one quadrature point, got {n}")
    x, w = np.polynomial.legendre.leggauss(n)
    # map [-1, 1] -> [0, 1]
    return (0.5 * (x + 1.0)).astype(np.float64), (0.5 * w).astype(np.float64)


def gauss_lobatto(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Lobatto-Legendre rule with ``n`` points on [0, 1] (endpoints included).

    Exact for polynomials of degree <= 2n - 3.  The interior points are the
    roots of P'_{n-1}; weights are w_i = 2 / (n (n-1) P_{n-1}(x_i)^2) on
    [-1, 1], halved for [0, 1].
    """
    if n < 2:
        raise ValueError(f"Gauss-Lobatto needs at least 2 points, got {n}")
    if n == 2:
        x = np.array([-1.0, 1.0])
    else:
        leg = np.polynomial.legendre.Legendre.basis(n - 1)
        interior = leg.deriv().roots()
        x = np.concatenate([[-1.0], np.sort(np.real(interior)), [1.0]])
    pn = np.polynomial.legendre.Legendre.basis(n - 1)(x)
    w = 2.0 / (n * (n - 1) * pn**2)
    return (0.5 * (x + 1.0)).astype(np.float64), (0.5 * w).astype(np.float64)


def gll_nodes(degree: int) -> np.ndarray:
    """Support points of the degree-``degree`` nodal basis: GLL(degree+1) on [0,1].

    These are the support points of deal.II's ``FE_Q`` elements, so a basis
    built on them reproduces the reference discretization exactly.
    """
    return gauss_lobatto(degree + 1)[0]
