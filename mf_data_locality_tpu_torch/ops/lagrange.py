"""1D Lagrange bases and the tensor-product operator matrices.

This is the capability slot of deal.II's ``internal::MatrixFreeFunctions::
ShapeInfo`` (shape_values_eo / shape_gradients_collocation_eo), which the
reference consumes as an external dependency (reference:
``common_code/poisson_operator.h:442-447,477,549``).  The reference uses
even-odd factorized SIMD kernels for the 1D contractions; this package keeps
the plain (dense) matrices, from which the operator builds its 1D z factors
and dense 2D stage (``ops/laplace_cuda.py``).

Matrices produced (all float64 NumPy, applied per tensor axis):

* ``S[q, p+1]``      — basis values at quadrature points ("interpolate").
* ``D_col[q, q]``    — collocation derivative on the quadrature grid, so that
                       gradient-at-q = D_col @ (S @ u): identical factorization
                       to the reference's collocation-gradient path.
* ``D_nod[p+1, p+1]``— collocation derivative on the nodal (GLL) grid, used by
                       the preconditioner-diagonal closed form (the reference
                       evaluates the same thing via FEEvaluation with GLL
                       quadrature, ``poisson_operator.h:392-426``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace

import numpy as np

from mf_data_locality_tpu_torch.ops import quadrature


def barycentric_weights(nodes: np.ndarray) -> np.ndarray:
    """Barycentric weights w_j = 1 / prod_{k != j} (x_j - x_k)."""
    nodes = np.asarray(nodes, dtype=np.float64)
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / diff.prod(axis=1)


def lagrange_values(nodes: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Values of the Lagrange basis on ``nodes`` at ``points``: shape (n_points, n_nodes)."""
    nodes = np.asarray(nodes, dtype=np.float64)
    points = np.asarray(points, dtype=np.float64)
    w = barycentric_weights(nodes)
    out = np.empty((points.size, nodes.size), dtype=np.float64)
    for i, x in enumerate(points):
        d = x - nodes
        hit = np.isclose(d, 0.0, atol=1e-14)
        if hit.any():
            out[i] = hit.astype(np.float64)
        else:
            t = w / d
            out[i] = t / t.sum()
    return out


def lagrange_derivatives(nodes: np.ndarray, points: np.ndarray) -> np.ndarray:
    """First derivatives of the Lagrange basis at ``points``: shape (n_points, n_nodes).

    Uses the derivative of the barycentric form; exact (no differencing).
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    points = np.asarray(points, dtype=np.float64)
    w = barycentric_weights(nodes)
    n = nodes.size
    out = np.empty((points.size, n), dtype=np.float64)
    # Derivative matrix on the node set itself (standard formulas):
    #   D[i, j] = (w_j / w_i) / (x_i - x_j),  D[i, i] = -sum_{j != i} D[i, j]
    for k, x in enumerate(points):
        d = x - nodes
        hit = np.isclose(d, 0.0, atol=1e-14)
        if hit.any():
            i = int(np.argmax(hit))
            row = np.zeros(n)
            mask = np.arange(n) != i
            row[mask] = (w[mask] / w[i]) / (nodes[i] - nodes[mask])
            row[i] = -row[mask].sum()
            out[k] = row
        else:
            t = w / d
            s = t.sum()
            li = t / s  # basis values at x
            # l_j'(x) = l_j(x) * (sum_k t_k/(x-x_k) ... ) — use stable product form:
            # l_j'(x) = l_j(x) * (S1 - 1/(x-x_j)) where S1 = sum_k l_k(x)/(x-x_k)
            s1 = np.sum(li / d)
            out[k] = li * (s1 - 1.0 / d)
    return out


def collocation_derivative(points: np.ndarray) -> np.ndarray:
    """Derivative matrix of the Lagrange basis on ``points`` evaluated at ``points``."""
    return lagrange_derivatives(points, points)


@dataclass(frozen=True)
class Shape1D:
    """All 1D operator matrices for a (degree p, n_q quadrature points) pairing.

    Mirrors what the reference pulls from ShapeInfo for one
    ``FEEvaluation<dim, p, q>`` instantiation.
    """

    degree: int
    n_q: int
    nodes: np.ndarray = field(repr=False)  # (p+1,) GLL support points on [0,1]
    q_points: np.ndarray = field(repr=False)  # (q,) Gauss points on [0,1]
    q_weights: np.ndarray = field(repr=False)  # (q,)
    values: np.ndarray = field(repr=False)  # S: (q, p+1)
    grads: np.ndarray = field(repr=False)  # S': (q, p+1) basis derivative at q
    d_col: np.ndarray = field(repr=False)  # (q, q) collocation derivative at q
    d_nod: np.ndarray = field(repr=False)  # (p+1, p+1) collocation derivative at nodes


def make_shape(degree: int, n_q: int) -> Shape1D:
    """The shape data of FE_Q(degree) at Gauss(n_q): computed once a
    process, each call a copy of its arrays."""
    shape = _make_shape(degree, n_q)
    return replace(shape, **{k: v.copy() for k, v in vars(shape).items()
                             if isinstance(v, np.ndarray)})


@functools.lru_cache(maxsize=None)
def _make_shape(degree: int, n_q: int) -> Shape1D:
    nodes = quadrature.gll_nodes(degree)
    qp, qw = quadrature.gauss(n_q)
    return Shape1D(
        degree=degree,
        n_q=n_q,
        nodes=nodes,
        q_points=qp,
        q_weights=qw,
        values=lagrange_values(nodes, qp),
        grads=lagrange_derivatives(nodes, qp),
        d_col=collocation_derivative(qp),
        d_nod=collocation_derivative(nodes),
    )


def make_shape_gll(degree: int) -> Shape1D:
    """Shape data for the GLL(p+1)-quadrature (collocation) instantiation.

    Quadrature points coincide with basis nodes, so ``values`` is the identity
    — the same degenerate case the reference exploits for its preconditioner
    diagonal (``benchmark.h:124-154``).
    """
    nodes = quadrature.gll_nodes(degree)
    qp, qw = quadrature.gauss_lobatto(degree + 1)
    return Shape1D(
        degree=degree,
        n_q=degree + 1,
        nodes=nodes,
        q_points=qp,
        q_weights=qw,
        values=lagrange_values(nodes, qp),
        grads=lagrange_derivatives(nodes, qp),
        d_col=collocation_derivative(qp),
        d_nod=collocation_derivative(nodes),
    )
