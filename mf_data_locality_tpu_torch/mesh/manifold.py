"""The sine-deformation chart manifold of the BP4 benchmark geometry.

Capability of ``MyManifold`` (reference: ``common_code/curved_manifold.h:12-87``):
the unit box is deformed by ``x_d += factor * prod_e sin(pi * x_e)`` so that
cell Jacobians are non-constant and the operator cannot shortcut to a
Cartesian metric.  ``pull_back`` is the Newton inverse of the chart
(``curved_manifold.h:37-83``), vectorized over many points at once.

Everything here is host-side float64 NumPy — manifold evaluation happens once
at setup to place mesh vertices; the device-side operator only ever sees the
resulting trilinear cell coefficients.
"""

from __future__ import annotations

import numpy as np

DEFAULT_FACTOR = 0.1


def push_forward(points: np.ndarray, factor: float = DEFAULT_FACTOR) -> np.ndarray:
    """Map reference points (..., dim) through the sine deformation."""
    points = np.asarray(points, dtype=np.float64)
    sinval = factor * np.prod(np.sin(np.pi * points), axis=-1, keepdims=True)
    return points + sinval



def pull_back(points: np.ndarray, factor: float = DEFAULT_FACTOR,
              tol: float = 1e-12, max_iter: int = 100) -> np.ndarray:
    """Invert :func:`push_forward` by a vectorized Newton iteration.

    The chart's Jacobian is ``I + ones * d(sinval)/dx^T`` (a rank-one
    update), the reference's dense Newton solve (``curved_manifold.h:
    55-80``) over all points at once.  Raises RuntimeError when the
    largest residual is above ``tol`` after ``max_iter`` steps.
    """
    p = np.asarray(points, dtype=np.float64)
    x = p.copy()
    dim = p.shape[-1]

    def residual(x):
        sines = np.sin(np.pi * x)
        return sines, p - x - factor * np.prod(sines, axis=-1, keepdims=True)

    for _ in range(max_iter):
        sines, res = residual(x)
        if np.max(np.linalg.norm(res, axis=-1)) <= tol:
            return x
        # d(sinval)/dx_d = factor pi cos(pi x_d) prod_{e != d} sin(pi x_e)
        prod_others = np.empty_like(x)
        for d in range(dim):
            others = [e for e in range(dim) if e != d]
            prod_others[..., d] = np.prod(sines[..., others], axis=-1)
        grad = factor * np.pi * np.cos(np.pi * x) * prod_others
        jac = np.broadcast_to(np.eye(dim), x.shape + (dim,)).copy()
        jac += grad[..., None, :]  # every row of J gets the same gradient
        x = x + np.linalg.solve(jac, res[..., None])[..., 0]
    if np.max(np.linalg.norm(residual(x)[1], axis=-1)) > tol:
        raise RuntimeError("Newton iteration for manifold pull_back did not "
                           "converge")
    return x
