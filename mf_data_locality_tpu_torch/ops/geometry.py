"""Trilinear cell geometry.

The benchmark mesh is mapped trilinearly (``MappingQGeneric(1)``), so each
cell is described by 8 coefficient vectors (24 numbers) from which the
Jacobian at any reference point is rebuilt (``poisson_operator.h:151-179``).
The operator kernels rebuild it per quadrature point on the device; this
module provides the host-side coefficients and the f64 map, Jacobian and
inverse that the preconditioner diagonal, the right-hand side and the
assembled matrix need.  :func:`map_points`, :func:`jacobian` and
:func:`invert_3x3` take NumPy arrays or torch tensors (the plain
backends' metric, ``ops/laplace``).
"""

from __future__ import annotations

import numpy as np
import torch


def _stack(arrays, axis: int):
    if isinstance(arrays[0], torch.Tensor):
        return torch.stack(arrays, dim=axis)
    return np.stack(arrays, axis=axis)


def trilinear_coefficients(cell_vertices: np.ndarray) -> np.ndarray:
    """Trilinear map coefficients from hex corner coordinates.

    ``cell_vertices``: (..., 8, 3) with deal.II local corner order
    (bit0 -> x, bit1 -> y, bit2 -> z).  Returns ``c`` of shape (..., 8, 3) with

        x(u, v, w) = c0 + c1 u + c2 v + c3 uv + c4 w + c5 uw + c6 vw + c7 uvw

    for local coordinates (u, v, w) in [0, 1]^3.
    """
    v = np.asarray(cell_vertices, dtype=np.float64)
    c = np.empty_like(v)
    c[..., 0, :] = v[..., 0, :]
    c[..., 1, :] = v[..., 1, :] - v[..., 0, :]
    c[..., 2, :] = v[..., 2, :] - v[..., 0, :]
    c[..., 3, :] = v[..., 3, :] - v[..., 2, :] - v[..., 1, :] + v[..., 0, :]
    c[..., 4, :] = v[..., 4, :] - v[..., 0, :]
    c[..., 5, :] = v[..., 5, :] - v[..., 4, :] - v[..., 1, :] + v[..., 0, :]
    c[..., 6, :] = v[..., 6, :] - v[..., 4, :] - v[..., 2, :] + v[..., 0, :]
    c[..., 7, :] = (v[..., 7, :] - v[..., 6, :] - v[..., 5, :] + v[..., 4, :]
                    - v[..., 3, :] + v[..., 2, :] + v[..., 1, :] - v[..., 0, :])
    return c


def map_points(coeffs, uvw):
    """Evaluate the trilinear map: ``coeffs`` (..., 8, 3), ``uvw`` (..., 3)
    -> (..., 3)."""
    u, v, w = uvw[..., 0:1], uvw[..., 1:2], uvw[..., 2:3]
    c = coeffs
    return (c[..., 0, :] + c[..., 1, :] * u + c[..., 2, :] * v
            + c[..., 3, :] * u * v + c[..., 4, :] * w + c[..., 5, :] * u * w
            + c[..., 6, :] * v * w + c[..., 7, :] * u * v * w)


def jacobian(coeffs: np.ndarray, uvw: np.ndarray) -> np.ndarray:
    """Jacobian J[d, e] = dx_d / d(uvw)_e of the trilinear map.

    ``coeffs``: (..., 8, 3); ``uvw``: (..., 3).  Returns (..., 3, 3); a
    (cells, 1, 8, 3) coefficient array against a (1, n_q, 3) point array
    yields (cells, n_q, 3, 3).
    """
    u, v, w = uvw[..., 0:1], uvw[..., 1:2], uvw[..., 2:3]
    c = coeffs
    col0 = c[..., 1, :] + c[..., 3, :] * v + c[..., 5, :] * w + c[..., 7, :] * v * w
    col1 = c[..., 2, :] + c[..., 3, :] * u + c[..., 6, :] * w + c[..., 7, :] * u * w
    col2 = c[..., 4, :] + c[..., 5, :] * u + c[..., 6, :] * v + c[..., 7, :] * u * v
    return _stack([col0, col1, col2], axis=-1)


def invert_3x3(j: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Closed-form inverse of (..., 3, 3) matrices; returns (inverse, det).

    Cofactor expansion, the batched form of ``Poisson::do_invert``
    (``poisson_operator.h:41-63``).
    """
    a, b, c = j[..., 0, 0], j[..., 0, 1], j[..., 0, 2]
    d, e, f = j[..., 1, 0], j[..., 1, 1], j[..., 1, 2]
    g, h, i = j[..., 2, 0], j[..., 2, 1], j[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv = _stack([_stack([A, B, C], axis=-1), _stack([D, E, F], axis=-1),
                  _stack([G, H, I], axis=-1)], axis=-2)
    return inv * (1.0 / det)[..., None, None], det
