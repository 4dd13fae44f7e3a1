"""The sine-deformation chart manifold of the BP4 benchmark geometry.

Capability of ``MyManifold`` (reference: ``common_code/curved_manifold.h:12-87``):
the unit box is deformed by ``x_d += factor * prod_e sin(pi * x_e)`` so that
cell Jacobians are non-constant and the operator cannot shortcut to a
Cartesian metric.

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

