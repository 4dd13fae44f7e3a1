"""Operator diagonal for the node-blocked Jacobi preconditioner.

The preconditioner diagonal comes from the operator instantiated with
Gauss-Lobatto(p+1) quadrature, whose points coincide with the FE_Q nodes
(``poisson_operator.h:392-426``, ``benchmark.h:124-154``).  Collocation
gives a closed form per cell,

    diag[k,j,i] = sum_qx D[qx,i]^2 G00[k,j,qx]
                + sum_qy D[qy,j]^2 G11[k,qy,i]
                + sum_qz D[qz,k]^2 G22[qz,j,i]
                + 2 ( D[i,i] D[j,j] G01[k,j,i]
                    + D[i,i] D[k,k] G02[k,j,i]
                    + D[j,j] D[k,k] G12[k,j,i] )

with D the 1D GLL collocation derivative and G = det(J) w J^{-1} J^{-T} at
the GLL tensor points.  Every vector component shares the scalar diagonal,
so one value per node is stored (``diagonal_matrix_blocked.h:8-36``).
Host-side NumPy in f64.
"""

from __future__ import annotations

import numpy as np

from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import geometry, lagrange


def gll_metric(layout: DofLayout) -> np.ndarray:
    """G = det(J) w J^{-1} J^{-T} at the GLL(p+1) tensor points: (nc, q3, 3, 3)."""
    shape = lagrange.make_shape_gll(layout.degree)
    qz, qy, qx = np.meshgrid(shape.q_points, shape.q_points, shape.q_points,
                             indexing="ij")
    uvw = np.stack([qx, qy, qz], axis=-1).reshape(-1, 3)
    w = shape.q_weights
    w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(-1)
    coeffs = geometry.trilinear_coefficients(layout.mesh.cell_vertices)
    jac = geometry.jacobian(coeffs[:, None], uvw[None])
    jinv, det = geometry.invert_3x3(jac)
    scale = (det * w3[None])[..., None, None]
    return scale * np.einsum("...ab,...cb->...ac", jinv, jinv)


def compute_inverse_diagonal(layout: DofLayout, dtype=np.float64) -> np.ndarray:
    """Inverse scalar diagonal, one entry per node: (n_nodes,).

    Constrained (boundary) nodes get 1.0, the reference's zero->1 fixup
    (``poisson_operator.h:420-424``).  Computed in f64; ``dtype`` only casts
    the result.
    """
    p = layout.degree
    q = p + 1
    shape = lagrange.make_shape_gll(p)
    D = np.asarray(shape.d_nod, np.float64)
    G = gll_metric(layout).reshape(-1, q, q, q, 3, 3)

    D2 = D * D
    dd = np.diagonal(D)
    term_x = np.einsum("qi,nkjq->nkji", D2, G[..., 0, 0])
    term_y = np.einsum("qj,nkqi->nkji", D2, G[..., 1, 1])
    term_z = np.einsum("qk,nqji->nkji", D2, G[..., 2, 2])
    cross = 2.0 * (
        dd[None, None, None, :] * dd[None, None, :, None] * G[..., 0, 1]
        + dd[None, None, None, :] * dd[None, :, None, None] * G[..., 0, 2]
        + dd[None, None, :, None] * dd[None, :, None, None] * G[..., 1, 2]
    )
    local = (term_x + term_y + term_z + cross).reshape(layout.mesh.n_cells, -1)

    diag = np.zeros((layout.n_nodes,), np.float64)
    np.add.at(diag, layout.gather_map.reshape(-1), local.reshape(-1))
    diag = np.where(~layout.boundary_node_mask, diag, 1.0)
    return np.asarray(1.0 / diag, dtype=dtype)
