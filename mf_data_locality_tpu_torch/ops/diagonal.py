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
from mf_data_locality_tpu_torch.mesh.general import GeneralDofLayout
from mf_data_locality_tpu_torch.ops import geometry, lagrange


def gll_metric(coeffs: np.ndarray, p: int) -> np.ndarray:
    """G = det(J) w J^{-1} J^{-T} at the GLL(p+1) tensor points of the cells
    whose trilinear coefficients are ``coeffs`` (n_cells, 8, 3): (nc, q3,
    3, 3)."""
    shape = lagrange.make_shape_gll(p)
    qz, qy, qx = np.meshgrid(shape.q_points, shape.q_points, shape.q_points,
                             indexing="ij")
    uvw = np.stack([qx, qy, qz], axis=-1).reshape(-1, 3)
    w = shape.q_weights
    w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(-1)
    jac = geometry.jacobian(coeffs[:, None], uvw[None])
    jinv, det = geometry.invert_3x3(jac)
    scale = (det * w3[None])[..., None, None]
    return scale * np.einsum("...ab,...cb->...ac", jinv, jinv)


def summed_diagonal(layout: DofLayout | GeneralDofLayout,
                    coeffs: np.ndarray) -> np.ndarray:
    """The operator diagonal at every node of ``layout``, its
    cells' (trilinear coefficients ``coeffs``, (n_cells, 8, 3))
    contributions summed in cell order: (n_nodes,).  A z-slab's cell
    layers give the global diagonal's values on its planes
    (``parallel/distributed.py``)."""
    p = layout.degree
    q = p + 1
    shape = lagrange.make_shape_gll(p)
    D = np.asarray(shape.d_nod, np.float64)
    G = gll_metric(coeffs, p).reshape(-1, q, q, q, 3, 3)

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
    local = term_x + term_y + term_z + cross
    diag = np.zeros((layout.n_nodes,), np.float64)
    np.add.at(diag, layout.gather_map.reshape(-1), local.reshape(-1))
    return diag


def compute_inverse_diagonal(layout: DofLayout | GeneralDofLayout,
                             dtype=np.float64) -> np.ndarray:
    """Inverse scalar diagonal, one entry per node: (n_nodes,), on the
    box or on any conforming hex mesh (:mod:`..mesh.general`).

    Constrained (boundary) nodes get 1.0, the reference's zero->1 fixup
    (``poisson_operator.h:420-424``).  Computed in f64; ``dtype`` only casts
    the result.
    """
    diag = summed_diagonal(layout, geometry.trilinear_coefficients(
        layout.mesh.cell_vertices))
    diag = np.where(~layout.boundary_node_mask, diag, 1.0)
    return np.asarray(1.0 / diag, dtype=dtype)
