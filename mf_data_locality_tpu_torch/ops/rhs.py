"""Right-hand-side assembly and the L2 error by quadrature (host-side NumPy).

Counterpart of ``mf_data_locality_tpu.ops.rhs``.  The reference defers a
right hand side for a manufactured solution to a TODO
(``benchmark.h:168-169``) and fills a synthetic vector; the convergence
check needs the consistent load vector

    rhs_i = sum_q w_q det(J_q) f(x_q) phi_i(q)

and the matching L2 error, both by the operator's sum factorization:
values interpolated and integrated with S along each axis, the trilinear
Jacobian determinant at each q-point.  f64 on the host, like the
preconditioner diagonal; a torch ``u_nodes`` is copied to the host.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import geometry, lagrange


def _quad_data(layout: DofLayout, n_q: int | None):
    p = layout.degree
    q = n_q if n_q is not None else p + 2
    shape = lagrange.make_shape(p, q)
    qz, qy, qx = np.meshgrid(shape.q_points, shape.q_points, shape.q_points,
                             indexing="ij")
    uvw = np.stack([qx, qy, qz], axis=-1).reshape(-1, 3)
    w = shape.q_weights
    w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(-1)
    coeffs = geometry.trilinear_coefficients(layout.mesh.cell_vertices)
    x_q = geometry.map_points(coeffs[:, None], uvw[None])  # (nc, q^3, 3)
    det = np.linalg.det(geometry.jacobian(coeffs[:, None], uvw[None]))
    return shape, q, w3, x_q, det


def assemble_rhs(layout: DofLayout,
                 f: Callable[[np.ndarray], np.ndarray],
                 n_q: int | None = None,
                 apply_constraints: bool = True) -> np.ndarray:
    """Consistent load vector for the source ``f``: (C, n_nodes) float64.

    ``f`` maps points (..., 3) to values (..., C) (or (...) for C = 1).
    """
    shape, q, w3, x_q, det = _quad_data(layout, n_q)
    fv = np.asarray(f(x_q))  # (nc, q^3, C)
    if fv.ndim == 2:
        fv = fv[..., None]
    n_comp = fv.shape[-1]
    integrand = fv * (w3[None, :, None] * det[..., None])

    # integrate: multiply by the basis values, S^T along each axis
    nc = layout.mesh.n_cells
    t = integrand.reshape(nc, q, q, q, n_comp)
    S = shape.values
    t = np.einsum("qi,nqabc->niabc", S, t)  # z
    t = np.einsum("qj,niqbc->nijbc", S, t)  # y
    t = np.einsum("qk,nijqc->nijkc", S, t)  # x
    local = t.reshape(nc, -1, n_comp)

    out = np.zeros((layout.n_nodes, n_comp))
    np.add.at(out, layout.gather_map.reshape(-1), local.reshape(-1, n_comp))
    if apply_constraints:
        out[layout.boundary_node_mask] = 0.0
    return out.T  # (C, n_nodes)


def l2_error(layout: DofLayout, u_nodes,
             u_exact: Callable[[np.ndarray], np.ndarray],
             n_q: int | None = None) -> float:
    """L2 norm of (u_h - u_exact) over the mesh by quadrature.

    ``u_nodes``: (C, n_nodes) nodal coefficients, a NumPy array or a
    tensor on any device (lattice-shaped (C, Nz, Ny, Nx) is flattened).
    """
    if isinstance(u_nodes, torch.Tensor):
        u_nodes = u_nodes.detach().to("cpu", torch.float64).numpy()
    u_nodes = np.asarray(u_nodes, np.float64).reshape(-1, layout.n_nodes)
    shape, q, w3, x_q, det = _quad_data(layout, n_q)
    nc = layout.mesh.n_cells
    p1 = layout.degree + 1
    u_loc = u_nodes.T[layout.gather_map]  # (nc, nloc, C)
    n_comp = u_loc.shape[-1]
    t = u_loc.reshape(nc, p1, p1, p1, n_comp)
    S = shape.values
    t = np.einsum("qi,nijkc->nqjkc", S, t)
    t = np.einsum("qj,najkc->naqkc", S, t)
    t = np.einsum("qk,nabkc->nabqc", S, t)
    uh_q = t.reshape(nc, -1, n_comp)
    ue_q = np.asarray(u_exact(x_q))
    if ue_q.ndim == 2:
        ue_q = ue_q[..., None]
    diff2 = ((uh_q - ue_q) ** 2).sum(axis=-1)
    return float(np.sqrt((diff2 * w3[None, :] * det).sum()))
