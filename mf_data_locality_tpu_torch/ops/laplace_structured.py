"""The BP4 operator on the node lattice with no gather or scatter
(``--backend structured``).

Counterpart of ``mf_data_locality_tpu.ops.laplace_structured``: on the
structured box the vector is the lattice ``(C, Nz, Ny, Nx)``, so a cell's
nodes are a window of each axis (:func:`cellify`: one strided view a
direction; cells share one node plane) and the transpose sum is an add of
two shifted slices (:func:`overlap_add`).  Extraction and contraction
alternate axis by axis, so a step grows the data by q/p at most, never by
the (p+1)^3 duplication of a cell-wise gather.  The metric is rebuilt at
every (cell, q-point) from 24 coefficients a cell, on nine broadcast
component arrays (:func:`_metric_apply`).  The JAX package computes this
operator in plain XLA contractions, with no Pallas kernel, so this
module is plain PyTorch (``torch.tensordot``, full f32 or f64) on an
explicit device.  :func:`cellify_t` and :func:`overlap_add_t`, the
window-first variants, are ``ops/laplace_apply``'s.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import geometry, lagrange
from mf_data_locality_tpu_torch.ops.laplace import apply_axis
from mf_data_locality_tpu_torch.ops.laplace_apply import (  # noqa: F401
    cellify_t, overlap_add_t)


@dataclass(frozen=True)
class StructuredOperatorData:
    """The lattice operator's tensors, all on one device."""

    values: torch.Tensor  # S: (q, p+1)
    d_col: torch.Tensor   # (q, q)
    q_pts: torch.Tensor   # (q,) 1D quadrature points
    w3: torch.Tensor      # (1, qz, 1, qy, 1, qx) tensor weights
    coeffs: torch.Tensor  # (ncz, 1, ncy, 1, ncx, 1, 8, 3) trilinear coeffs
    mask: torch.Tensor    # (1, Nz, Ny, Nx) 1 where unconstrained

    @property
    def n_q(self) -> int:
        return self.d_col.shape[0]

    @property
    def degree(self) -> int:
        return self.values.shape[1] - 1

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device


def make_structured_operator(layout: DofLayout, n_q: int | None = None,
                             dtype: torch.dtype = torch.float32,
                             device: torch.device | str = "cuda"
                             ) -> StructuredOperatorData:
    """The operator of ``layout`` with q = ``n_q`` (default p + 2) Gauss
    points per direction."""
    p = layout.degree
    q = n_q if n_q is not None else p + 2
    shape = lagrange.make_shape(p, q)
    w = shape.q_weights
    w3 = w[:, None, None] * w[None, :, None] * w[None, None, :]
    ncz, ncy, ncx = layout.mesh.n_cells_axis
    coeffs = geometry.trilinear_coefficients(layout.mesh.cell_vertices)
    nz, ny, nx = layout.n_nodes_axis
    mask = (~layout.boundary_node_mask).reshape(1, nz, ny, nx)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dtype)

    return StructuredOperatorData(
        values=t(shape.values), d_col=t(shape.d_col), q_pts=t(shape.q_points),
        w3=t(w3.reshape(1, q, 1, q, 1, q)),
        coeffs=t(coeffs.reshape(ncz, 1, ncy, 1, ncx, 1, 8, 3)), mask=t(mask))


def sub_operator(op: StructuredOperatorData, c0: int,
                 c1: int) -> StructuredOperatorData:
    """The operator on the cell layers [c0, c1) of ``op``'s lattice, its
    planes [c0 p, c1 p] (the JAX package's ``_sub_op`` on this backend:
    the coefficients of those layers; here also the mask's planes)."""
    p = op.degree
    return replace(op, coeffs=op.coeffs[c0:c1],
                   mask=op.mask[:, c0 * p:c1 * p + 1])


def cellify(u: torch.Tensor, axis: int, p: int) -> torch.Tensor:
    """Split a node axis of size nc p + 1 into (nc, p+1) overlapping
    windows in its place: window i of cell c is node c p + i."""
    return u.unfold(axis, p + 1, p).movedim(-1, axis + 1)


def overlap_add(v: torch.Tensor, axis: int, p: int) -> torch.Tensor:
    """Adjoint of :func:`cellify`: the (nc, p+1) windows at (axis, axis+1)
    summed onto the nc p + 1 nodes (a shared node's two terms, so the sum
    is the JAX package's to the bit)."""
    return overlap_add_t(v.transpose(axis, axis + 1), axis, p)


def _metric_apply(op: StructuredOperatorData, gx, gy, gz):
    """t = G g with G = det(J) w J^{-1} J^{-T} = (w / det) adj(J)
    adj(J)^T at every (cell, q-point), on nine broadcast component arrays
    (the reference's per-q-point Jacobian and ``do_invert``,
    ``poisson_operator.h:596-631``)."""
    q = op.n_q
    uq = op.q_pts.reshape(1, 1, 1, 1, 1, q)
    vq = op.q_pts.reshape(1, 1, 1, q, 1, 1)
    wq = op.q_pts.reshape(1, q, 1, 1, 1, 1)

    c = [[op.coeffs[..., i, d] for d in range(3)] for i in range(8)]
    j = [[None] * 3 for _ in range(3)]
    for d in range(3):
        j[d][0] = c[1][d] + c[3][d] * vq + c[5][d] * wq + c[7][d] * (vq * wq)
        j[d][1] = c[2][d] + c[3][d] * uq + c[6][d] * wq + c[7][d] * (uq * wq)
        j[d][2] = c[4][d] + c[5][d] * uq + c[6][d] * vq + c[7][d] * (uq * vq)

    # the adjugate (transposed cofactors): J^{-1} = adj / det
    adj = [[None] * 3 for _ in range(3)]
    adj[0][0] = j[1][1] * j[2][2] - j[1][2] * j[2][1]
    adj[0][1] = j[0][2] * j[2][1] - j[0][1] * j[2][2]
    adj[0][2] = j[0][1] * j[1][2] - j[0][2] * j[1][1]
    adj[1][0] = j[1][2] * j[2][0] - j[1][0] * j[2][2]
    adj[1][1] = j[0][0] * j[2][2] - j[0][2] * j[2][0]
    adj[1][2] = j[0][2] * j[1][0] - j[0][0] * j[1][2]
    adj[2][0] = j[1][0] * j[2][1] - j[1][1] * j[2][0]
    adj[2][1] = j[0][1] * j[2][0] - j[0][0] * j[2][1]
    adj[2][2] = j[0][0] * j[1][1] - j[0][1] * j[1][0]
    det = j[0][0] * adj[0][0] + j[0][1] * adj[1][0] + j[0][2] * adj[2][0]
    scale = op.w3 / det

    def gmat(e, f):
        return scale * (adj[e][0] * adj[f][0] + adj[e][1] * adj[f][1]
                        + adj[e][2] * adj[f][2])

    g00, g01, g02 = gmat(0, 0), gmat(0, 1), gmat(0, 2)
    g11, g12, g22 = gmat(1, 1), gmat(1, 2), gmat(2, 2)
    tx = g00 * gx + g01 * gy + g02 * gz
    ty = g01 * gx + g11 * gy + g12 * gz
    tz = g02 * gx + g12 * gy + g22 * gz
    return tx, ty, tz


def apply_lattice(op: StructuredOperatorData, u: torch.Tensor) -> torch.Tensor:
    """The weak vector Laplacian on the lattice, no constraints: (C, Nz,
    Ny, Nx) -> same shape (``poisson_operator.h:534-666``): cellify and
    interpolate per axis to the quadrature lattice (C, ncz, qz, ncy, qy,
    ncx, qx), collocation gradients, the metric, and back."""
    p = op.degree
    t = cellify(u, 3, p)  # (C, Nz, Ny, ncx, p+1)
    t = apply_axis(op.values, t, 4)  # (C, Nz, Ny, ncx, qx)
    t = cellify(t, 2, p)  # (C, Nz, ncy, p+1, ncx, qx)
    t = apply_axis(op.values, t, 3)  # (C, Nz, ncy, qy, ncx, qx)
    t = cellify(t, 1, p)  # (C, ncz, p+1, ncy, qy, ncx, qx)
    t = apply_axis(op.values, t, 2)  # (C, ncz, qz, ncy, qy, ncx, qx)

    gx = apply_axis(op.d_col, t, 6)
    gy = apply_axis(op.d_col, t, 4)
    gz = apply_axis(op.d_col, t, 2)
    tx, ty, tz = _metric_apply(op, gx, gy, gz)

    t = (apply_axis(op.d_col.T, tx, 6) + apply_axis(op.d_col.T, ty, 4)
         + apply_axis(op.d_col.T, tz, 2))
    t = apply_axis(op.values.T, t, 2)  # (C, ncz, p+1, ncy, qy, ncx, qx)
    t = overlap_add(t, 1, p)  # (C, Nz, ncy, qy, ncx, qx)
    t = apply_axis(op.values.T, t, 3)
    t = overlap_add(t, 2, p)  # (C, Nz, Ny, ncx, qx)
    t = apply_axis(op.values.T, t, 4)
    return overlap_add(t, 3, p)  # (C, Nz, Ny, Nx)


def vmult(op: StructuredOperatorData, u: torch.Tensor,
          constrained_identity: bool = True) -> torch.Tensor:
    """The full operator on the lattice, as ``laplace.vmult``."""
    v = apply_lattice(op, u * op.mask) * op.mask
    if constrained_identity:
        v = v + u * (1.0 - op.mask)
    return v


def to_lattice(u_flat: torch.Tensor, layout: DofLayout) -> torch.Tensor:
    """(C, n_nodes) -> (C, Nz, Ny, Nx): the flat order is the lattice's."""
    return u_flat.reshape((u_flat.shape[0],) + layout.n_nodes_axis)


def to_flat(u_lat: torch.Tensor) -> torch.Tensor:
    """(C, Nz, Ny, Nx) -> (C, n_nodes)."""
    return u_lat.reshape(u_lat.shape[0], -1)
