"""The 2D vector Laplacian on quadrilateral meshes.

Counterpart of ``mf_data_locality_tpu.ops.laplace2d``: the reference
operator's dim == 2 path (``poisson_operator.h:136-149`` the bilinear
geometry, ``:472-533`` the 2D apply), sum-factorized with the bilinear
geometry rebuilt at every quadrature point, on flat vectors ``(C,
n_nodes)``.  The reference ships no 2D benchmark executable and the JAX
package computes it in plain XLA contractions, with no Pallas kernel, so
this module is plain PyTorch on an explicit device: gather by the cell
map, ``torch.tensordot`` per axis, and each node's copies summed in slot
order through the transposed scatter map (:func:`.laplace.slot_sum`).
:func:`assemble_dense2d` is the independent check in f64 NumPy.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from mf_data_locality_tpu_torch.mesh import manifold
from mf_data_locality_tpu_torch.ops import lagrange
from mf_data_locality_tpu_torch.ops.laplace import (
    apply_axis, operator_of_arrays, slot_sum)


@dataclass(frozen=True)
class BoxMesh2D:
    """A structured quad mesh on a rectangle, optionally sine-deformed."""

    n_cells_axis: tuple[int, int]  # (ncy, ncx)
    spacing: float
    deformed: bool = True
    factor: float = manifold.DEFAULT_FACTOR

    @property
    def n_cells(self) -> int:
        return self.n_cells_axis[0] * self.n_cells_axis[1]

    @cached_property
    def vertex_lattice(self) -> np.ndarray:
        """(ncy+1, ncx+1, 2) vertex coordinates as (x, y)."""
        ncy, ncx = self.n_cells_axis
        Y, X = np.meshgrid(np.arange(ncy + 1) * self.spacing,
                           np.arange(ncx + 1) * self.spacing, indexing="ij")
        pts = np.stack([X, Y], axis=-1)
        if self.deformed:
            pts = manifold.push_forward(pts, self.factor)  # sin x sin y
        return pts

    @cached_property
    def cell_vertices(self) -> np.ndarray:
        """(n_cells, 4, 2); local corner order bit0 -> x, bit1 -> y; cells
        y slowest."""
        lat = self.vertex_lattice
        ncy, ncx = self.n_cells_axis
        out = np.empty((ncy, ncx, 4, 2))
        for v in range(4):
            dx, dy = v & 1, (v >> 1) & 1
            out[..., v, :] = lat[dy:dy + ncy, dx:dx + ncx, :]
        return out.reshape(-1, 4, 2)


@dataclass(frozen=True)
class DofLayout2D:
    """Q_p nodes of a :class:`BoxMesh2D`, numbered over the node lattice
    (y slowest); zero Dirichlet values on the whole boundary."""

    mesh: BoxMesh2D
    degree: int

    @property
    def n_nodes_axis(self) -> tuple[int, int]:
        ncy, ncx = self.mesh.n_cells_axis
        return (self.degree * ncy + 1, self.degree * ncx + 1)

    @property
    def n_nodes(self) -> int:
        ny, nx = self.n_nodes_axis
        return ny * nx

    @cached_property
    def gather_map(self) -> np.ndarray:
        """(n_cells, (p+1)^2) int32 cell-to-node map, local x fastest."""
        p = self.degree
        ncy, ncx = self.mesh.n_cells_axis
        nx = self.n_nodes_axis[1]
        cy, cx = np.meshgrid(np.arange(ncy), np.arange(ncx), indexing="ij")
        base = (p * cy) * nx + p * cx
        j, i = np.meshgrid(np.arange(p + 1), np.arange(p + 1), indexing="ij")
        local = j * nx + i
        return (base.reshape(-1, 1) + local.reshape(1, -1)).astype(np.int32)

    @cached_property
    def boundary_node_mask(self) -> np.ndarray:
        ny, nx = self.n_nodes_axis
        m = np.zeros((ny, nx), dtype=bool)
        m[0] = m[-1] = True
        m[:, 0] = m[:, -1] = True
        return m.reshape(-1)


def bilinear_coefficients(cell_vertices: np.ndarray) -> np.ndarray:
    """x(u, v) = c0 + c1 u + c2 v + c3 uv: (..., 4, 2), the 2D analog of
    ``poisson_operator.h:136-149``."""
    v = np.asarray(cell_vertices, dtype=np.float64)
    c = np.empty_like(v)
    c[..., 0, :] = v[..., 0, :]
    c[..., 1, :] = v[..., 1, :] - v[..., 0, :]
    c[..., 2, :] = v[..., 2, :] - v[..., 0, :]
    c[..., 3, :] = v[..., 3, :] - v[..., 2, :] - v[..., 1, :] + v[..., 0, :]
    return c


@dataclass(frozen=True)
class Laplace2DData:
    """The 2D operator's tensors, all on one device."""

    values: torch.Tensor         # (q, p+1)
    d_col: torch.Tensor          # (q, q)
    q_uv: torch.Tensor           # (q^2, 2)
    q_w2: torch.Tensor           # (q^2,)
    coeffs: torch.Tensor         # (n_cells, 4, 2)
    gather: torch.Tensor         # (n_cells, (p+1)^2) int64
    unconstrained: torch.Tensor  # (n_nodes,)
    scatter_pos: torch.Tensor    # (n_nodes, KMAX) int64 (KMAX 4)
    scatter_valid: torch.Tensor  # (n_nodes, KMAX) 0/1

    @property
    def degree(self) -> int:
        return self.values.shape[1] - 1


def make_operator2d(layout: DofLayout2D, n_q: int | None = None,
                    dtype: torch.dtype = torch.float64,
                    device: torch.device | str = "cuda") -> Laplace2DData:
    """The 2D operator of ``layout`` with q = ``n_q`` (default p + 2)
    Gauss points per direction (f64 by default, as the JAX package's)."""
    p = layout.degree
    shape = lagrange.make_shape(p, n_q if n_q is not None else p + 2)
    qy, qx = np.meshgrid(shape.q_points, shape.q_points, indexing="ij")
    w = shape.q_weights
    return operator_of_arrays(Laplace2DData, dict(
        values=shape.values, d_col=shape.d_col,
        q_uv=np.stack([qx, qy], axis=-1).reshape(-1, 2),
        q_w2=(w[:, None] * w[None, :]).reshape(-1),
        coeffs=bilinear_coefficients(layout.mesh.cell_vertices),
        gather=layout.gather_map,
        unconstrained=(~layout.boundary_node_mask).astype(np.float64)),
        dtype, device)


def from_jax_arrays(values, d_col, q_uv, q_w2, coeffs, gather,
                    unconstrained, device: torch.device | str = "cuda"
                    ) -> Laplace2DData:
    """The operator from the arrays of a JAX ``Laplace2DData`` (host
    arrays), carried across value for value at their dtype; the transposed
    scatter map is built from ``gather``."""
    return operator_of_arrays(Laplace2DData, dict(
        values=values, d_col=d_col, q_uv=q_uv, q_w2=q_w2, coeffs=coeffs,
        gather=gather, unconstrained=unconstrained), None, device)


def _metric2d(op: Laplace2DData):
    """G = det(J) w J^{-1} J^{-T} at the q-points as w / det J times
    adj(J) adj(J)^T: its entries (g00, g01, g11), each (n_cells, q^2)."""
    u = op.q_uv[None, :, 0:1]
    v = op.q_uv[None, :, 1:2]
    c = op.coeffs
    # J[d][e] = dx_d / d(u, v)_e
    col0 = c[:, None, 1, :] + c[:, None, 3, :] * v  # dx/du
    col1 = c[:, None, 2, :] + c[:, None, 3, :] * u  # dx/dv
    j00, j10 = col0[..., 0], col0[..., 1]
    j01, j11 = col1[..., 0], col1[..., 1]
    scale = op.q_w2[None, :] / (j00 * j11 - j01 * j10)
    # adj(J) = [[j11, -j01], [-j10, j00]]
    g00 = scale * (j11 * j11 + j01 * j01)
    g01 = scale * (-j11 * j10 - j01 * j00)
    g11 = scale * (j10 * j10 + j00 * j00)
    return g00, g01, g11


def local_apply2d(op: Laplace2DData, u_loc: torch.Tensor) -> torch.Tensor:
    """Per-cell weak Laplacian: (C, n_cells, p+1, p+1) -> same shape, the
    2D analog of ``poisson_operator.h:472-533``."""
    q = op.d_col.shape[0]
    n_comp, nc = u_loc.shape[0], u_loc.shape[1]
    uq = apply_axis(op.values, u_loc, 2)
    uq = apply_axis(op.values, uq, 3)
    gx = apply_axis(op.d_col, uq, 3).reshape(n_comp, nc, q * q)
    gy = apply_axis(op.d_col, uq, 2).reshape(n_comp, nc, q * q)
    g00, g01, g11 = _metric2d(op)
    tx = (g00[None] * gx + g01[None] * gy).reshape(n_comp, nc, q, q)
    ty = (g01[None] * gx + g11[None] * gy).reshape(n_comp, nc, q, q)
    vq = apply_axis(op.d_col.T, tx, 3) + apply_axis(op.d_col.T, ty, 2)
    vq = apply_axis(op.values.T, vq, 2)
    return apply_axis(op.values.T, vq, 3)


def vmult2d(op: Laplace2DData, u: torch.Tensor,
            constrained_identity: bool = True) -> torch.Tensor:
    """The operator with the Dirichlet mask (and with
    ``constrained_identity`` the input copied on the constrained rows);
    ``u``: (C, n_nodes)."""
    mask = op.unconstrained[None, :]
    nc, nloc = op.gather.shape
    p1 = op.degree + 1
    n_comp = u.shape[0]
    u_loc = (u * mask)[:, op.gather].reshape(n_comp, nc, p1, p1)
    v = slot_sum(local_apply2d(op, u_loc).reshape(n_comp, nc * nloc),
                 op.scatter_pos, op.scatter_valid) * mask
    if constrained_identity:
        v = v + u * (1.0 - mask)
    return v


def assemble_dense2d(layout: DofLayout2D, n_q: int | None = None,
                     apply_constraints: bool = True) -> np.ndarray:
    """The dense scalar stiffness matrix by straightforward quadrature in
    f64 NumPy: an independent check on tiny meshes."""
    p = layout.degree
    q = n_q if n_q is not None else p + 2
    shape = lagrange.make_shape(p, q)
    V, D = shape.values, shape.grads
    gphi = np.zeros(((p + 1) ** 2, q ** 2, 2))
    for j in range(p + 1):
        for i in range(p + 1):
            gu = np.einsum("b,a->ba", V[:, j], D[:, i]).reshape(-1)
            gv = np.einsum("b,a->ba", D[:, j], V[:, i]).reshape(-1)
            gphi[j * (p + 1) + i] = np.stack([gu, gv], axis=-1)

    qy, qx = np.meshgrid(shape.q_points, shape.q_points, indexing="ij")
    uv = np.stack([qx, qy], axis=-1).reshape(-1, 2)
    w = shape.q_weights
    w2 = (w[:, None] * w[None, :]).reshape(-1)
    c = bilinear_coefficients(layout.mesh.cell_vertices)
    col0 = c[:, None, 1, :] + c[:, None, 3, :] * uv[None, :, 1:2]
    col1 = c[:, None, 2, :] + c[:, None, 3, :] * uv[None, :, 0:1]
    J = np.stack([col0, col1], axis=-1)  # (nc, q^2, 2, 2)
    Jinv = np.linalg.inv(J)
    G = (np.linalg.det(J) * w2[None])[..., None, None] * np.einsum(
        "...ab,...cb->...ac", Jinv, Jinv)
    K_loc = np.einsum("aqe,nqef,bqf->nab", gphi, G, gphi)

    n = layout.n_nodes
    K = np.zeros((n, n))
    for ci, idx in enumerate(layout.gather_map):
        K[np.ix_(idx, idx)] += K_loc[ci]
    if apply_constraints:
        m = layout.boundary_node_mask
        K[m, :] = 0.0
        K[:, m] = 0.0
        K[m, m] = 1.0
    return K
