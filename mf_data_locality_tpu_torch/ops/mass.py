"""The matrix-free mass operator (CEED BP1/BP2).

Counterpart of ``mf_data_locality_tpu.ops.mass``.  The reference
implements the stiffness problems BP3/BP4; the CEED bake-off family
(https://ceed.exascaleproject.org/bps) pairs them with the mass-matrix
problems BP1 (one component) and BP2 (three).  The apply is one
interpolation to the Gauss points, a pointwise det(J) w scaling and the
transpose, on flat vectors ``(C, n_nodes)`` of the box's or any
conforming hex mesh's layout.  The JAX package computes it in plain XLA
contractions, with no Pallas kernel, so this module is plain PyTorch on
an explicit device: gather by the cell map, ``torch.tensordot`` per axis,
and each node's copies summed in slot order through the transposed
scatter map (:func:`.laplace.slot_sum`), the same bits on every run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.mesh.general import GeneralDofLayout
from mf_data_locality_tpu_torch.ops import geometry, lagrange
from mf_data_locality_tpu_torch.ops.laplace import (
    apply_axis, operator_of_arrays, slot_sum)


@dataclass(frozen=True)
class MassOperatorData:
    """The mass operator's tensors, all on one device."""

    values: torch.Tensor         # S: (q, p+1) basis values at the q-points
    detw: torch.Tensor           # (n_cells, q^3): det(J) w at the q-points
    gather: torch.Tensor         # (n_cells, (p+1)^3) int64 cell-to-node map
    unconstrained: torch.Tensor  # (n_nodes,) 1 where free, 0 where Dirichlet
    scatter_pos: torch.Tensor    # (n_nodes, KMAX) int64, as the Laplacian's
    scatter_valid: torch.Tensor  # (n_nodes, KMAX) 0/1

    @property
    def degree(self) -> int:
        return self.values.shape[1] - 1

    @property
    def n_q(self) -> int:
        return self.values.shape[0]


def make_mass_operator(layout: DofLayout | GeneralDofLayout,
                       n_q: int | None = None,
                       dtype: torch.dtype = torch.float32,
                       device: torch.device | str = "cuda"
                       ) -> MassOperatorData:
    """The mass operator of ``layout`` with q = ``n_q`` (default p + 2)
    Gauss points per direction; ``detw`` the signed det J times the tensor
    weight, in f64 on the host."""
    p = layout.degree
    shape = lagrange.make_shape(p, n_q if n_q is not None else p + 2)
    qz, qy, qx = np.meshgrid(shape.q_points, shape.q_points, shape.q_points,
                             indexing="ij")
    uvw = np.stack([qx, qy, qz], axis=-1).reshape(-1, 3)
    w = shape.q_weights
    w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(-1)
    coeffs = geometry.trilinear_coefficients(layout.mesh.cell_vertices)
    det = np.linalg.det(geometry.jacobian(coeffs[:, None], uvw[None]))
    return operator_of_arrays(MassOperatorData, dict(
        values=shape.values, detw=det * w3[None, :], gather=layout.gather_map,
        unconstrained=(~layout.boundary_node_mask).astype(np.float64)),
        dtype, device)


def from_jax_arrays(values, detw, gather, unconstrained,
                    device: torch.device | str = "cuda") -> MassOperatorData:
    """The operator from the arrays of a JAX ``MassOperatorData`` (host
    arrays), carried across value for value at their dtype; the transposed
    scatter map is built from ``gather``."""
    return operator_of_arrays(MassOperatorData, dict(
        values=values, detw=detw, gather=gather, unconstrained=unconstrained),
        None, device)


def apply_cells(op: MassOperatorData, u: torch.Tensor) -> torch.Tensor:
    """M u without constraint handling; ``u``: (C, n_nodes), C = 1 for
    BP1, 3 for BP2."""
    nc, nloc = op.gather.shape
    p1, q = op.degree + 1, op.n_q
    n_comp = u.shape[0]
    t = u[:, op.gather].reshape(n_comp, nc, p1, p1, p1)
    for axis in (2, 3, 4):
        t = apply_axis(op.values, t, axis)
    t = t * op.detw.reshape(1, nc, q, q, q)
    for axis in (2, 3, 4):
        t = apply_axis(op.values.T, t, axis)
    return slot_sum(t.reshape(n_comp, nc * nloc), op.scatter_pos,
                    op.scatter_valid)


def vmult(op: MassOperatorData, u: torch.Tensor,
          constrained_identity: bool = True) -> torch.Tensor:
    """M with the Dirichlet mask: constrained DoFs read as zero and
    receive nothing, and with ``constrained_identity`` copy the input.
    ``u``: (C, n_nodes)."""
    mask = op.unconstrained[None, :]
    v = apply_cells(op, u * mask) * mask
    if constrained_identity:
        v = v + u * (1.0 - mask)
    return v
