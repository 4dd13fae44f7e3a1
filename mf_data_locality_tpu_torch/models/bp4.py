"""CEED benchmark problem BP4: 3-component vector Poisson.

Assembles mesh, DoF layout, operator, node-blocked Jacobi preconditioner
and the synthetic right-hand side into one solvable problem, as the
reference harness does (``common_code/benchmark.h:50-176``):

* FE_Q(p)^3 on the sine-deformed box with 2**s cells, zero Dirichlet
  boundary values, Gauss(p+2) integration;
* preconditioner from the GLL(p+1) operator diagonal, one scalar per node;
* RHS value ``dof_index % 8`` on unconstrained DoFs, with the DoF index
  node-major and the components interleaved per node — the JAX package's
  numbering (``mf_data_locality_tpu/models/bp4.py:98-109``), so iteration
  counts match that package rather than published deal.II logs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import diagonal, laplace_cuda
from mf_data_locality_tpu_torch.ops.laplace_cuda import OperatorData


@dataclass(frozen=True)
class BP4Problem:
    layout: DofLayout
    op: OperatorData
    inv_diag: torch.Tensor  # (1, n_nodes)
    b: torch.Tensor         # (C, n_nodes)
    n_components: int

    @property
    def n_dofs(self) -> int:
        return self.layout.n_nodes * self.n_components

    @property
    def lattice_shape(self) -> tuple[int, int, int, int]:
        return (self.n_components,) + self.layout.n_nodes_axis


def rhs(layout: DofLayout, n_components: int = 3) -> np.ndarray:
    """(C, n_nodes) f64 right-hand side: dof % 8, zero on the boundary."""
    n = layout.n_nodes
    dof_index = (np.arange(n)[:, None] * n_components
                 + np.arange(n_components)[None, :])
    b = (dof_index % 8).astype(np.float64)
    b[layout.boundary_node_mask] = 0.0
    return b.T


def build(s: int, degree: int, dtype: torch.dtype = torch.float32,
          precision: str = "split2m", factor: str = "twostage",
          metric: str = "onthefly", cofactor: str = "adjj",
          device: torch.device | str = "cpu") -> BP4Problem:
    """BP4 on 2**s cells at ``degree``; every array on ``device``."""
    layout = DofLayout(BoxMesh.from_s(s), degree)
    op = laplace_cuda.make_operator(layout, dtype=dtype, precision=precision,
                                    factor=factor, metric=metric,
                                    cofactor=cofactor, device=device)
    inv_diag = diagonal.compute_inverse_diagonal(layout)
    return BP4Problem(
        layout, op,
        torch.as_tensor(inv_diag[None, :]).to(device=device, dtype=dtype),
        torch.as_tensor(rhs(layout)).to(device=device, dtype=dtype), 3)


def from_jax_arrays(s: int, degree: int, *, mats2d: np.ndarray,
                    pds: np.ndarray, w3: np.ndarray, coeffs: np.ndarray,
                    mask: np.ndarray, b: np.ndarray, inv_diag: np.ndarray,
                    precision: str = "split2m",
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cpu") -> BP4Problem:
    """The port's problem from the JAX package's arrays, passed as numpy.

    Takes a ``BP4Problem`` / ``PallasOperatorData`` built with
    ``windowing="pieces"``: ``mats2d`` (3 q^2, (p+1)^2) with its columns in
    the TPU's corner-piece order (``laplace_pallas._piece_perm2d``), which
    is undone here; ``pds`` (3 q^3, 8); ``w3`` (q^3, 1); ``coeffs``
    (3, 8, n_cells); ``mask`` (1, Nz, Ny, Nx); ``b`` (C, n_nodes);
    ``inv_diag`` (1, n_nodes).
    """
    layout = DofLayout(BoxMesh.from_s(s), degree)
    canonical = np.empty_like(np.asarray(mats2d))
    canonical[:, piece_perm2d(degree)] = mats2d
    op = laplace_cuda.operator_from_arrays(
        canonical, pds, w3, coeffs, mask, degree, layout.mesh.n_cells_axis,
        precision, dtype, device)
    return BP4Problem(
        layout, op,
        torch.tensor(np.asarray(inv_diag)).to(device=device, dtype=dtype),
        torch.tensor(np.asarray(b)).to(device=device, dtype=dtype),
        int(np.asarray(b).shape[0]))


def piece_perm2d(p: int) -> np.ndarray:
    """The TPU layout's column order of one (ky, kx) plane: piece column j
    holds canonical column ``piece_perm2d(p)[j]`` (mm rows, then kx = p,
    ky = p, and the corner)."""
    p1 = p + 1
    idx = [ky * p1 + kx for ky in range(p) for kx in range(p)]
    idx += [ky * p1 + p for ky in range(p)]
    idx += [p * p1 + kx for kx in range(p)]
    idx.append(p * p1 + p)
    return np.asarray(idx)
