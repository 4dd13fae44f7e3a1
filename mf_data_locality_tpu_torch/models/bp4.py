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

Solver vectors are flat ``(C, n_nodes)``; :attr:`BP4Problem.a_apply` and
:attr:`BP4Problem.a_apply_full` reshape them to the lattice only inside the
operator (the apply family, :mod:`~mf_data_locality_tpu_torch.ops.
laplace_apply`).  The fused solver works on lattice vectors directly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import diagonal, laplace_apply, laplace_cuda
from mf_data_locality_tpu_torch.ops.laplace_cuda import OperatorData
from mf_data_locality_tpu_torch.solvers import cg, cg_merged
from mf_data_locality_tpu_torch.solvers.cg import SolveResult


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

    def _wrap(self, constrained_identity: bool):
        lat = self.lattice_shape

        def apply_flat(u: torch.Tensor) -> torch.Tensor:
            v = laplace_apply.vmult(self.op, u.reshape(lat),
                                    constrained_identity=constrained_identity)
            return v.reshape(u.shape)

        return apply_flat

    @property
    def a_apply(self):
        """The operator without constrained identity (merged-CG form)."""
        return self._wrap(False)

    @property
    def a_apply_full(self):
        """The operator with constrained identity (reference vmult)."""
        return self._wrap(True)


def rhs(layout: DofLayout, n_components: int = 3) -> np.ndarray:
    """(C, n_nodes) f64 right-hand side: dof % 8, zero on the boundary
    (a transposed view; the problem holds a C-ordered copy)."""
    n = layout.n_nodes
    dof_index = (np.arange(n)[:, None] * n_components
                 + np.arange(n_components)[None, :])
    b = (dof_index % 8).astype(np.float64)
    b[layout.boundary_node_mask] = 0.0
    return b.T


def build(s: int, degree: int, dtype: torch.dtype = torch.float32,
          precision: str = "highest", factor: str = "dense",
          metric: str = "precomputed", cofactor: str = "adjj",
          device: torch.device | str = "cuda",
          windowing: str = "reshape") -> BP4Problem:
    """BP4 on 2**s cells at ``degree``; every array on ``device``.

    The defaults are the JAX ``bp4.build``'s: the apply family's exact
    operator (dense factorization, streamed metric, reshape windowing);
    ``metric="onthefly"`` (reshape) or the ``pieces`` and ``zslab``
    windowings select its other kernels.  ``windowing="pieces"`` with a
    (factor, metric) pair of ``laplace_cuda.fused_configs`` builds the
    fused solver's operator: dense or twostage, the metric streamed or
    rebuilt (the JAX fused tests' default is the dense, streamed one).
    """
    layout = DofLayout(BoxMesh.from_s(s), degree)
    op = laplace_cuda.make_operator(layout, dtype=dtype, precision=precision,
                                    factor=factor, metric=metric,
                                    cofactor=cofactor, device=device,
                                    windowing=windowing)
    inv_diag = diagonal.compute_inverse_diagonal(layout)
    return BP4Problem(
        layout, op,
        torch.as_tensor(inv_diag[None, :]).to(device=device, dtype=dtype),
        torch.as_tensor(rhs(layout)).to(device=device, dtype=dtype)
        .contiguous(), 3)


def from_jax_arrays(s: int, degree: int, *, pds: np.ndarray,
                    w3: np.ndarray, coeffs: np.ndarray, mask: np.ndarray,
                    b: np.ndarray, inv_diag: np.ndarray,
                    mats2d: np.ndarray | None = None,
                    mats: np.ndarray | None = None,
                    gmetric: np.ndarray | None = None,
                    factor: str = "twostage", windowing: str = "pieces",
                    precision: str = "split2m",
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cuda") -> BP4Problem:
    """The port's problem from the JAX package's arrays, passed as numpy.

    Takes the arrays of a ``BP4Problem`` / ``PallasOperatorData`` built with
    ``windowing`` (``reshape``, ``pieces`` or ``zslab``): ``pds`` (3 q^3, 8);
    ``w3`` (q^3, 1); ``coeffs`` (3, 8, nc_pad); ``mask`` (1, Nz, Ny, Nx);
    ``b`` (C, n_nodes); ``inv_diag`` (1, n_nodes); optionally ``mats2d``
    (3 q^2, (p+1)^2), ``mats`` (3 q^3, (p+1)^3) and ``gmetric``
    (6 q^3, nc_pad).  The padded cell columns are dropped; under
    ``pieces`` the TPU's corner-piece column order of ``mats``
    (``laplace_pallas._piece_perm``) and ``mats2d`` (``_piece_perm2d``) is
    undone.  Matrices not given are built from ``degree``.  ``factor``
    is the JAX operator's: a fused operator built dense carries its
    ``mats`` (and ``gmetric`` if streamed) across.
    """
    layout = DofLayout(BoxMesh.from_s(s), degree)
    nc = layout.mesh.n_cells
    q = degree + 2

    def canonical(a, perm):
        if a is None or windowing != "pieces":
            return a
        out = np.empty_like(np.asarray(a))
        out[:, perm] = a
        return out

    op = laplace_cuda.operator_from_arrays(
        pds, w3, np.asarray(coeffs)[:, :, :nc], mask, degree,
        layout.mesh.n_cells_axis, precision, dtype, device,
        mats2d=canonical(mats2d, piece_perm2d(degree)),
        mats=canonical(mats, piece_perm(degree)),
        gmetric=(None if gmetric is None else
                 np.asarray(gmetric).reshape(6 * q ** 3, -1)[:, :nc]),
        factor=factor, windowing=windowing)
    return BP4Problem(
        layout, op,
        torch.tensor(np.asarray(inv_diag)).to(device=device, dtype=dtype),
        torch.tensor(np.ascontiguousarray(b)).to(device=device, dtype=dtype),
        int(np.asarray(b).shape[0]))


def solve_baseline(problem: BP4Problem, max_iter: int = 100,
                   rel_tol: float = 1e-8) -> SolveResult:
    """Textbook PCG with the full vmult (constrained identity), as the
    reference's ``benchmark_precond``."""
    return cg.cg_solve(problem.a_apply_full, problem.b, problem.inv_diag,
                       max_iter=max_iter, rel_tol=rel_tol)


def solve_merged(problem: BP4Problem, max_iter: int = 100,
                 rel_tol: float = 1e-8) -> SolveResult:
    """Fully merged CG; the operator without the constrained-identity
    fixup, as ``vmult_with_merged_sums`` (poisson_operator.h:327-377)."""
    return cg_merged.merged_cg_solve(problem.a_apply, problem.b,
                                     problem.inv_diag, max_iter=max_iter,
                                     rel_tol=rel_tol)


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


def piece_perm(p: int) -> np.ndarray:
    """The TPU layout's column order of the dense matrices: :func:`piece_perm2d`
    within each kz plane (``laplace_pallas._piece_perm``)."""
    p1 = p + 1
    return np.concatenate([kz * p1 * p1 + piece_perm2d(p) for kz in range(p1)])
