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

Three operator backends, as the JAX package's:

* ``"pallas"`` (default) — the kernels: the apply family
  (:mod:`~mf_data_locality_tpu_torch.ops.laplace_apply`) for the merged and
  baseline solvers, the fused solver's operator on ``windowing="pieces"``;
* ``"structured"`` — the lattice operator with no gather or scatter
  (:mod:`~mf_data_locality_tpu_torch.ops.laplace_structured`, plain
  PyTorch);
* ``"general"`` — gather and scatter through the cell-to-node map
  (:mod:`~mf_data_locality_tpu_torch.ops.laplace`, plain PyTorch).

Solver vectors are flat ``(C, n_nodes)``; :attr:`BP4Problem.a_apply` and
:attr:`BP4Problem.a_apply_full` reshape them to the lattice only inside the
operator (``pallas``, ``structured``).  The fused solver works on lattice
vectors directly.  BP4 pairs with q = p + 2; ``n_q`` and ``n_components``
(1: the scalar BP1/BP3 analogues; CEED BP3 is one component at q = p + 2)
reach every builder.  The kernels of ``pallas`` take one or three
components and q = p + 1 or p + 2 under ``highest`` and ``split2m``
(``laplace_cuda.check_shape``; the rest is ``ROADMAP.md`` queue B item
6g).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import (diagonal, laplace, laplace_apply,
                                            laplace_cuda, laplace_structured)
from mf_data_locality_tpu_torch.solvers import cg, cg_merged
from mf_data_locality_tpu_torch.solvers.cg import SolveResult


_VMULT = {"pallas": laplace_apply.vmult,
          "structured": laplace_structured.vmult,
          "general": laplace.vmult}
BACKENDS = tuple(_VMULT)


@dataclass(frozen=True)
class BP4Problem:
    layout: DofLayout
    # laplace_cuda.OperatorData (pallas), laplace_structured.
    # StructuredOperatorData or laplace.LaplaceOperatorData
    op: Any
    inv_diag: torch.Tensor  # (1, n_nodes); bf16 for a bf16 state
    b: torch.Tensor         # (C, n_nodes); bf16 for a bf16 state
    n_components: int
    backend: str = "pallas"

    @property
    def n_dofs(self) -> int:
        return self.layout.n_nodes * self.n_components

    @property
    def n_q(self) -> int:
        return self.op.n_q

    @property
    def lattice_shape(self) -> tuple[int, int, int, int]:
        return (self.n_components,) + self.layout.n_nodes_axis

    def _wrap(self, constrained_identity: bool):
        vmult = _VMULT[self.backend]
        if self.backend == "general":
            return lambda u: vmult(self.op, u,
                                   constrained_identity=constrained_identity)
        lat = self.lattice_shape

        def apply_flat(u: torch.Tensor) -> torch.Tensor:
            v = vmult(self.op, u.reshape(lat),
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
          windowing: str = "reshape",
          metric_dtype: torch.dtype | None = None,
          n_components: int = 3, n_q: int | None = None,
          backend: str = "pallas") -> BP4Problem:
    """BP4 on 2**s cells at ``degree``; every array on ``device``.

    The defaults are the JAX ``bp4.build``'s: the apply family's exact
    operator (dense factorization, streamed metric, reshape windowing);
    ``metric="onthefly"`` (reshape) or the ``pieces`` and ``zslab``
    windowings select its other kernels.  ``windowing="pieces"`` with a
    (factor, metric) pair of ``laplace_cuda.fused_configs`` builds the
    fused solver's operator: dense or twostage, the metric streamed or
    rebuilt (the JAX fused tests' default is the dense, streamed one), by
    ``cofactor`` "adjj" or "jtj".  With jtj the build raises ValueError
    unless det J > 0 at every quadrature point: jtj scales by |det J|, adjj
    by det J (``laplace_cuda.check_orientation``; the JAX package does not
    check).  ``dtype=torch.bfloat16`` (the bf16 state of every solver, on
    every rung and windowing) keeps the operator's tables in f32 and
    stores b and the preconditioner in bf16, the preconditioner rounded
    from f32 as the JAX ``bp4.build`` does; ``metric_dtype=torch.bfloat16``
    streams the metric in bf16 (every rung).

    ``n_components`` (the RHS pattern ``dof_index % 8`` is taken with it)
    and ``n_q`` (default p + 2) reach every backend's builder; ``backend``
    ``"structured"`` or ``"general"`` builds the plain operators, which
    take any of both, and ignores ``precision``, ``windowing``,
    ``metric_dtype``, ``factor``, ``metric`` and ``cofactor``, as the JAX
    ``bp4.build`` passes them to the pallas builder only.  On ``pallas``
    ``n_components`` 1 (CEED BP3) or 3 and ``n_q`` p + 1 or p + 2 under
    ``highest`` and ``split2m`` with the vectors and the metric at the
    working dtype; the rest of those shapes raises NotImplementedError
    (``ROADMAP.md`` queue B item 6g, ``laplace_cuda.check_shape``).  A
    bf16 state is ``pallas``'s only (ValueError elsewhere, as in the JAX
    package).
    """
    if backend not in _VMULT:
        raise ValueError(f"unknown backend {backend!r}")
    if dtype == torch.bfloat16 and backend != "pallas":
        raise ValueError(
            "bf16 vector storage is supported on the pallas backend (f32 "
            f"compute in the kernels); use dtype=float32 with "
            f"backend={backend!r}")
    if backend == "pallas":
        laplace_cuda.check_shape(degree, degree + 2 if n_q is None else n_q,
                                 n_components, precision, dtype,
                                 metric_dtype)
    layout = DofLayout(BoxMesh.from_s(s), degree)
    if backend == "pallas":
        op = laplace_cuda.make_operator(
            layout, dtype=dtype, precision=precision, factor=factor,
            metric=metric, cofactor=cofactor, device=device,
            windowing=windowing, metric_dtype=metric_dtype, n_q=n_q)
    elif backend == "structured":
        op = laplace_structured.make_structured_operator(
            layout, n_q=n_q, dtype=dtype, device=device)
    else:
        op = laplace.make_operator(layout, n_q=n_q, dtype=dtype,
                                   device=device)
    inv_diag = torch.tensor(inverse_diagonal(s, degree))
    return BP4Problem(
        layout, op,
        inv_diag[None, :].to(op.dtype).to(device=device, dtype=dtype),
        torch.as_tensor(rhs(layout, n_components)).to(device=device,
                                                      dtype=dtype)
        .contiguous(), n_components, backend)


@functools.lru_cache(maxsize=32)
def inverse_diagonal(s: int, degree: int) -> np.ndarray:
    """The preconditioner of 2**s cells at ``degree`` (f64, one entry a
    node: ``diagonal.compute_inverse_diagonal``), read-only and kept for
    the process's next builds at the same size, whose host setup it
    dominates (1.8-7 s a build at p=4..8, s=11..15)."""
    d = diagonal.compute_inverse_diagonal(DofLayout(BoxMesh.from_s(s),
                                                    degree))
    d.setflags(write=False)
    return d


def from_jax_arrays(s: int, degree: int, *, pds: np.ndarray,
                    w3: np.ndarray, coeffs: np.ndarray, mask: np.ndarray,
                    b: np.ndarray, inv_diag: np.ndarray,
                    mats2d: np.ndarray | None = None,
                    mats: np.ndarray | None = None,
                    gmetric: np.ndarray | None = None,
                    factor: str = "twostage", windowing: str = "pieces",
                    cofactor: str = "adjj", precision: str = "split2m",
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cuda",
                    metric_dtype: torch.dtype | None = None) -> BP4Problem:
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
    and ``cofactor`` are the JAX operator's: a fused operator built dense
    carries its ``mats`` (and ``gmetric`` if streamed) across; jtj needs
    det J > 0 at every quadrature point, as in :func:`build`.  bf16 arrays
    (a bf16 ``gmetric``; ``b`` and ``inv_diag`` of a bf16 state) are
    carried bit for bit (``laplace_cuda.host_tensor``); ``metric_dtype``
    defaults to ``gmetric``'s when that is bf16.
    """
    layout = DofLayout(BoxMesh.from_s(s), degree)
    nc = layout.mesh.n_cells
    q = round(np.asarray(w3).size ** (1 / 3))  # the JAX operator's n_q

    if gmetric is not None and metric_dtype is None and np.asarray(
            gmetric).dtype.name == "bfloat16":
        metric_dtype = torch.bfloat16

    op = laplace_cuda.operator_from_arrays(
        pds, w3, np.asarray(coeffs)[:, :, :nc], mask, degree,
        layout.mesh.n_cells_axis, precision, dtype, device,
        mats2d=_canonical(mats2d, piece_perm2d(degree),
                          windowing == "pieces"),
        mats=_canonical(mats, piece_perm(degree), windowing == "pieces"),
        gmetric=(None if gmetric is None else
                 np.asarray(gmetric).reshape(6 * q ** 3, -1)[:, :nc]),
        factor=factor, windowing=windowing, cofactor=cofactor,
        metric_dtype=metric_dtype)
    host = laplace_cuda.host_tensor
    return BP4Problem(
        layout, op, host(inv_diag).to(device=device, dtype=dtype),
        host(b).contiguous().to(device=device, dtype=dtype),
        int(np.asarray(b).shape[0]))


def slab_from_jax_arrays(*, degree: int, rank: int, ncz_global: int,
                         **arrays):
    """One rank's slab problem (``parallel.distributed.SlabProblem``) from
    the JAX ``DistributedBP4``'s arrays of device ``rank``, passed as numpy,
    so that a port rank works on the JAX package's own slab.

    ``b`` (C, Pp+1, Ny, Nx), ``inv_diag`` and ``mask`` (1, Pp+1, Ny, Nx),
    ``weight`` (1, Pp+1, 1, 1); ``ncz_global``, ``n_dofs``, ``n_cells``
    the global mesh's.  ``pallas`` (the dense factorization): ``pds``,
    ``w3``, ``coeffs`` (3, 8, nc_pad), optionally ``mats``, ``mats2d``
    (in the pieces column order under ``windowing="pieces"``) and
    ``gmetric`` (6 q^3, nc_pad; None: the metric rebuilt), padded cell
    columns dropped as :func:`from_jax_arrays` drops them; ``structured``:
    ``values``, ``d_col``, ``q_pts``, ``w3`` (1, q, 1, q, 1, q) and
    ``coeffs`` (ncz_loc, 1, ncy, 1, ncx, 1, 8, 3).
    """
    cells = [(n - 1) // degree for n in np.asarray(arrays["mask"]).shape[1:]]
    return _rank_from_jax_arrays(
        degree, ((rank * cells[0], 0, 0), (ncz_global, *cells[1:])),
        ((1, 0),), **arrays)


def block_from_jax_arrays(*, degree: int, coords, mesh_shape, nc_global,
                          **arrays):
    """One rank's block (``parallel.distributed.SlabProblem`` of
    ``build_block``) from the JAX ``DistributedBP4_2D``'s or ``_3D``'s
    arrays of the device at ``coords`` of its ``mesh_shape`` mesh, passed as
    numpy: the keywords of :func:`slab_from_jax_arrays` on the block's
    (C, Pz+1, Py+1, Nx) or (C, Pz+1, Py+1, Px+1) lattice (``weight`` (1,
    Pz+1, Py+1, 1) or (1, Pz+1, Py+1, Px+1); ``structured`` ``coeffs``
    (Lz, 1, Ly, 1, Lx, 1, 8, 3)), and ``nc_global`` the global mesh's
    real cell counts (the JAX ``nc_global``)."""
    from mf_data_locality_tpu_torch.parallel import distributed

    shape = np.asarray(arrays["mask"]).shape[1:]
    origin = tuple(c * ((n - 1) // degree) for c, n in zip(
        tuple(coords) + (0,) * (3 - len(coords)), shape))
    return _rank_from_jax_arrays(degree, (origin, tuple(nc_global)),
                                 distributed.halo_axes(mesh_shape), **arrays)


def _rank_from_jax_arrays(degree: int, slab: tuple, halo: tuple, *,
                          n_dofs: int, n_cells: int,
                          b: np.ndarray, inv_diag: np.ndarray,
                          weight: np.ndarray, mask: np.ndarray,
                          coeffs: np.ndarray, backend: str = "pallas",
                          windowing: str = "reshape",
                          precision: str = "highest",
                          dtype: torch.dtype = torch.float64,
                          device: torch.device | str = "cuda",
                          pds: np.ndarray | None = None,
                          w3: np.ndarray | None = None,
                          mats: np.ndarray | None = None,
                          mats2d: np.ndarray | None = None,
                          gmetric: np.ndarray | None = None,
                          values: np.ndarray | None = None,
                          d_col: np.ndarray | None = None,
                          q_pts: np.ndarray | None = None):
    from mf_data_locality_tpu_torch.parallel import distributed

    p = degree
    cells = tuple((n - 1) // p for n in np.asarray(mask).shape[1:])
    if backend == "structured":
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                               dtype=dtype)

        op = laplace_structured.StructuredOperatorData(
            values=t(values), d_col=t(d_col), q_pts=t(q_pts), w3=t(w3),
            coeffs=t(coeffs), mask=t(mask))
    else:
        nc = cells[0] * cells[1] * cells[2]
        perm = windowing == "pieces"
        op = laplace_cuda.operator_from_arrays(
            pds, w3, np.asarray(coeffs)[:, :, :nc], mask, p, cells,
            precision, dtype, device,
            mats2d=_canonical(mats2d, piece_perm2d(p), perm),
            mats=_canonical(mats, piece_perm(p), perm),
            gmetric=(None if gmetric is None else np.asarray(gmetric)
                     .reshape(6 * (p + 2) ** 3, -1)[:, :nc]),
            factor="dense", windowing=windowing, slab=slab)
    return distributed._slab_problem(
        op, dict(inv_diag=inv_diag, b=b, weight=weight, n_dofs=n_dofs,
                 n_cells=n_cells), dtype, device, backend, halo)


def _canonical(a, perm, pieces: bool):
    """A JAX matrix in canonical column order (``pieces``: undo the TPU's
    corner-piece order)."""
    if a is None or not pieces:
        return a
    out = np.empty_like(np.asarray(a))
    out[:, perm] = a
    return out


def solve_baseline(problem: BP4Problem, max_iter: int = 100,
                   rel_tol: float = 1e-8) -> SolveResult:
    """Textbook PCG with the full vmult (constrained identity), as the
    reference's ``benchmark_precond``.  A bf16 problem (``dtype=
    torch.bfloat16``) stores p and Ap in bf16 (``cg.cg_solve``)."""
    return cg.cg_solve(problem.a_apply_full, problem.b, problem.inv_diag,
                       max_iter=max_iter, rel_tol=rel_tol)


def solve_merged(problem: BP4Problem, max_iter: int = 100,
                 rel_tol: float = 1e-8) -> SolveResult:
    """Fully merged CG; the operator without the constrained-identity
    fixup, as ``vmult_with_merged_sums`` (poisson_operator.h:327-377).  A
    bf16 problem stores d and h in bf16 (``cg_merged.merged_cg_solve``)."""
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
