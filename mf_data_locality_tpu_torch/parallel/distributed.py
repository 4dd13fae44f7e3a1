"""Distributed BP4: z-slab and block domain decomposition over rank
processes.

Counterpart of ``mf_data_locality_tpu.parallel.distributed`` (its 1D
z-slab form with ``overlap``, and the (z, y) and (z, y, x) meshes of
``build_distributed_2d`` / ``_3d``; the general backend is
:mod:`.dist_general`).  The reference's MPI layer (SURVEY.md §2) maps onto
it as in the JAX package:

* **p4est partition -> z-slab partition.**  The structured mesh is split
  into slabs of ``ceil(ncz / n_ranks)`` cell layers along z; rank r owns
  slab r.  When the rank count does not divide ncz, the trailing slabs
  carry dummy layers — unit-geometry cells, a zero mask and zero weights
  (``poisson_operator.h:269-280``) —, so every rank holds arrays of one
  shape.  Each rank builds only its own slab (:func:`build_slab`): its
  cells' geometry, metric, preconditioner and right-hand side, from the
  global mesh's definition and not from global arrays.
* **Ghost exchange -> two one-plane shifts.**  A vector is a slab of
  ``Pp + 1`` node planes whose top plane is a copy of the upper slab's
  plane 0 (the deal.II partitioner's ghost row).  After a local operator
  apply the shared plane holds partial sums on both sides: one shift sends
  the lower partial down to be added, a second sends the completed plane
  back up (:func:`dist_vmult`; ``poisson_operator.h:310,339``).  With
  ``overlap`` the bottom and top cell layers are applied first and the
  downward shift is posted before the interior layers are launched, so
  the message travels while the card computes them (the reference's
  before/after-ghost cell ranges inside ``cell_loop``).
* **7-scalar all-reduce.**  The merged CG's reduction hook is one
  all-reduce of its 7 sums an iteration (``poisson_operator.h:373-375``);
  the bottom plane of every rank above rank 0 (owned by the rank below)
  and the dummy planes get weight 0 in the local sums.

* **Blocks.**  On a (Dz, Dy) or (Dz, Dy, Dx) rank mesh (:func:`build_block`)
  each rank owns a block of ``ceil(nc / D)`` cells along each axis, with a
  ghost top face on every split axis: (C, Pz+1, Py+1, Px+1), the full
  node count on an axis that is not split.  Trailing blocks carry dummy
  cells on every axis.  The halo sum runs axis by axis, z, then y, then x,
  two shifts each, each shift carrying the whole face, ghost rows of the
  other axes included, so that edges and corners sum by linearity (the
  JAX package's dimension-split ``_halo_sum_axis``); the weights are 0 on
  the bottom face of each axis the rank does not own.

State invariant: plane Pp of rank r equals plane 0 of rank r + 1 (on a
mesh: each top face equals the upper neighbour's face 0 along that axis);
every update is elementwise, and the operator apply restores it after the
halo sum.  Ranks, their devices and the transport are :mod:`.comm`'s; the
fused solver's loop is :mod:`.dist_fused`'s.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import partial
from typing import Any

import functools
import math
import time

import numpy as np
import torch

from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import (cg_fused_kernel as fk, diagonal,
                                            geometry, lagrange, laplace_apply,
                                            laplace_cuda, laplace_structured)
from mf_data_locality_tpu_torch.parallel import comm as comm_mod
from mf_data_locality_tpu_torch.parallel import dist_general
from mf_data_locality_tpu_torch.solvers import cg, cg_merged
from mf_data_locality_tpu_torch.solvers.cg import SolveResult

BACKENDS = ("pallas", "structured", "general")
SOLVERS = ("merged", "baseline", "fused")
# the kernel wrappers whose launches a rank counts
WRAPPERS = {"matvec": fk.matvec,
            "fused_cg_iteration": fk.fused_cg_iteration,
            "fused_cg_assemble": fk.fused_cg_assemble,
            "apply_local_batched_g": laplace_apply.apply_local_batched_g,
            "apply_local_batched_onthefly":
                laplace_apply.apply_local_batched_onthefly,
            "apply_lattice_pieces": laplace_apply.apply_lattice_pieces,
            "apply_lattice_zslab": laplace_apply.apply_lattice_zslab}


@dataclass(frozen=True)
class SlabProblem:
    """One rank's slab or block of the BP4 problem (the JAX
    ``DistributedBP4``'s, ``_2D``'s or ``_3D``'s per-device arrays), every
    tensor on the rank's device.

    ``op``: the operator — ``laplace_cuda.OperatorData`` with
    ``slab=((z0, y0, x0), (ncz, ncy, ncx))``, the block's origin and the
    global cell counts (``pallas``, dense factorization), or
    ``laplace_structured.StructuredOperatorData`` (``structured``), on the
    rank's cells and mask.  ``inv_diag`` (1, Pz+1, Ny, Nx), ``b`` (C,
    Pz+1, Ny, Nx) (a block: Py+1 and Px+1 on split axes) and ``weight``:
    1 on owned nodes, 0 on the bottom face of each split axis above its
    first rank and on dummy nodes; of size 1 along the axes it does not
    vary on (a slab: (1, Pp+1, 1, 1)).  ``halo``: the (lattice dim, rank
    grid axis) of each axis the halo sums run along, in order (a slab:
    z, along grid axis 0, or (0, 1) on a 2-level grid).
    """

    op: Any
    inv_diag: torch.Tensor
    b: torch.Tensor
    weight: torch.Tensor
    n_dofs: int   # the global problem's
    n_cells: int
    backend: str = "pallas"
    halo: tuple = ((1, 0),)


def cells_per_slab(ncz: int, n_ranks: int) -> int:
    """z-cell layers a slab: ceil(ncz / n_ranks) (``_cells_per_slab``)."""
    return -(-ncz // n_ranks)


def check_distributed(solver: str, backend: str, windowing: str,
                      metric: str, overlap: bool = False) -> None:
    """Raise ValueError for what the distributed CLI paths do not run: what
    the JAX CLI refuses, and ``overlap`` on the general backend, which
    has no overlapped apply (the JAX CLI ignores it there; on a rank mesh
    :func:`dist_vmult` and ``dist_fused.solve_fused`` refuse it)."""
    if overlap and backend == "general":
        raise ValueError("--overlap runs on z-slab ranks only: the general "
                         "backend has no overlapped apply (as in the JAX "
                         "package)")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}")
    if solver == "fused":
        if backend != "pallas" or windowing != "pieces":
            raise ValueError("--solver fused --devices N requires "
                             "--backend pallas --windowing pieces")
        if metric not in ("precomputed", "onthefly"):
            raise ValueError(f"unknown metric mode {metric!r}")
    elif backend == "general" and metric != "precomputed":
        raise ValueError(
            f"--backend general cannot honor --geometry {metric!r} (the "
            f"gather/scatter backend has no in-kernel rebuild)")
    elif metric != "precomputed":
        raise ValueError(
            f"--solver {solver} --devices N cannot honor --geometry "
            f"{metric!r} (only the fused distributed path has the "
            f"in-kernel rebuild)")


def _block_cells(mesh: BoxMesh, lo, hi) -> np.ndarray:
    """Trilinear coefficients (hi - lo per axis, 8, 3) of the global mesh's
    cells [lo, hi) on each axis (z, y, x), from that range of its vertex
    lattice (the global lattice is (ncz+1)(ncy+1)(ncx+1) points, cheap even
    at the ladder's top; slicing it keeps every vertex the global build's,
    bit for bit, where mapping the block's vertices alone would round some
    sines apart)."""
    n = [b - a for a, b in zip(lo, hi)]
    lat = mesh.vertex_lattice[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1,
                              lo[2]:hi[2] + 1]
    verts = np.empty((*n, 8, 3))
    for v in range(8):
        dx, dy, dz = v & 1, (v >> 1) & 1, (v >> 2) & 1
        verts[..., v, :] = lat[dz:dz + n[0], dy:dy + n[1], dx:dx + n[2], :]
    return geometry.trilinear_coefficients(verts)


def _pad_dummy_cells(co: np.ndarray, target) -> np.ndarray:
    """A (ncz', ncy', ncx', 8, 3) coefficient block padded to ``target``
    cells an axis with unit-geometry dummy cells (x = u, y = v, z = w;
    ``_pad_dummy_cells``, ``poisson_operator.h:269-280``)."""
    for ax in range(3):
        short = target[ax] - co.shape[ax]
        if short:
            shape = list(co.shape)
            shape[ax] = short
            pad = np.zeros(shape)
            pad[..., 1, 0] = pad[..., 2, 1] = pad[..., 4, 2] = 1.0
            co = np.concatenate([co, pad], axis=ax)
    return co


def _mesh3(mesh_shape) -> tuple[int, int, int]:
    return tuple(mesh_shape) + (1,) * (3 - len(mesh_shape))


def block_arrays(s: int, degree: int, coords, mesh_shape,
                 n_components: int = 3) -> dict[str, Any]:
    """:func:`_block_arrays`, computed once for the rank's jobs on the same
    block (their host setup: the window's diagonal and geometry, seconds
    at p=4 s=15); the arrays are the caller's copies."""
    a = _block_arrays(s, degree, tuple(coords), tuple(mesh_shape),
                      n_components)
    return {k: v.copy() if isinstance(v, np.ndarray) else v
            for k, v in a.items()}


@functools.lru_cache(maxsize=4)
def _block_arrays(s: int, degree: int, coords, mesh_shape,
                  n_components: int = 3) -> dict[str, Any]:
    """Host arrays (f64 NumPy) of the rank at ``coords`` of a ``mesh_shape``
    rank mesh ((D,), (Dz, Dy) or (Dz, Dy, Dx); the JAX ``_pad_slice`` /
    ``_pad_dummy_cells`` cuts of ``build_distributed_2d`` / ``_3d``):
    ``coeffs`` (Lz, Ly, Lx, 8, 3), L = ceil(nc / D) on each axis, with
    dummy cells past the global end, ``mask``, ``inv_diag`` (1, Pz+1,
    Py+1, Px+1), ``b`` (C, Pz+1, Py+1, Px+1), ``weight`` (size 1 along y
    and x where the mesh does not split them), ``origin`` (the first global
    cell on each axis), ``nc_global`` and the global mesh's sizes.  The
    values are the global problem's (``models/bp4.build``) on the block's
    nodes, zero on dummy nodes; the weights are 0 on the bottom face of
    each axis above its first rank (the rank below owns it) and past the
    global end."""
    mesh = BoxMesh.from_s(s)
    nc = mesh.n_cells_axis
    shape, coords = _mesh3(mesh_shape), tuple(coords) + (0,) * (
        3 - len(coords))
    p = degree
    L = [cells_per_slab(n, D) for n, D in zip(nc, shape)]
    lo = [c * l for c, l in zip(coords, L)]
    real = [max(0, min(a + l, n) - a) for a, l, n in zip(lo, L, nc)]
    co = (_block_cells(mesh, lo, [a + r for a, r in zip(lo, real)])
          if all(real) else np.zeros((*real, 8, 3)))
    co = _pad_dummy_cells(co, L)

    nn = [p * n + 1 for n in nc]
    idx = [a * p + np.arange(l * p + 1) for a, l in zip(lo, L)]  # global
    live = [i < n for i, n in zip(idx, nn)]
    inner = [(i > 0) & (i < n - 1) for i, n in zip(idx, nn)]
    mask = (inner[0][:, None, None] & inner[1][None, :, None]
            & inner[2][None, None, :]).astype(np.float64)

    # the preconditioner: the cells [w0, w1) of each axis touch every node
    # of the block; their contributions summed in global cell order, as
    # the global diagonal sums them
    inv = np.zeros(mask.shape)
    w0 = [max(a - 1, 0) for a in lo]
    w1 = [min(a + l + 1, n) for a, l, n in zip(lo, L, nc)]
    if all(a < b for a, b in zip(w0, w1)):
        cells = tuple(b - a for a, b in zip(w0, w1))
        win = DofLayout(BoxMesh(cells, mesh.spacing, mesh.deformed,
                                mesh.factor), p)
        diag = diagonal.summed_diagonal(
            win, _block_cells(mesh, w0, w1).reshape(-1, 8, 3)).reshape(
            tuple(c * p + 1 for c in cells))
        k = [np.flatnonzero(v) for v in live]
        sel = np.ix_(*k)
        d = diag[np.ix_(*(i[j] - a * p for i, j, a in zip(idx, k, w0)))]
        free = mask[sel] > 0
        inv[sel] = np.where(free, 1.0 / np.where(free, d, 1.0), 1.0)

    node = ((idx[0][:, None, None] * nn[1] + idx[1][None, :, None]) * nn[2]
            + idx[2][None, None, :])
    dof = node[None] * n_components + np.arange(n_components)[:, None, None,
                                                              None]
    b = (dof % 8).astype(np.float64) * (mask[None] > 0)

    w = [v.astype(np.float64) for v in live]
    for ax in range(3):
        if coords[ax] > 0:
            w[ax][0] = 0.0
        if ax and shape[ax] == 1:  # constant 1 along an axis not split
            w[ax] = w[ax][:1]
    weight = w[0][:, None, None] * w[1][None, :, None] * w[2][None, None, :]
    return dict(coeffs=co, mask=mask[None], inv_diag=inv[None], b=b,
                weight=weight[None], origin=tuple(lo), nc_global=tuple(nc),
                n_cells_axis=tuple(L), n_dofs=math.prod(nn) * n_components,
                n_cells=mesh.n_cells)


def slab_arrays(s: int, degree: int, rank: int, n_ranks: int,
                n_components: int = 3) -> dict[str, Any]:
    """:func:`block_arrays` of slab ``rank`` of ``n_ranks`` z-slabs, with
    its first layer ``z0`` and the global layer count ``ncz_global``:
    ``coeffs`` (ncz_loc, ncy, ncx, 8, 3), ``inv_diag`` (1, Pp+1, Ny, Nx),
    ``b`` (C, Pp+1, Ny, Nx), ``weight`` (1, Pp+1, 1, 1)."""
    a = block_arrays(s, degree, (rank,), (n_ranks,), n_components)
    return dict(a, z0=a["origin"][0], ncz_global=a["nc_global"][0])


def build_slab(s: int, degree: int, rank: int, n_ranks: int,
               dtype: torch.dtype = torch.float32, backend: str = "pallas",
               precision: str = "highest", windowing: str = "reshape",
               metric: str = "precomputed",
               device: torch.device | str = "cuda",
               axis: int | tuple[int, ...] = 0) -> SlabProblem:
    """Slab ``rank`` of BP4 on 2**s cells over ``n_ranks`` ranks
    (``build_distributed``): on ``pallas`` the dense factorization, the
    metric streamed or (the fused solver's ``metric="onthefly"``) rebuilt
    from the coefficients by adjj; ``dtype=torch.bfloat16`` is the bf16
    state of every solver (f32 tables; b and the preconditioner rounded
    to bf16 from f64, as the JAX slabs are).  ``axis``: the rank grid's axis
    the slabs run along (``(0, 1)`` on a 2-level grid)."""
    a = slab_arrays(s, degree, rank, n_ranks)
    return _build(a, (a["origin"], a["nc_global"]), ((1, axis),), degree,
                  dtype, backend, precision, windowing, metric, device)


def halo_axes(mesh_shape) -> tuple[tuple[int, int], ...]:
    """The (lattice dim, rank grid axis) of each axis a ``mesh_shape``
    block mesh splits, in the order z, y, x."""
    return tuple((1 + a, a) for a, n in enumerate(mesh_shape) if n > 1)


def build_block(s: int, degree: int, coords, mesh_shape,
                dtype: torch.dtype = torch.float32, backend: str = "pallas",
                precision: str = "highest", windowing: str = "reshape",
                metric: str = "precomputed",
                device: torch.device | str = "cuda") -> SlabProblem:
    """The block of BP4 on 2**s cells of the rank at ``coords`` of a (Dz,
    Dy) or (Dz, Dy, Dx) rank mesh (``build_distributed_2d`` / ``_3d``):
    :func:`block_arrays`, then the operator as :func:`build_slab` builds
    it, its ``slab`` the block's origin and the global cell counts."""
    a = block_arrays(s, degree, coords, mesh_shape)
    return _build(a, (a["origin"], a["nc_global"]), halo_axes(mesh_shape),
                  degree, dtype, backend, precision, windowing, metric,
                  device)


def _build(a: dict, slab: tuple, halo: tuple, degree: int, dtype, backend,
           precision, windowing, metric, device) -> SlabProblem:
    p, q = degree, degree + 2
    co = a["coeffs"].reshape(-1, 8, 3)
    if backend == "structured":
        shape = lagrange.make_shape(p, q)
        w = shape.q_weights
        w3 = w[:, None, None] * w[None, :, None] * w[None, None, :]
        lz, ly, lx = a["n_cells_axis"]

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x)).to(device=device,
                                                               dtype=dtype)

        op = laplace_structured.StructuredOperatorData(
            values=t(shape.values), d_col=t(shape.d_col),
            q_pts=t(shape.q_points), w3=t(w3.reshape(1, q, 1, q, 1, q)),
            coeffs=t(co.reshape(lz, 1, ly, 1, lx, 1, 8, 3)),
            mask=t(a["mask"]))
    elif backend == "pallas":
        shape = lagrange.make_shape(p, q)
        w3 = laplace_cuda.tensor_weights(p, q)
        op = laplace_cuda.operator_from_arrays(
            laplace_cuda.monomial_derivative_matrices(shape.q_points), w3,
            co.transpose(2, 1, 0), a["mask"], p, a["n_cells_axis"],
            precision, dtype, device,
            gmetric=(laplace_cuda.metric_entries(co, shape.q_points, w3)
                     if metric == "precomputed" else None),
            factor="dense", windowing=windowing, slab=slab)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return _slab_problem(op, a, dtype, device, backend, halo)


def _slab_problem(op, a: dict, dtype, device, backend: str,
                  halo: tuple = ((1, 0),)) -> SlabProblem:
    vec = torch.float32 if dtype == torch.bfloat16 else op.dtype

    def t(x, to):
        return laplace_cuda.host_tensor(x).contiguous().to(device=device,
                                                           dtype=to)

    return SlabProblem(op=op, inv_diag=t(a["inv_diag"], dtype),
                       b=t(a["b"], dtype), weight=t(a["weight"], vec),
                       n_dofs=a["n_dofs"], n_cells=a["n_cells"],
                       backend=backend, halo=halo)


def _halo_sum(comm: comm_mod.Comm, v: torch.Tensor,
              halo: tuple) -> torch.Tensor:
    """Complete the shared faces' partial sums along each axis of ``halo``
    in turn (``_halo_sum_axis``): the upper neighbour's face-0 partial is
    added to this rank's top face, and the completed top face replaces the
    upper neighbour's stale face 0.  Each face is whole, the ghost rows of
    the other axes included, so an edge or corner node sums over every
    rank that holds it."""
    for dim, axis in halo:
        recv = comm.shift([v.select(dim, 0)], up=False, axis=axis)
        if recv is not None:
            v.select(dim, -1).add_(recv[0])
        recv = comm.shift([v.select(dim, -1)], up=True, axis=axis)
        if recv is not None:
            v.select(dim, 0).copy_(recv[0])
    return v


def _apply(op, u: torch.Tensor, backend: str) -> torch.Tensor:
    if backend == "pallas":
        return laplace_apply.apply_lattice(op, u)
    return laplace_structured.apply_lattice(op, u)


def _sub_apply(op, um: torch.Tensor, c0: int, c1: int,
               backend: str) -> torch.Tensor:
    """The local apply on the cell layers [c0, c1) of the slab: the
    operator of that range (``_sub_op``) on its planes [c0 p, c1 p]."""
    p = op.degree
    sub = (laplace_cuda.sub_operator(op, c0, c1) if backend == "pallas"
           else laplace_structured.sub_operator(op, c0, c1))
    return _apply(sub, um[:, c0 * p:c1 * p + 1].contiguous(), backend)


def _overlapped(slab: SlabProblem, comm: comm_mod.Comm,
                um: torch.Tensor) -> torch.Tensor | None:
    """The boundary-first apply and halo sum of a z-slab (``dist_vmult``'s
    ``overlap`` branch, ``distributed.py:371-421`` of the JAX package): the
    bottom and top cell layers; the downward shift of the bottom layer's
    plane 0 started; the interior layers; the shift finished and added to
    the top plane; the upward shift as in :func:`_halo_sum`.  None where
    the JAX package falls back to the plain apply: one rank along the
    axis, or fewer than 3 cell layers a slab."""
    op, backend = slab.op, slab.backend
    (dim, axis), = slab.halo
    axes = (axis,) if isinstance(axis, int) else axis
    ncz = op.coeffs.shape[0] if backend == "structured" else \
        op.n_cells_axis[0]
    if math.prod(comm.mesh_shape[a] for a in axes) == 1 or ncz < 3:
        return None
    p, top = op.degree, um.shape[1] - 1
    raw = torch.zeros_like(um)
    raw[:, :p + 1] = _sub_apply(op, um, 0, 1, backend)
    v_top = _sub_apply(op, um, ncz - 1, ncz, backend)
    pending = comm.start([raw[:, 0]], up=False, axis=axis)
    raw[:, p:top - p + 1] += _sub_apply(op, um, 1, ncz - 1, backend)
    raw[:, top - p:] += v_top
    recv = comm.finish(pending)
    if recv is not None:
        raw[:, -1] += recv[0]
    recv = comm.shift([raw[:, -1]], up=True, axis=axis)
    if recv is not None:
        raw[:, 0] = recv[0]
    return raw


def dist_vmult(slab: SlabProblem, comm: comm_mod.Comm, u: torch.Tensor,
               constrained_identity: bool = True,
               overlap: bool = False) -> torch.Tensor:
    """The operator on a slab or block vector (``dist_vmult``;
    ``dist_vmult_2d``, ``solve_3d``'s ``a_fn``): the masked local apply —
    B3 on the cell batches (``reshape``), B5 or B6 with the rank's mask
    (``pieces``, ``zslab``), or the structured operator —, the halo sum
    (two shifts an axis of ``slab.halo``), the mask again; plus u at the
    constrained nodes when ``constrained_identity``.

    ``overlap`` (z-slabs only; ValueError on a rank mesh, whose JAX
    counterparts have none): the boundary-first apply (:func:`_overlapped`),
    each of the three layer ranges through the same kernel on its own
    sub-lattice, or the plain apply where the JAX package falls back.
    The sums at the two inner layer seams (planes p and Pp - p) then add
    the ranges' partial sums, the plain apply adds the cells' in its own
    order: the two agree to rounding, not bitwise (f64 p=4 s=7 solves:
    within 1e-9 max(1, |x|), ``tests/test_torch_dist_overlap.py``)."""
    mask = slab.op.mask.to(u.dtype)  # bf16 u: the masks exact in bf16
    um = u * mask
    raw = None
    if overlap:
        if len(slab.halo) != 1 or slab.halo[0][0] != 1:
            raise ValueError("dist_vmult(overlap=True) runs on z-slabs "
                             "only (the JAX package's dist_vmult_2d and "
                             "solve_3d have no overlap)")
        raw = _overlapped(slab, comm, um)
    if raw is None:
        raw = _halo_sum(comm, _apply(slab.op, um, slab.backend), slab.halo)
    v = raw * mask
    if constrained_identity:
        v = v + u * (1.0 - mask)
    return v


def solve(slab: SlabProblem, comm: comm_mod.Comm, solver: str = "merged",
          max_iter: int = 100, rel_tol: float = 1e-8,
          overlap: bool = False) -> SolveResult:
    """The rank's part of a distributed merged or baseline CG solve
    (``distributed.solve``, ``solve_2d``, ``solve_3d``); x is the rank's
    slab or block.  The merged solver makes one all-reduce an iteration
    (its 7 sums, over every rank of the mesh) and one for res0, beside the
    two shifts an axis of each operator apply; the baseline solver one a
    dot product, 3 an iteration and 2 to start.  ``overlap``: each apply
    boundary-first (:func:`dist_vmult`; z-slabs only)."""
    a = partial(dist_vmult, slab, comm,
                constrained_identity=(solver == "baseline"),
                overlap=overlap)
    if solver == "merged":
        return cg_merged.merged_cg_solve(
            a, slab.b, slab.inv_diag, max_iter=max_iter, rel_tol=rel_tol,
            reduce_sums=comm.allreduce, dot_weight=slab.weight)
    if solver == "baseline":
        return cg.cg_solve(a, slab.b, slab.inv_diag, max_iter=max_iter,
                           rel_tol=rel_tol, reduce_scalar=comm.allreduce,
                           dot_weight=slab.weight)
    raise ValueError(f"unknown solver {solver!r}")


def gather_global(slabs, nz: int | None = None) -> torch.Tensor:
    """Rank slabs (C, Pp+1, Ny, Nx), in rank order, -> the global (C, Nz,
    Ny, Nx) vector (``gather_global``); ``nz`` trims trailing dummy
    planes."""
    full = torch.cat([slabs[0]] + [x[:, 1:] for x in slabs[1:]], dim=1)
    return full if nz is None else full[:, :nz]


def gather_global_3d(blocks, mesh_shape, nz: int | None = None,
                     ny: int | None = None,
                     nx: int | None = None) -> torch.Tensor:
    """Rank blocks (C, Pz+1, Py+1, Px+1) of a (Dz, Dy, Dx) mesh, in rank
    order (row-major), -> the global (C, Nz, Ny, Nx) vector
    (``gather_global_3d``): each block's shared faces dropped after the
    first along each axis; ``nz``, ``ny``, ``nx`` trim trailing dummy
    nodes."""
    dz, dy, dx = _mesh3(mesh_shape)
    it = iter(blocks)
    grid = [[[next(it) for _ in range(dx)] for _ in range(dy)]
            for _ in range(dz)]

    def join(parts, dim):
        return torch.cat([parts[0]] + [v.narrow(dim, 1, v.shape[dim] - 1)
                                       for v in parts[1:]], dim=dim)

    full = join([join([join(row, 3) for row in plane], 2) for plane in grid],
                1)
    return full[:, :nz, :ny, :nx]


def gather_global_2d(blocks, mesh_shape, nz: int | None = None,
                     ny: int | None = None) -> torch.Tensor:
    """Rank blocks (C, Pz+1, Py+1, Nx) of a (Dz, Dy) mesh -> the global
    vector (``gather_global_2d``)."""
    return gather_global_3d(blocks, mesh_shape, nz, ny)


# ---------------------------------------------------------------------------
# runs on the ranks
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Job:
    """One distributed run, the same on every rank: the problem and what to
    do with it.

    ``solver``: ``"merged"``, ``"baseline"``, ``"fused"`` (a solve) or
    ``"matvec"`` (one :func:`dist_vmult` of b).  ``backend="general"``:
    the cell-chunk ranks of :mod:`.dist_general` (merged, baseline,
    matvec).  ``overlap``: the halo exchange overlapped with interior
    compute in the solve and the timed matvec (z-slabs;
    :func:`dist_vmult`, ``dist_fused.solve_fused``); ``overlap_matvec``:
    in the matvec only (the JAX CLI's ``--solver fused --overlap``).
    ``mesh_shape``: the rank
    grid — None for z-slabs over all ranks, (Dz, Dy) or (Dz, Dy, Dx) for
    blocks (:func:`build_block`), or with ``two_level`` an (n_slices,
    chips) grid the z-slabs run over, slab k on slice k // chips (the
    fused solver only, as ``build_dist_fused_2level``).  ``x0``: the fused
    z-slab solve's start, a global (C, Nz, Ny, Nx) array of which each
    rank takes its slab (``solve_fused``'s ``x0``).  ``timed``: on a card,
    also the solve's time (minimum over ``solve_repeats``) and the
    operator's (``matvec_inner`` back-to-back applies, minimum over
    ``matvec_repeats``; the fused path with ``metric="onthefly"`` on its
    precomputed-metric twin, as the JAX ``run_one_distributed`` times
    it).  ``arrays``: per-rank arrays in place of the rank's own build
    (``models/bp4.slab_from_jax_arrays``' or ``block_from_jax_arrays``'
    keywords).  ``layout``: on the general backend, the mesh in place of
    the s box (any conforming hex mesh's layout, e.g. ``mesh.general.
    macro_hex_layout``'s; ``s`` is ignored then).
    """

    solver: str
    s: int
    degree: int
    dtype: torch.dtype = torch.float64
    backend: str = "pallas"
    precision: str = "highest"
    windowing: str = "reshape"
    metric: str = "precomputed"
    max_iter: int = 100
    rel_tol: float = 1e-8
    timed: bool = False
    solve_repeats: int = 4
    matvec_repeats: int = 2
    matvec_inner: int = 50
    mesh_shape: tuple | None = None
    two_level: bool = False
    overlap: bool = False
    overlap_matvec: bool = False
    arrays: tuple | None = field(default=None, compare=False)
    x0: Any = field(default=None, compare=False)
    layout: Any = field(default=None, compare=False)

    def __post_init__(self):
        if self.layout is not None and self.backend != "general":
            raise ValueError("a Job's layout= runs on the general backend "
                             "only")

    def mesh(self, n_ranks: int) -> tuple[int, ...]:
        """The rank grid on ``n_ranks`` ranks."""
        return tuple(self.mesh_shape or (n_ranks,))

    @property
    def blocks(self) -> bool:
        """The ranks hold blocks of a (z, y) or (z, y, x) mesh."""
        return self.mesh_shape is not None and not self.two_level

    def build(self, comm: comm_mod.Comm):
        """This rank's slab or block (``comm``'s grid set to the job's), or
        its :class:`.dist_general.GeneralProblem`."""
        if self.arrays is not None:
            from mf_data_locality_tpu_torch.models import bp4

            make = (dist_general.general_from_jax_arrays
                    if self.backend == "general" else
                    bp4.block_from_jax_arrays if self.blocks
                    else bp4.slab_from_jax_arrays)
            return make(**self.arrays[comm.rank], device=comm.device)
        if self.backend == "general":
            return dist_general.build_general(self.s, self.degree, comm.rank,
                                              comm.size, self.dtype,
                                              comm.device, layout=self.layout)
        windowing = "pieces" if self.solver == "fused" else self.windowing
        args = (self.dtype, self.backend, self.precision, windowing,
                self.metric, comm.device)
        if self.blocks:
            return build_block(self.s, self.degree, comm.coords,
                               comm.mesh_shape, *args)
        return build_slab(self.s, self.degree, comm.rank, comm.size, *args,
                          axis=(0, 1) if self.two_level else 0)

    def nodes_axis(self) -> tuple[int, int, int]:
        """The global lattice's nodes an axis."""
        return tuple(n * self.degree + 1
                     for n in BoxMesh.from_s(self.s).n_cells_axis)


def _launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def _zero_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def _slab_of(u, slab: SlabProblem) -> torch.Tensor:
    """The z-slab of a global (C, Nz, Ny, Nx) array on ``slab``'s planes,
    zero past the global top, on its device."""
    z0 = slab.op.slab[0][0] * slab.op.degree
    n = slab.b.shape[1]
    u = laplace_cuda.host_tensor(u)[:, z0:z0 + n]
    u = torch.nn.functional.pad(u, (0, 0, 0, 0, 0, n - u.shape[1]))
    return u.to(device=slab.b.device, dtype=slab.op.dtype).contiguous()


def _run_job(comm: comm_mod.Comm, job: Job) -> dict[str, Any]:
    from mf_data_locality_tpu_torch.parallel import dist_fused
    from mf_data_locality_tpu_torch.utils import timing

    comm.set_mesh(job.mesh(comm.size))
    slab = job.build(comm)
    general = job.backend == "general"
    overlap_mv = job.overlap or job.overlap_matvec
    vmult = (dist_general.dist_vmult_general if general else
             partial(dist_vmult, overlap=overlap_mv))
    if job.solver == "matvec":
        comm.reset()
        _zero_launches()
        v = vmult(slab, comm, slab.b)
        return dict(x=v.cpu(), shifts=comm.shifts, launches=_launches(),
                    comm_s=dict(comm.seconds))
    if job.solver == "fused":
        x0 = None if job.x0 is None else _slab_of(job.x0, slab)
        solve_fn = partial(dist_fused.solve_fused, slab, comm, x0=x0,
                           max_iter=job.max_iter, rel_tol=job.rel_tol,
                           overlap=job.overlap)
    elif general:
        solve_fn = partial(dist_general.solve_general, slab, comm,
                           job.solver, max_iter=job.max_iter,
                           rel_tol=job.rel_tol)
    else:
        solve_fn = partial(solve, slab, comm, job.solver,
                           max_iter=job.max_iter, rel_tol=job.rel_tol,
                           overlap=job.overlap)
    comm.reset()
    _zero_launches()
    t0 = time.perf_counter()
    res = solve_fn()
    wall = time.perf_counter() - t0
    out = dict(x=res.x.cpu(), it=res.n_iterations, res=res.res_norm,
               n_dofs=slab.n_dofs, n_cells=slab.n_cells,
               history=res.res_history.cpu().numpy(),
               converged=res.converged, allreduces=comm.allreduces,
               shifts=comm.shifts, launches_solve=_launches(),
               wall_s=wall, comm_s=dict(comm.seconds))
    if general:
        out["offsets"] = slab.offsets
    if job.timed:
        dev = comm.device
        out["solve_s"] = timing.time_per_call(solve_fn, dev,
                                              repeats=job.solve_repeats,
                                              warmup=0)
        mv = slab
        if job.solver == "fused" and job.metric == "onthefly":
            mv = replace(job, metric="precomputed").build(comm)
        out["matvec_s"] = timing.time_per_call(
            lambda: vmult(mv, comm, mv.b), dev, inner=job.matvec_inner,
            repeats=job.matvec_repeats)
        out["launches"] = _launches()
    return out


def run_jobs(comm: comm_mod.Comm, jobs: tuple[Job, ...]) -> list[dict]:
    """The rank target: every job in turn on this rank; a result dict a
    job (the rank's x slab or block, itCG, residual and history; of its
    first solve the collectives, the kernel launches, the host wall
    seconds and those in the collectives, ``Comm.seconds``; the times of a
    timed job)."""
    return [_run_job(comm, job) for job in jobs]


def launch(jobs, n_ranks: int, device: str = "cuda") -> list[dict]:
    """Run ``jobs`` on ``n_ranks`` rank processes (:func:`comm.run`); per
    job the ranks' results merged: ``x`` the global vector
    (:func:`gather_global`; for blocks :func:`gather_global_3d`, dummy
    nodes trimmed; on the general backend
    ``dist_general.gather_global_general``, as a lattice, or (C,
    n_nodes) on a job's ``layout``), ``it``, ``res``, ``history`` and
    ``converged`` of rank 0 (every rank's itCG must agree), ``ranks``
    every rank's dict, and the slowest rank's times."""
    jobs = tuple(jobs)
    per_rank = comm_mod.run(run_jobs, n_ranks, (jobs,), device)
    out = []
    for j, job in enumerate(jobs):
        rs = [r[j] for r in per_rank]
        nz, ny, nx = job.nodes_axis()
        xs = [r["x"] for r in rs]
        if job.layout is not None:  # (C, n_nodes) of the job's mesh
            x = dist_general.gather_global_general(xs, job.layout)
        elif job.backend == "general":
            layout = DofLayout(BoxMesh.from_s(job.s), job.degree)
            x = dist_general.gather_global_general(xs, layout).reshape(
                xs[0].shape[0], nz, ny, nx)
        elif job.blocks:
            x = gather_global_3d(xs, job.mesh(n_ranks), nz, ny, nx)
        else:
            x = gather_global(xs, nz)
        merged = dict(rs[0], ranks=rs, x=x)
        if job.solver != "matvec":
            its = {r["it"] for r in rs}
            if len(its) != 1:
                raise RuntimeError(f"the ranks disagree on itCG: {its}")
        for key in ("solve_s", "matvec_s"):
            if key in rs[0]:
                merged[key] = max(r[key] for r in rs)
        out.append(merged)
    return out
