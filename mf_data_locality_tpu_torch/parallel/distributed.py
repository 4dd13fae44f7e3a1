"""Distributed BP4: z-slab domain decomposition over rank processes.

Counterpart of ``mf_data_locality_tpu.parallel.distributed`` (its 1D
z-slab form; the 2D, 3D and 2-level meshes, ``dist_general`` and
``--overlap`` are ROADMAP.md queue A item 9b).  The reference's MPI layer
(SURVEY.md §2) maps onto it as in the JAX package:

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
  back up (:func:`dist_vmult`; ``poisson_operator.h:310,339``).
* **7-scalar all-reduce.**  The merged CG's reduction hook is one
  all-reduce of its 7 sums an iteration (``poisson_operator.h:373-375``);
  the bottom plane of every rank above rank 0 (owned by the rank below)
  and the dummy planes get weight 0 in the local sums.

State invariant: plane Pp of rank r equals plane 0 of rank r + 1; every
update is elementwise, and the operator apply restores it after the halo
sum.  Ranks, their devices and the transport are :mod:`.comm`'s; the
fused solver's z-slab loop is :mod:`.dist_fused`'s.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any

import time

import numpy as np
import torch

from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import (cg_fused_kernel as fk, diagonal,
                                            geometry, lagrange, laplace_apply,
                                            laplace_cuda, laplace_structured)
from mf_data_locality_tpu_torch.parallel import comm as comm_mod
from mf_data_locality_tpu_torch.solvers import cg, cg_merged
from mf_data_locality_tpu_torch.solvers.cg import SolveResult

BACKENDS = ("pallas", "structured")
SOLVERS = ("merged", "baseline", "fused")
_TODO_9B = ("not ported yet: see ROADMAP.md, queue A item 9b (2D, 3D and "
            "2-level meshes, dist_general, --overlap, NCCL)")
# the kernel wrappers whose launches a rank counts
WRAPPERS = {"matvec": fk.matvec,
            "fused_cg_iteration": fk.fused_cg_iteration,
            "apply_local_batched_g": laplace_apply.apply_local_batched_g,
            "apply_local_batched_onthefly":
                laplace_apply.apply_local_batched_onthefly,
            "apply_lattice_pieces": laplace_apply.apply_lattice_pieces,
            "apply_lattice_zslab": laplace_apply.apply_lattice_zslab}


@dataclass(frozen=True)
class SlabProblem:
    """One rank's slab of the BP4 problem (the JAX ``DistributedBP4``'s
    per-device arrays), every tensor on the rank's device.

    ``op``: the slab's operator — ``laplace_cuda.OperatorData`` with
    ``slab=(z0, ncz_global)`` (``pallas``, dense factorization) or
    ``laplace_structured.StructuredOperatorData`` (``structured``), on
    (ncz_loc, ncy, ncx) cells and the slab's mask.  ``inv_diag`` (1,
    Pp+1, Ny, Nx), ``b`` (C, Pp+1, Ny, Nx) and ``weight`` (1, Pp+1, 1, 1):
    1 on owned planes, 0 on plane 0 above rank 0 and on dummy planes.
    """

    op: Any
    inv_diag: torch.Tensor
    b: torch.Tensor
    weight: torch.Tensor
    n_dofs: int   # the global problem's
    n_cells: int
    backend: str = "pallas"


def cells_per_slab(ncz: int, n_ranks: int) -> int:
    """z-cell layers a slab: ceil(ncz / n_ranks) (``_cells_per_slab``)."""
    return -(-ncz // n_ranks)


def check_distributed(solver: str, backend: str, windowing: str,
                      metric: str, overlap: bool = False) -> None:
    """Raise for what the z-slab path does not run: NotImplementedError
    for the JAX package's distributed forms not ported yet (``--overlap``,
    ``--backend general``; the meshes of 2 or more dimensions are
    ``dryrun``'s legs 5-8), ValueError for what the JAX CLI refuses
    too."""
    if overlap:
        raise NotImplementedError(f"--overlap is {_TODO_9B}")
    if backend == "general":
        raise NotImplementedError(
            f"--backend general with --devices (dist_general) is {_TODO_9B}")
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
    elif metric != "precomputed":
        raise ValueError(
            f"--solver {solver} --devices N cannot honor --geometry "
            f"{metric!r} (only the fused distributed path has the "
            f"in-kernel rebuild)")


def _layer_cells(mesh: BoxMesh, c0: int, c1: int) -> np.ndarray:
    """Trilinear coefficients (c1 - c0, ncy, ncx, 8, 3) of the global
    mesh's cell layers [c0, c1), from planes c0..c1 of its vertex lattice
    (the global lattice is (ncz+1)(ncy+1)(ncx+1) points, cheap even at the
    ladder's top; slicing it keeps every vertex the global build's, bit for
    bit, where mapping the planes alone would round some sines apart)."""
    _, ncy, ncx = mesh.n_cells_axis
    n = c1 - c0
    lat = mesh.vertex_lattice[c0:c1 + 1]
    verts = np.empty((n, ncy, ncx, 8, 3))
    for v in range(8):
        dx, dy, dz = v & 1, (v >> 1) & 1, (v >> 2) & 1
        verts[..., v, :] = lat[dz:dz + n, dy:dy + ncy, dx:dx + ncx, :]
    return geometry.trilinear_coefficients(verts)


def _dummy_cells(n: int, ncy: int, ncx: int) -> np.ndarray:
    """Unit-geometry dummy cells' coefficients (x = u, y = v, z = w)."""
    co = np.zeros((n, ncy, ncx, 8, 3))
    co[..., 1, 0] = co[..., 2, 1] = co[..., 4, 2] = 1.0
    return co


def slab_arrays(s: int, degree: int, rank: int, n_ranks: int,
                n_components: int = 3) -> dict[str, Any]:
    """Host arrays (f64 NumPy) of slab ``rank``: ``coeffs`` (ncz_loc, ncy,
    ncx, 8, 3) with dummy layers past the global top, ``mask``, ``inv_diag``
    (1, Pp+1, Ny, Nx), ``b`` (C, Pp+1, Ny, Nx), ``weight`` (1, Pp+1, 1,
    1), and the global mesh's sizes.  The values are the global problem's
    (``models/bp4.build``) on the slab's planes, zero on dummy planes."""
    mesh = BoxMesh.from_s(s)
    ncz, ncy, ncx = mesh.n_cells_axis
    p = degree
    L = cells_per_slab(ncz, n_ranks)
    Pp = L * p
    nz, ny, nx = (p * ncz + 1, p * ncy + 1, p * ncx + 1)
    c0 = rank * L
    real = max(0, min(c0 + L, ncz) - c0)
    co = _layer_cells(mesh, c0, c0 + real) if real else np.zeros(
        (0, ncy, ncx, 8, 3))
    co = np.concatenate([co, _dummy_cells(L - real, ncy, ncx)])

    zg = c0 * p + np.arange(Pp + 1)  # the slab's planes, global index
    live = zg < nz
    inner = (zg > 0) & (zg < nz - 1)
    yx = np.zeros((ny, nx), bool)
    yx[1:-1, 1:-1] = True
    mask = (inner[:, None, None] & yx[None]).astype(np.float64)

    # the preconditioner: the cells of layers [w0, w1) touch every plane
    # of the slab; their contributions summed in cell order, as the global
    # diagonal sums them
    inv = np.zeros((Pp + 1, ny, nx))
    w0, w1 = max(c0 - 1, 0), min(c0 + L + 1, ncz)
    if w0 < w1:
        win = DofLayout(BoxMesh((w1 - w0, ncy, ncx), mesh.spacing,
                                mesh.deformed, mesh.factor), p)
        diag = diagonal.summed_diagonal(
            win, _layer_cells(mesh, w0, w1).reshape(-1, 8, 3)).reshape(
            (w1 - w0) * p + 1, ny, nx)
        k = np.flatnonzero(live)
        d = diag[zg[k] - w0 * p]
        free = mask[k] > 0
        inv[k] = np.where(free, 1.0 / np.where(free, d, 1.0), 1.0)

    node = (zg[:, None, None] * ny + np.arange(ny)[None, :, None]) * nx \
        + np.arange(nx)[None, None, :]
    dof = node[None] * n_components + np.arange(n_components)[:, None, None,
                                                              None]
    b = (dof % 8).astype(np.float64) * (mask[None] > 0)

    weight = live.astype(np.float64)
    if rank > 0:
        weight[0] = 0.0
    return dict(coeffs=co, mask=mask[None], inv_diag=inv[None], b=b,
                weight=weight.reshape(1, Pp + 1, 1, 1),
                ncz_global=ncz, n_cells_axis=(L, ncy, ncx), z0=c0,
                n_dofs=nz * ny * nx * n_components, n_cells=mesh.n_cells)


def build_slab(s: int, degree: int, rank: int, n_ranks: int,
               dtype: torch.dtype = torch.float32, backend: str = "pallas",
               precision: str = "highest", windowing: str = "reshape",
               metric: str = "precomputed",
               device: torch.device | str = "cuda") -> SlabProblem:
    """Slab ``rank`` of BP4 on 2**s cells over ``n_ranks`` ranks
    (``build_distributed``): on ``pallas`` the dense factorization, the
    metric streamed or (the fused solver's ``metric="onthefly"``) rebuilt
    from the coefficients by adjj; ``dtype=torch.bfloat16`` is the fused
    solver's bf16 state (f32 tables; b and the preconditioner rounded to
    bf16 from f64, as the JAX slabs are)."""
    a = slab_arrays(s, degree, rank, n_ranks)
    p, q = degree, degree + 2
    co = a["coeffs"].reshape(-1, 8, 3)
    if backend == "structured":
        shape = lagrange.make_shape(p, q)
        w = shape.q_weights
        w3 = w[:, None, None] * w[None, :, None] * w[None, None, :]
        L, ncy, ncx = a["n_cells_axis"]

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x)).to(device=device,
                                                               dtype=dtype)

        op = laplace_structured.StructuredOperatorData(
            values=t(shape.values), d_col=t(shape.d_col),
            q_pts=t(shape.q_points), w3=t(w3.reshape(1, q, 1, q, 1, q)),
            coeffs=t(co.reshape(L, 1, ncy, 1, ncx, 1, 8, 3)),
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
            factor="dense", windowing=windowing,
            slab=(a["z0"], a["ncz_global"]))
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return _slab_problem(op, a, dtype, device, backend)


def _slab_problem(op, a: dict, dtype, device, backend: str) -> SlabProblem:
    vec = torch.float32 if dtype == torch.bfloat16 else op.dtype

    def t(x, to):
        return laplace_cuda.host_tensor(x).contiguous().to(device=device,
                                                           dtype=to)

    return SlabProblem(op=op, inv_diag=t(a["inv_diag"], dtype),
                       b=t(a["b"], dtype), weight=t(a["weight"], vec),
                       n_dofs=a["n_dofs"], n_cells=a["n_cells"],
                       backend=backend)


def _halo_sum(comm: comm_mod.Comm, v: torch.Tensor) -> torch.Tensor:
    """Complete the shared planes' partial sums (``_halo_sum``): the upper
    slab's plane-0 partial is added to this slab's top plane, and the
    completed top plane replaces the upper slab's stale plane 0."""
    recv = comm.shift([v[:, 0]], up=False)
    if recv is not None:
        v[:, -1] += recv[0]
    recv = comm.shift([v[:, -1]], up=True)
    if recv is not None:
        v[:, 0] = recv[0]
    return v


def _apply(op, u: torch.Tensor, backend: str) -> torch.Tensor:
    if backend == "pallas":
        return laplace_apply.apply_lattice(op, u)
    return laplace_structured.apply_lattice(op, u)


def dist_vmult(slab: SlabProblem, comm: comm_mod.Comm, u: torch.Tensor,
               constrained_identity: bool = True) -> torch.Tensor:
    """The operator on a slab vector (C, Pp+1, Ny, Nx) (``dist_vmult``,
    without ``overlap``): the masked local apply — B3 on the slab's cell
    batches (``reshape``), B5 or B6 with the slab's mask (``pieces``,
    ``zslab``), or the structured operator —, the halo sum (two shifts),
    the mask again; plus u at the constrained nodes when
    ``constrained_identity``."""
    mask = slab.op.mask
    raw = _halo_sum(comm, _apply(slab.op, u * mask, slab.backend))
    v = raw * mask
    if constrained_identity:
        v = v + u * (1.0 - mask)
    return v


def solve(slab: SlabProblem, comm: comm_mod.Comm, solver: str = "merged",
          max_iter: int = 100, rel_tol: float = 1e-8) -> SolveResult:
    """The rank's part of a distributed merged or baseline CG solve
    (``distributed.solve``); x is the rank's slab.  The merged solver makes
    one all-reduce an iteration (its 7 sums) and one for res0, beside the
    two shifts of each operator apply; the baseline solver one a dot
    product, 3 an iteration and 2 to start."""
    if slab.b.dtype == torch.bfloat16:
        raise NotImplementedError(
            f"the merged and baseline solvers with a bf16 state are "
            f"{laplace_cuda._BF16_STATE_TODO}")
    a = partial(dist_vmult, slab, comm,
                constrained_identity=(solver == "baseline"))
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


# ---------------------------------------------------------------------------
# runs on the ranks
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Job:
    """One distributed run, the same on every rank: the slab problem and
    what to do with it.

    ``solver``: ``"merged"``, ``"baseline"``, ``"fused"`` (a solve) or
    ``"matvec"`` (one :func:`dist_vmult` of b).  ``timed``: on a card, also
    the solve's time (minimum over ``solve_repeats``) and the operator's
    (``matvec_inner`` back-to-back applies, minimum over
    ``matvec_repeats``; the fused path with ``metric="onthefly"`` on its
    precomputed-metric twin, as the JAX ``run_one_distributed`` times
    it).  ``arrays``: per-rank arrays in place of the rank's own build
    (``models/bp4.slab_from_jax_arrays``'s keywords).
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
    arrays: tuple | None = field(default=None, compare=False)

    def build(self, rank: int, n_ranks: int,
              device: torch.device) -> SlabProblem:
        if self.arrays is not None:
            from mf_data_locality_tpu_torch.models import bp4

            return bp4.slab_from_jax_arrays(**self.arrays[rank],
                                            device=device)
        windowing = "pieces" if self.solver == "fused" else self.windowing
        return build_slab(self.s, self.degree, rank, n_ranks, self.dtype,
                          self.backend, self.precision, windowing,
                          self.metric, device)


def _launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def _zero_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def _run_job(comm: comm_mod.Comm, job: Job) -> dict[str, Any]:
    from mf_data_locality_tpu_torch.parallel import dist_fused
    from mf_data_locality_tpu_torch.utils import timing

    slab = job.build(comm.rank, comm.size, comm.device)
    if job.solver == "matvec":
        comm.reset()
        _zero_launches()
        v = dist_vmult(slab, comm, slab.b)
        return dict(x=v.cpu(), shifts=comm.shifts, launches=_launches())
    if job.solver == "fused":
        solve_fn = partial(dist_fused.solve_fused, slab, comm,
                           max_iter=job.max_iter, rel_tol=job.rel_tol)
    else:
        solve_fn = partial(solve, slab, comm, job.solver,
                           max_iter=job.max_iter, rel_tol=job.rel_tol)
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
    if job.timed:
        dev = comm.device
        out["solve_s"] = timing.time_per_call(solve_fn, dev,
                                              repeats=job.solve_repeats,
                                              warmup=0)
        mv = slab
        if job.solver == "fused" and job.metric == "onthefly":
            mv = build_slab(job.s, job.degree, comm.rank, comm.size,
                            job.dtype, "pallas", job.precision, "pieces",
                            "precomputed", dev)
        out["matvec_s"] = timing.time_per_call(
            lambda: dist_vmult(mv, comm, mv.b), dev, inner=job.matvec_inner,
            repeats=job.matvec_repeats)
        out["launches"] = _launches()
    return out


def run_jobs(comm: comm_mod.Comm, jobs: tuple[Job, ...]) -> list[dict]:
    """The rank target: every job in turn on this rank; a result dict a
    job (the rank's x slab, itCG, residual and history; of its first solve
    the collectives, the kernel launches, the host wall seconds and those
    in the collectives, ``Comm.seconds``; the times of a timed job)."""
    return [_run_job(comm, job) for job in jobs]


def launch(jobs, n_ranks: int, device: str = "cuda") -> list[dict]:
    """Run ``jobs`` on ``n_ranks`` rank processes (:func:`comm.run`); per
    job the ranks' results merged: ``x`` the global vector
    (:func:`gather_global`, dummy planes trimmed), ``it``, ``res``,
    ``history`` and ``converged`` of rank 0 (every rank's itCG must agree),
    ``ranks`` every rank's dict, and the slowest rank's times."""
    jobs = tuple(jobs)
    per_rank = comm_mod.run(run_jobs, n_ranks, (jobs,), device)
    out = []
    for j, job in enumerate(jobs):
        rs = [r[j] for r in per_rank]
        nz = BoxMesh.from_s(job.s).n_cells_axis[0] * job.degree + 1
        merged = dict(rs[0], ranks=rs,
                      x=gather_global([r["x"] for r in rs], nz))
        if job.solver != "matvec":
            its = {r["it"] for r in rs}
            if len(its) != 1:
                raise RuntimeError(f"the ranks disagree on itCG: {its}")
        for key in ("solve_s", "matvec_s"):
            if key in rs[0]:
                merged[key] = max(r[key] for r in rs)
        out.append(merged)
    return out

