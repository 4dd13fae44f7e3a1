"""Distributed fused merged CG over z-slab and block ranks.

Counterpart of ``mf_data_locality_tpu.parallel.dist_fused`` (its z-slab
form with ``x0``, the 2-level grid of ``build_dist_fused_2level``, and the
(z, y) and (z, y, x) meshes of ``solve_fused_2d`` / ``_3d``; without
``overlap``), the reference's merged solver in MPI operation
(``solver_cg_optimized.h:190-302`` with ``poisson_operator.h:327-377``).
Each rank keeps x, g, d, h as its lattice block (C, Pz+1, Py+1, Px+1)
(:mod:`.distributed`'s layout; a z-slab is a block of a (N,) mesh) and owns
the nodes below its top face on each axis: on a split axis that face is a
ghost of the upper neighbour's face 0, on the others the Dirichlet face.
An iteration's communication is exactly:

1. the pre-kernel ghosts, axis by axis (z, then y, then x): one downward
   shift of the upper neighbour's pre-update face 0 of g, d and h (the
   ghost exchange of ``MatrixFree::cell_loop``), written into the ghost
   face of the kernel's inputs; each face is whole, the ghost rows that
   the earlier axes filled included, so edges and corners arrive;
2. one launch sequence of B2 in its block form
   (``cg_fused_kernel.fused_cg_iteration`` on a block operator:
   update4b, the operator, the 7 sums over the owned nodes, raw), whose
   h' ghost faces are the partial sums owed upward;
3. the carry, axis by axis: one upward shift of that axis's ghost face of
   h', added onto the upper neighbour's face 0 (the compress add-back); a
   face covers the owned rows of the axes done before it and the ghost rows
   of those after it, so an edge or corner sum passes on until it reaches
   its owner.  The carry arrives after the local sums were taken, so the
   five h-dependent sums are corrected exactly on each owned face that
   received one (the JAX package's delta algebra, ``dist_fused.py:248-264``
   on one plane, ``:424-468`` and ``:634-705`` on the y and x faces);
4. ONE all-reduce of the 7 sums over every rank (``poisson_operator.h:
   373-375``), then the scalar recurrence at torch level.

With k split axes (a z-slab: k = 1) an iteration makes 2k shifts and one
all-reduce; a solve adds k shifts for the preconditioner's ghost faces, k
for x's at exit and one all-reduce for res0.
"""

from __future__ import annotations

import numpy as np
import torch

from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.parallel.comm import Comm
from mf_data_locality_tpu_torch.parallel.distributed import (SlabProblem,
                                                             dist_vmult)
from mf_data_locality_tpu_torch.solvers.cg import SolveResult, np_dtype


def _corrected(s: torch.Tensor, h0_old: torch.Tensor, h0_new: torch.Tensor,
               d0: torch.Tensor, g0: torch.Tensor,
               p0: torch.Tensor) -> torch.Tensor:
    """The 7 local sums with the owned nodes of one face of h' moved from
    ``h0_old`` (the rank's own partial) to ``h0_new`` (the carry added, as
    stored): d.h, h.h, g.h, g.Ph and h.Ph change by terms on that face; d',
    g' and P there after the update."""
    delta = h0_new - h0_old
    hsum = h0_new + h0_old
    return s + torch.stack([
        torch.sum(d0 * delta), torch.sum(hsum * delta),
        torch.sum(g0 * delta), torch.zeros_like(s[0]),
        torch.sum(g0 * (p0 * delta)), torch.sum(p0 * hsum * delta),
        torch.zeros_like(s[0]), torch.zeros_like(s[0])])


def _face(dim: int, at: int, before: slice = slice(None),
          after: slice = slice(None)) -> tuple:
    """The index of face ``at`` along lattice dim ``dim`` of a (C, Z, Y, X)
    vector, ``before`` on the dims before it and ``after`` on those
    after."""
    return tuple(slice(None) if e == 0 else at if e == dim else
                 before if e < dim else after for e in range(4))


def _fill_ghosts(comm: Comm, vs, halo) -> None:
    """Write the upper neighbour's face 0 of each of ``vs`` into its ghost
    face, axis by axis of ``halo`` (one shift an axis); zero where there is
    no upper neighbour (the global top face, Dirichlet)."""
    for dim, axis in halo:
        recv = comm.shift([v.select(dim, 0) for v in vs], up=False,
                          axis=axis)
        for v, face in zip(vs, recv or (0.0,) * len(vs)):
            v[_face(dim, -1)] = face


def _carry(comm: Comm, halo, s: torch.Tensor, h2, d2, g2, P,
           dtype) -> torch.Tensor:
    """Add each ghost face of h' onto the upper neighbour's face 0, axis by
    axis of ``halo`` (one shift an axis), and correct the 7 sums on the
    owned part of every face that received a carry, [0, P) on the other two
    axes."""
    own = slice(0, -1)
    for dim, axis in halo:
        recv = comm.shift([h2[_face(dim, -1, own)]], up=True, axis=axis)
        if recv is None:
            continue
        face = _face(dim, 0, own)
        owned = _face(dim, 0, own, own)
        h0_old = h2[owned].to(dtype, copy=True)
        h2[face] = h2[face].to(dtype) + recv[0].to(dtype)
        s = _corrected(s, h0_old, h2[owned].to(dtype), d2[owned].to(dtype),
                       g2[owned], P[owned])
    return s


def solve_fused(slab: SlabProblem, comm: Comm,
                x0: torch.Tensor | None = None, max_iter: int = 100,
                abs_tol: float = 1e-15, rel_tol: float = 1e-8
                ) -> SolveResult:
    """The rank's part of the distributed fused merged-CG solve
    (``solve_fused``, ``solve_fused_2d``, ``solve_fused_3d``): per
    iteration one B2 launch sequence, 2k shifts and one all-reduce (the
    module's docstring).  Returns x as the rank's block, its ghost
    faces the upper neighbours' face 0 (zero at the global top), as
    :func:`~.distributed.gather_global` and ``gather_global_3d`` take it.

    ``x0``: a start, the rank's block of it (z-slabs on a 1-level grid only,
    as in the JAX package): the solve runs on the residual equation, one
    :func:`~.distributed.dist_vmult` at entry, and returns x + x0 (``dist_
    fused.py:134-144``).

    Each iteration is the wrapper of B2's block form
    (``cg_fused_kernel.fused_cg_iteration`` on the rank's operator: the
    kernel on the card, its plain version on the CPU).  With a bf16 ``b``
    (the bf16 rung's state) d and h are stored in bf16, as in the
    single-device solver; the carry is then h''s ghost face as stored,
    rounded to bf16 (the JAX kernel sends it at f32 before the add-back
    rounds it), a second rounding of face 0 of h above the first rank.
    """
    op = slab.op
    if op.slab is None or op.windowing != "pieces":
        raise ValueError("solve_fused needs a block operator on "
                         "windowing='pieces' (distributed.build_slab, "
                         "build_block)")
    halo = slab.halo
    if x0 is not None and halo != ((1, 0),):
        raise ValueError("x0 starts are supported on z-slabs of a 1-level "
                         "rank grid only (as in the JAX package)")
    dtype = op.dtype
    store = slab.b.dtype if slab.b.dtype == torch.bfloat16 else dtype
    nd = np_dtype(dtype)
    dev = slab.b.device
    work = fk.Workspace(op) if dev.type == "cuda" else None
    own = fk.OWNED

    P = slab.inv_diag[:1].to(dtype, copy=True).contiguous()
    _fill_ghosts(comm, [P], halo)
    b = slab.b.to(dtype)
    if x0 is not None:
        b = b - dist_vmult(slab, comm, x0, constrained_identity=False)
    g0 = (-(b * op.mask)).contiguous()
    res0 = nd(torch.sqrt(comm.allreduce(
        torch.sum(g0[own] * g0[own])[None])[0]).item())
    tol = max(nd(abs_tol), nd(rel_tol) * res0)
    history = np.full((max_iter + 1,), np.nan, nd)
    history[0] = res0

    scal = torch.zeros((8,), dtype=dtype, device=dev)
    scal[4] = 1.0  # parity of iteration 1
    state = [torch.zeros_like(g0), g0, torch.zeros_like(g0, dtype=store),
             torch.zeros_like(g0, dtype=store)]
    spare = tuple(torch.empty_like(t) for t in state) + (
        torch.empty_like(scal),)

    it, res = 0, res0
    while res > tol and it < max_iter:
        it += 1
        x, g, d, h = state
        _fill_ghosts(comm, [g, d, h], halo)
        x2, g2, d2, h2, s = fk.fused_cg_iteration(op, x, g, d, h, scal, P,
                                                  out=spare, work=work)
        s = _carry(comm, halo, s, h2, d2, g2, P, dtype)
        s = comm.allreduce(s)
        spare = (x, g, d, h, scal)
        scal = fk.scalar_recurrence(s, scal[0], scal[1], scal[4])
        state = [x2, g2, d2, h2]
        res = np.sqrt(np.maximum(nd(scal[5].item()), 0))
        history[it] = res

    x, g, d, _ = state
    x = fk.delayed_x_fixup(x, g, d.to(dtype), P, scal, it)
    _fill_ghosts(comm, [x], halo)
    if x0 is not None:
        x = x + x0
    return SolveResult(x, it, float(res), torch.as_tensor(history, device=dev),
                       bool(res <= tol))
