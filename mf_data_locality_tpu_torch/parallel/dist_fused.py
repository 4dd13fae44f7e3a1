"""Distributed fused merged CG over z-slab ranks.

Counterpart of ``mf_data_locality_tpu.parallel.dist_fused`` (its z-slab
form, without ``overlap`` and ``x0``; the 2D, 3D and 2-level meshes are
ROADMAP.md queue A item 9b), the reference's merged solver in MPI
operation (``solver_cg_optimized.h:190-302`` with
``poisson_operator.h:327-377``).  Each rank keeps x, g, d, h as lattice
slabs (C, Pp+1, Ny, Nx) (:mod:`.distributed`'s layout) and owns the
planes [0, Pp): its top plane is a ghost of the upper rank's plane 0.  An
iteration's communication is exactly:

1. one downward shift of the upper rank's pre-update plane 0 of g, d and h
   (the ghost exchange of ``MatrixFree::cell_loop``), written into the
   ghost planes of the kernel's inputs;
2. one launch sequence of B2 in its slab form
   (``cg_fused_kernel.fused_cg_iteration`` on a slab operator: update4b,
   the operator, the 7 sums over the owned planes, raw), whose h' ghost
   plane is the partial sums owed upward;
3. one upward shift of that carry, added onto the upper rank's plane 0 of
   h' (the compress add-back); it arrives after the local sums were taken,
   so the five h-dependent sums are corrected exactly by single-plane terms
   (the JAX package's delta algebra, ``dist_fused.py:248-264``);
4. ONE all-reduce of the 7 sums (``poisson_operator.h:373-375``), then
   the scalar recurrence at torch level.
"""

from __future__ import annotations

import numpy as np
import torch

from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.parallel.comm import Comm
from mf_data_locality_tpu_torch.parallel.distributed import SlabProblem
from mf_data_locality_tpu_torch.solvers.cg import SolveResult, np_dtype


def _corrected(s: torch.Tensor, h0_old: torch.Tensor, h0_new: torch.Tensor,
               d0: torch.Tensor, g0: torch.Tensor,
               p0: torch.Tensor) -> torch.Tensor:
    """The 7 local sums with plane 0 of h' moved from ``h0_old`` (the
    slab's own partial) to ``h0_new`` (the carry added, as stored): d.h,
    h.h, g.h, g.Ph and h.Ph change by single-plane terms; d', g' and P of
    plane 0 after the update."""
    delta = h0_new - h0_old
    hsum = h0_new + h0_old
    return s + torch.stack([
        torch.sum(d0 * delta), torch.sum(hsum * delta),
        torch.sum(g0 * delta), torch.zeros_like(s[0]),
        torch.sum(g0 * (p0 * delta)), torch.sum(p0 * hsum * delta),
        torch.zeros_like(s[0]), torch.zeros_like(s[0])])


def solve_fused(slab: SlabProblem, comm: Comm, max_iter: int = 100,
                abs_tol: float = 1e-15, rel_tol: float = 1e-8
                ) -> SolveResult:
    """The rank's part of the distributed fused merged-CG solve
    (``solve_fused``): one B2 launch sequence, two shifts and one
    all-reduce an iteration, one all-reduce for res0 and a shift each for
    the preconditioner's ghost plane and x's top plane.  Returns x as the
    rank's slab, its top plane the upper rank's plane 0 (zero on the top
    rank), as :func:`~.distributed.gather_global` takes it.

    Each iteration is the wrapper of B2's slab form
    (``cg_fused_kernel.fused_cg_iteration`` on the slab operator: the
    kernel on the card, its plain version on the CPU).  With a bf16 ``b``
    (the bf16 rung's state) d and h are stored in bf16, as in the
    single-device solver; the carry is then h''s ghost plane as stored,
    rounded to bf16 (the JAX kernel sends it at f32 before the add-back
    rounds it), a second rounding of plane 0 of h above rank 0.
    """
    op = slab.op
    if op.slab is None or op.windowing != "pieces":
        raise ValueError("solve_fused needs a z-slab operator on "
                         "windowing='pieces' (distributed.build_slab)")
    dtype = op.dtype
    store = slab.b.dtype if slab.b.dtype == torch.bfloat16 else dtype
    nd = np_dtype(dtype)
    dev = slab.b.device
    work = fk.Workspace(op) if dev.type == "cuda" else None

    P = slab.inv_diag[:1].to(dtype, copy=True).contiguous()
    ghost = comm.shift([P[:, 0]], up=False)
    P[:, -1] = 0.0 if ghost is None else ghost[0]
    g0 = (-(slab.b.to(dtype) * op.mask)).contiguous()
    res0 = nd(torch.sqrt(comm.allreduce(
        torch.sum(g0[:, :-1] * g0[:, :-1])[None])[0]).item())
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
        halo = comm.shift([g[:, 0], d[:, 0], h[:, 0]], up=False)
        for v, plane in zip((g, d, h), halo or (0.0, 0.0, 0.0)):
            v[:, -1] = plane
        x2, g2, d2, h2, s = fk.fused_cg_iteration(op, x, g, d, h, scal, P,
                                                  out=spare, work=work)
        carry = comm.shift([h2[:, -1]], up=True)
        if carry is not None:
            h0_old = h2[:, 0].to(dtype, copy=True)
            h2[:, 0] = h0_old + carry[0].to(dtype)
            s = _corrected(s, h0_old, h2[:, 0].to(dtype), d2[:, 0].to(dtype),
                           g2[:, 0], P[:, 0])
        s = comm.allreduce(s)
        spare = (x, g, d, h, scal)
        scal = fk.scalar_recurrence(s, scal[0], scal[1], scal[4])
        state = [x2, g2, d2, h2]
        res = np.sqrt(np.maximum(nd(scal[5].item()), 0))
        history[it] = res

    x, g, d, _ = state
    x = fk.delayed_x_fixup(x, g, d.to(dtype), P, scal, it)
    top = comm.shift([x[:, 0]], up=False)
    x[:, -1] = 0.0 if top is None else top[0]
    return SolveResult(x, it, float(res), torch.as_tensor(history, device=dev),
                       bool(res <= tol))
