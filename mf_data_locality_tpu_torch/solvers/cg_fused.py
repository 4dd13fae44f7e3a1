"""Merged CG driven by the fused-iteration kernel.

The recurrence of the reference's merged CG (``solver_cg_optimized.h:
190-302``): each iteration is one call of
:func:`~mf_data_locality_tpu_torch.ops.cg_fused_kernel.fused_cg_iteration`
— update4b, the operator, the seven update3b sums and the scalar
recurrence in one pass over the state.  The state (x, g, d, h) is held as
lattice vectors in two sets of buffers that swap roles every iteration.

The loop runs on the host with the reference's condition
``(res > tol) & (it < max_iter)``; it reads the residual estimate from the
device once per iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops.laplace_cuda import OperatorData
from mf_data_locality_tpu_torch.solvers.cg import SolveResult, np_dtype


def fused_merged_cg_solve(op: OperatorData, n_nodes_axis, b: torch.Tensor,
                          prec: torch.Tensor, x0: torch.Tensor | None = None,
                          max_iter: int = 100, abs_tol: float = 1e-15,
                          rel_tol: float = 1e-8) -> SolveResult:
    """Solve A x = b for lattice vectors (C, Nz, Ny, Nx).

    ``prec``: (C or 1, Nz, Ny, Nx) inverse node diagonal; one scalar per
    node, shared by the components.  ``x0``: start vector, handled by
    solving the residual equation A dx = b - A x0 (one extra operator apply).

    Stops when the residual estimate drops to ``max(abs_tol, rel_tol *
    res0)`` or after ``max_iter`` iterations.  On breakdown (d.h = 0) the
    estimate is NaN and the solve stops with ``converged = False``.
    """
    if tuple(b.shape[1:]) != tuple(n_nodes_axis):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected (C,) + "
                         f"{tuple(n_nodes_axis)}")
    dtype = op.dtype
    nd = np_dtype(dtype)
    mask = op.mask
    work = fk.Workspace(op) if b.device.type == "cuda" else None

    b_eff = b.to(dtype)
    if x0 is not None:
        x0 = x0.to(dtype)
        b_eff = b_eff - fk.matvec(op, (x0 * mask).contiguous(), work=work)
    # the state vanishes on the boundary; Dirichlet rows are never re-masked
    b_eff = b_eff * mask
    P = prec[:1].to(dtype).contiguous()

    g0 = (-b_eff).contiguous()
    res0 = nd(torch.sqrt(torch.sum(g0 * g0)).item())
    tol = max(nd(abs_tol), nd(rel_tol) * res0)
    history = np.full((max_iter + 1,), np.nan, nd)
    history[0] = res0

    zeros = [torch.zeros_like(g0) for _ in range(3)]
    scal0 = torch.zeros((8,), dtype=dtype, device=b.device)
    scal0[4] = 1.0  # parity of iteration 1
    state = (zeros[0], g0, zeros[1], zeros[2], scal0)  # x, g, d, h, scal
    spare = tuple(torch.empty_like(t) for t in state)

    it, res = 0, res0
    while res > tol and it < max_iter:
        it += 1
        new = fk.fused_cg_iteration(op, *state, P, out=spare, work=work)
        state, spare = new, state
        res = np.sqrt(np.maximum(nd(state[4][5].item()), 0))
        history[it] = res

    x, g, d, _, scal = state
    x = fk.delayed_x_fixup(x, g, d, P, scal, it)
    if x0 is not None:
        x = x + x0
    return SolveResult(x, it, float(res),
                       torch.as_tensor(history, device=b.device),
                       bool(res <= tol))
