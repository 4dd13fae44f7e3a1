"""Merged CG driven by the fused-iteration kernel.

The recurrence of the reference's merged CG (``solver_cg_optimized.h:
190-302``): each iteration is one call of
:func:`~mf_data_locality_tpu_torch.ops.cg_fused_kernel.fused_cg_iteration`
— update4b, the operator, the seven update3b sums and the scalar
recurrence in one pass over the state.  The state (x, g, d, h) is held as
lattice vectors in two sets of buffers that swap roles every iteration;
with a bf16 ``b`` (``bp4.build(dtype=torch.bfloat16)``, the ``bf16`` rung)
d and h are stored in bf16 and x, g, the preconditioner and the scalars
at the operator's f32 (``solvers/cg_fused.py:127-140`` of the JAX
package).  ``prec_dtype`` and ``x_dtype`` store the preconditioner and the
solution x in bf16 in any configuration (``cg_fused.py:57-70``): upcast
where they are read, x rounded where it is stored.

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
                          rel_tol: float = 1e-8, iteration=None,
                          prec_dtype: torch.dtype | None = None,
                          x_dtype: torch.dtype | None = None) -> SolveResult:
    """Solve A x = b for lattice vectors (C, Nz, Ny, Nx).

    ``prec``: (C or 1, Nz, Ny, Nx) inverse node diagonal; one scalar per
    node, shared by the components.  ``x0``: start vector, handled by
    solving the residual equation A dx = b - A x0 (one extra operator apply).

    Stops when the residual estimate drops to ``max(abs_tol, rel_tol *
    res0)`` or after ``max_iter`` iterations.  On breakdown (d.h = 0) the
    estimate is NaN and the solve stops with ``converged = False``.

    ``iteration``: one iteration, ``(op, x, g, d, h, scal, prec) -> (x',
    g', d', h', scal')``; by default the kernel's wrapper
    :func:`~mf_data_locality_tpu_torch.ops.cg_fused_kernel.fused_cg_iteration`
    (a check passes its plain version, ``_fused_iteration_plain``).

    ``prec_dtype``: the preconditioner's storage (None: the working
    dtype; bf16 perturbs the Jacobi diagonal by ~0.4%, and the kernel
    upcasts it at the load).  ``x_dtype``: the storage of x alone (None:
    the working dtype; bf16 halves x's traffic): x feeds none of the g, d,
    h recurrences, so the residual history is unchanged and only the
    delivered x is rounded, each pay iteration.  The returned x is at the
    working dtype (the exit fixup adds the pending update to the stored x).
    """
    if tuple(b.shape[1:]) != tuple(n_nodes_axis):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected (C,) + "
                         f"{tuple(n_nodes_axis)}")
    dtype = op.dtype
    store = b.dtype if b.dtype == torch.bfloat16 else dtype  # d and h
    for name, t in (("prec_dtype", prec_dtype), ("x_dtype", x_dtype)):
        if t not in (None, dtype, torch.bfloat16):
            raise ValueError(f"{name}={t}: the kernels store it at {dtype} "
                             f"or in bf16")
    nd = np_dtype(dtype)
    mask = op.mask
    work = (fk.Workspace(op, b.shape[0]) if b.device.type == "cuda"
            else None)

    b_eff = b.to(dtype)
    if x0 is not None:
        x0 = x0.to(dtype)
        b_eff = b_eff - fk.matvec(op, (x0 * mask).to(store).contiguous(),
                                  work=work).to(dtype)
    # the state vanishes on the boundary; Dirichlet rows are never re-masked
    b_eff = b_eff * mask
    P = prec[:1].to(dtype).to(prec_dtype or dtype).contiguous()

    g0 = (-b_eff).contiguous()
    res0 = nd(torch.sqrt(torch.sum(g0 * g0)).item())
    tol = max(nd(abs_tol), nd(rel_tol) * res0)
    history = np.full((max_iter + 1,), np.nan, nd)
    history[0] = res0

    scal0 = torch.zeros((8,), dtype=dtype, device=b.device)
    scal0[4] = 1.0  # parity of iteration 1
    state = (torch.zeros_like(g0, dtype=x_dtype or dtype),  # x, g, d, h, scal
             g0, torch.zeros_like(g0, dtype=store),
             torch.zeros_like(g0, dtype=store), scal0)
    spare = tuple(torch.empty_like(t) for t in state)

    it, res = 0, res0
    while res > tol and it < max_iter:
        it += 1
        new = (fk.fused_cg_iteration(op, *state, P, out=spare, work=work)
               if iteration is None else iteration(op, *state, P))
        state, spare = new, state
        res = np.sqrt(np.maximum(nd(state[4][5].item()), 0))
        history[it] = res

    x, g, d, _, scal = state
    x = fk.delayed_x_fixup(x, g, d.to(dtype), P, scal, it)
    if x0 is not None:
        x = x + x0
    return SolveResult(x, it, float(res),
                       torch.as_tensor(history, device=b.device),
                       bool(res <= tol))
