"""Baseline preconditioned conjugate gradient, and the solver result type.

The reference's ``benchmark_precond`` executable: stock deal.II ``SolverCG``
with ``ReductionControl(100, 1e-15, 1e-8)`` (``benchmark_precond/bench.cc:
4-25``), the textbook algorithm with 3 separate reductions and several vector
sweeps per iteration, kept un-merged as the comparison for :mod:`cg_merged`
(counterpart of ``mf_data_locality_tpu.solvers.cg``).

The loop runs on the host with the reference's condition ``(res > tol) &
(it < max_iter)``; the vector updates and dots stay on the device, and the
residual norm is read on the host once per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class SolveResult(NamedTuple):
    x: torch.Tensor            # solution, same shape as the right-hand side
    n_iterations: int
    res_norm: float            # final monitored residual norm (NaN on breakdown)
    res_history: torch.Tensor  # (max_iter + 1,) monitored norms; NaN where unused
    converged: bool


def _prec_apply(prec: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Node-blocked Jacobi: one diagonal entry per node, all components
    (``prec`` of shape (1, n_nodes) broadcast against (C, n_nodes))."""
    return prec * v




def np_dtype(dtype: torch.dtype):
    """The numpy type of the host-side residual history."""
    return np.float64 if dtype == torch.float64 else np.float32


def cg_solve(a_apply: Callable[[torch.Tensor], torch.Tensor],
             b: torch.Tensor, prec: torch.Tensor,
             x0: torch.Tensor | None = None, max_iter: int = 100,
             abs_tol: float = 1e-15, rel_tol: float = 1e-8,
             reduce_scalar: Callable[[torch.Tensor], torch.Tensor]
             | None = None,
             dot_weight: torch.Tensor | None = None) -> SolveResult:
    """Textbook PCG solving A x = b to ``max(abs_tol, rel_tol * ||r0||)``.

    ``a_apply`` must be symmetric positive definite on the masked subspace;
    ``b`` of shape (C, n_nodes); ``prec`` the inverse node diagonal,
    broadcastable against ``b``.  Iterations count as deal.II's
    ``ReductionControl`` does: the initial residual is step 0, each
    iteration adds one and is checked after the residual update.

    The distributed solve's hooks (``cg.py:49-50`` of the JAX package):
    ``reduce_scalar`` sums each local dot product over the ranks — one
    reduction a dot, three an iteration —, and ``dot_weight`` weights the
    local sums (0 on the planes another rank owns).

    A bf16 ``b`` is the bf16 state (``cg.py:65-101`` of the JAX package):
    p and Ap, the operator's input and output, are stored in bf16, p
    rounded where it is stored; x, r, z, the preconditioner, the dot
    products and the scalars are f32.
    """
    store = b.dtype
    acc = torch.float32 if store == torch.bfloat16 else store
    nd = np_dtype(acc)
    prec = prec.to(acc)

    def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        u, v = u.to(acc), v.to(acc)
        t = u * v if dot_weight is None else u * v * dot_weight
        s = torch.sum(t)
        return s if reduce_scalar is None else reduce_scalar(s[None])[0]
    x = (torch.zeros_like(b, dtype=acc) if x0 is None
         else x0.to(acc).clone())
    r = (b.to(acc) - a_apply(x.to(store)).to(acc) if x0 is not None
         else b.to(acc).clone())
    res0 = nd(torch.sqrt(_dot(r, r)).item())
    tol = max(nd(abs_tol), nd(rel_tol) * res0)
    history = np.full((max_iter + 1,), np.nan, nd)
    history[0] = res0

    z = _prec_apply(prec, r)
    p = z.to(store)
    rz = _dot(r, z)
    it, res = 0, res0
    while res > tol and it < max_iter:
        ap = a_apply(p)
        alpha = rz / _dot(p, ap)
        x = x + alpha * p.to(acc)
        r = r - alpha * ap.to(acc)
        res = nd(torch.sqrt(_dot(r, r)).item())
        z = _prec_apply(prec, r)
        rz_new = _dot(r, z)
        beta = rz_new / rz
        p = (z + beta * p.to(acc)).to(store)
        rz = rz_new
        it += 1
        history[it] = res
    return SolveResult(x, it, float(res),
                       torch.as_tensor(history, device=b.device),
                       bool(res <= tol))
