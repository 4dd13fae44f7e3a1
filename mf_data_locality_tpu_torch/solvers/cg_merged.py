"""Fully merged conjugate gradient: one reduction of 7 scalars per iteration.

The reference's ``SolverCGFullMerge`` with ``do_cg_update3b/4b``
(``common_code/solver_cg_optimized.h:12-161,190-302``), counterpart of
``mf_data_locality_tpu.solvers.cg_merged``:

* all reduction data of an iteration comes from seven dot products over
  (g, d, h, prec);
* the new residual norm is estimated from them, ``||g + alpha h||^2 = s3 +
  2 alpha s2 + alpha^2 s1``, with no extra pass;
* x is updated every second iteration with the combined two-step
  coefficient, and the pending update is applied on exit for either parity;
* beta takes the Polak-Ribiere form ``alpha (s4 + alpha s5) / s6``.

State convention: ``g = A x - b`` (the reference's sign), direction d with
``x += alpha d``.  The loop runs on the host; vectors and scalars stay on
the device, and the residual estimate is read on the host once per
iteration.  In f64 the solve agrees with :func:`cg.cg_solve` to roundoff and
takes the same iterations — the reference's own invariant.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mf_data_locality_tpu_torch.solvers.cg import SolveResult, np_dtype


def merged_cg_solve(a_apply: Callable[[torch.Tensor], torch.Tensor],
                    b: torch.Tensor, prec: torch.Tensor,
                    x0: torch.Tensor | None = None, max_iter: int = 100,
                    abs_tol: float = 1e-15, rel_tol: float = 1e-8,
                    reduce_sums: Callable[[torch.Tensor], torch.Tensor]
                    | None = None,
                    dot_weight: torch.Tensor | None = None) -> SolveResult:
    """Solve A x = b with the fully merged CG.

    ``x0``: optional start; the initial residual is then ``g = A x0 - b``
    (``solver_cg_optimized.h:221-228``); ``None`` starts from g = -b with
    no operator apply.  Stops when the estimate drops to ``max(abs_tol,
    rel_tol * res0)`` or after ``max_iter`` iterations.

    The distributed solve's hooks (``cg_merged.py:52-53`` of the JAX
    package): ``reduce_sums`` sums the local sums over the ranks — the 7
    of an iteration in one call, and res0's —, so an iteration makes one
    reduction; ``dot_weight`` (broadcast against ``b``) weights every
    local sum, 0 on the planes another rank owns, so each global DoF
    counts once.

    A bf16 ``b`` is the bf16 state (``cg_merged.py:66-81`` of the JAX
    package): d and h, the operator's input and output, are stored in
    bf16, d' rounded where the update stores it; x, g, the
    preconditioner, every sum and the scalars are f32.
    """
    store = b.dtype
    acc = torch.float32 if store == torch.bfloat16 else store
    nd = np_dtype(acc)
    zero = torch.zeros((), dtype=acc, device=b.device)
    reduce_sums = reduce_sums or (lambda s: s)
    prec = prec.to(acc)

    def wsum(t):
        return torch.sum(t if dot_weight is None else t * dot_weight)

    def dots7(g, d, h):
        """The update3b sums (solver_cg_optimized.h:12-61), over the
        stored d and h."""
        d, h = d.to(acc), h.to(acc)
        ph, pg = prec * h, prec * g
        return reduce_sums(torch.stack([wsum(d * h), wsum(h * h),
                                        wsum(g * h), wsum(g * g),
                                        wsum(g * ph), wsum(h * ph),
                                        wsum(g * pg)]))

    def update4b(x, g, d, h, alpha, beta, alpha_old_eff, beta_old):
        """The vector updates before the sweep (solver_cg_optimized.h:
        65-161), the reference's three branches as one predicated sweep:
        first (alpha = 0), delayed (alpha_old = 0), steady."""
        is_pay = alpha_old_eff != 0
        safe_b = torch.where(beta_old == 0, torch.ones_like(beta_old),
                             beta_old)
        aob = torch.where(is_pay, alpha_old_eff / safe_b, zero)
        c1 = torch.where(is_pay, alpha + aob, zero)
        d, h = d.to(acc), h.to(acc)
        x2 = x + c1 * d + aob * (prec * g)
        g2 = g + alpha * h
        d2 = beta * d - prec * g2
        return x2, g2, d2.to(store)

    if x0 is None:
        g = -b.to(acc)
        x = torch.zeros_like(b, dtype=acc)
    else:
        x = x0.to(acc)
        g = a_apply(x.to(store)).to(acc) - b.to(acc)
    res0 = nd(torch.sqrt(reduce_sums(wsum(g * g)[None])[0]).item())
    tol = max(nd(abs_tol), nd(rel_tol) * res0)
    history = np.full((max_iter + 1,), np.nan, nd)
    history[0] = res0

    d, h = torch.zeros_like(b), torch.zeros_like(b)
    alpha = beta = alpha_old = beta_old = zero
    it, res = 0, res0
    while res > tol and it < max_iter:
        it += 1
        alpha_old_eff = alpha_old if it % 2 == 1 else zero
        x, g, d = update4b(x, g, d, h, alpha, beta, alpha_old_eff, beta_old)
        h = a_apply(d)
        s = dots7(g, d, h)
        alpha_old, beta_old = alpha, beta
        alpha = s[6] / s[0]
        res2 = s[3] + 2 * alpha * s[2] + alpha ** 2 * s[1]
        beta = alpha * (s[4] + alpha * s[5]) / s[6]
        res = nd(np.sqrt(max(nd(res2.item()), nd(0))))
        history[it] = res

    # delayed-x exit fixup (solver_cg_optimized.h:254-289): odd iteration
    # counts owe alpha d; even counts owe the combined two-step update
    d = d.to(acc)
    if it % 2 == 1:
        x = x + alpha * d
    elif it > 0:
        safe = torch.where(beta_old == 0, torch.ones_like(beta_old), beta_old)
        ab = alpha_old / safe
        x = x + (alpha + ab) * d + ab * (prec * g)
    return SolveResult(x, it, float(res),
                       torch.as_tensor(history, device=b.device),
                       bool(res <= tol))
