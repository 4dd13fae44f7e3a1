"""Solver result type shared by the CG solvers."""

from __future__ import annotations

from typing import NamedTuple

import torch


class SolveResult(NamedTuple):
    x: torch.Tensor            # solution, same shape as the right-hand side
    n_iterations: int
    res_norm: float            # final monitored residual norm (NaN on breakdown)
    res_history: torch.Tensor  # (max_iter + 1,) monitored norms; NaN where unused
    converged: bool
