"""BP4 benchmark harness and CLI on a CUDA card.

The reference harness's protocol (``common_code/benchmark.h:50-318``): set
up one (p, s) point, time the CG solve (minimum over repeats) and the
operator apply (50 back-to-back applies, minimum over repeats), and print
the fixed-width result row::

   p |  q | n_element |     n_dofs |     time/it |   dofs/s/it | itCG | time/matvec

Usage (the reference's positional CLI, ``benchmark.h:280-288``)::

   python -m mf_data_locality_tpu_torch.benchmark <degree> [s] [compact] \
       [--solver merged|baseline|fused] [--precision highest|split2m] \
       [--windowing reshape|pieces|zslab] [--geometry auto|qpoint|onthefly] \
       [--dtype f32|f64]

The defaults are the JAX CLI's: the merged CG on the cell-batched operator
(``--windowing reshape``, kernel B3) at ``--precision highest``.  The
fused solver needs ``--windowing pieces`` and runs at degrees 1..4 on the
configurations the resolvers give it (``laplace_cuda.fused_configs``):
dense or twostage, the metric streamed or rebuilt (adjj), every pair under
``highest``, the dense pair and twostage + onthefly at p=4 under
``split2m``.  Other unported choices raise NotImplementedError
(ROADMAP.md, queues A and B): split2m twostage at p != 4 or with the
streamed metric, ``--cofactor jtj``, the split3 and bf16 rungs, p >= 5.
``s < 1`` runs the reference's auto size ladder.

The resolvers below are the JAX package's, verbatim.  Their speed
rationale was measured on a TPU and stands for the H100 only until
same-card A/Bs settle it; their convergence carve-outs hold on any device.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from dataclasses import dataclass

import torch

from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_cuda
from mf_data_locality_tpu_torch.solvers import cg_fused
from mf_data_locality_tpu_torch.utils import timing

DTYPES = {"f32": torch.float32, "f64": torch.float64}
HEADER = (" p |  q | n_element |     n_dofs |     time/it |   dofs/s/it |"
          " itCG | time/matvec")


@dataclass
class RunResult:
    degree: int
    n_q: int
    n_cells: int
    n_dofs: int
    time_per_it: float
    dofs_per_s_per_it: float
    n_iterations: int
    time_per_matvec: float
    converged: bool
    note: str = ""
    # the JAX harness's one-chain wall time per iteration; on the card the
    # solve is timed once per repeat, so it equals time_per_it
    time_per_it_wall: float = 0.0

    def row(self) -> str:
        return (f"{self.degree:2d} | {self.n_q:2d} |{self.n_cells:10d} "
                f"|{self.n_dofs:11d} | {self.time_per_it:.5e} | "
                f"{self.dofs_per_s_per_it:.5e} | {self.n_iterations:4d} | "
                f"{self.time_per_matvec:.5e}"
                + (f"   [{self.note}]" if self.note else ""))


def resolve_factor(factor: str, degree: int, windowing: str,
                   precision: str = "split2m",
                   solver: str = "fused",
                   metric: str = "auto") -> str:
    """Resolve factor='auto' to the measured-optimal contraction form.

    Dense MXU matmuls at low degree, the two-stage factorization (2D MXU
    stage + VPU z-stage, (p+1)x fewer FLOPs) where it measures faster:
    p >= 5 on every rung (tools/R3_BATCH1.txt, PROBE_TWOSTAGE.txt,
    PROBE_DISPATCH2.txt — the crossover holds under both geometry
    modes), plus p=4 on the f32-class split rungs, where
    twostage+onthefly won a 3-round interleaved A/B decisively
    (191.7 vs 211.3 us/it min, tools/PROBE_P4FACTOR.txt) and converges
    two iterations earlier at the convergent point (92 vs 94,
    PROBE_FOLLOWUP part A).  The bf16 rung keeps dense at p=4: there
    dense+onthefly measured 168.8 vs twostage 224.7 (PROBE_DISPATCH2
    part G) — the one-pass bf16 matmul is cheap enough that the
    twostage FLOP cut no longer pays for its extra VPU z-stage.
    """
    if factor != "auto":
        return factor
    if windowing != "pieces":
        return "dense"
    if degree >= 5:
        return "twostage"
    # NOT 'highest', NOT the non-fused solvers, and NOT an explicitly
    # requested precomputed stream: the p=4 twostage win is onthefly's
    # (resolve_metric engages the rebuild only on the fused pieces path)
    # — with the precomputed stream, p=4 dense measured faster
    # (R3_BATCH1 / PROBE_TWOSTAGE).  ``metric`` is the caller's REQUEST
    # ('auto'/'precomputed'/'onthefly'), consulted before resolve_metric
    # runs (which itself needs the resolved factor).
    if (degree == 4 and solver == "fused"
            and precision in ("split3", "split2m")
            and metric != "precomputed"):
        return "twostage"
    return "dense"


def resolve_metric(metric: str, solver: str, windowing: str, factor: str,
                   degree: int, n_q: int | None = None,
                   precision: str = "split2m") -> str:
    """Resolve metric='auto' to the measured-optimal geometry mode.

    'onthefly' (in-kernel Jacobian rebuild from 24 coefficients/cell —
    the reference's data-locality trade, ``poisson_operator.h:470-520``)
    wins on the fused pieces path at nearly every degree once odd-q
    sublane padding (``cg_fused_kernel._pad_row_blocks``) and the
    twostage per-qz rebuild are in: same-session A/Bs at the ladder max
    (tools/PROBE_DISPATCH.txt, PROBE_DISPATCH2.txt, PROBE_ODDQ.txt,
    PROBE_FOLLOWUP.txt) measure, time/iteration

      - split2m: p=2 115 vs 124-139, p=4 219-243 vs 273-277, p=5..11
        twostage 158-381 vs 274-700 -> onthefly;
      - bf16 rung: p=2 LOSES (159 vs 132 -> keep precomputed), p=4..11
        win (e.g. p=9 154 vs 227) -> onthefly for p >= 3 (twostage);
      - p=1 loses slightly on both rungs (92.6 vs 96.0) -> precomputed.

    CONVERGENCE carve-out: the DENSE rebuild with padded odd-q rows is
    the one config out of its iteration class — p=3 s=9 split2m hits the
    100-it cap unconverged vs f64's 95 while twostage+onthefly converges
    at 97 and dense+precomputed at 96 (tools/PROBE_PRODHIST.txt,
    PARITY.md shipping-config ladder).  Speed means nothing at +5
    iterations, so dense + odd q keeps the precomputed stream on every
    rung; in the factor-auto ladder this only affects p=3 (odd p >= 5
    ship twostage, whose per-qz rebuild stays in class).

    ``precision`` is the kernel matmul rung ('bf16'/'bf16sr' = the
    reduced bf16-stream rung; callers with ``dtype=bfloat16`` should pass
    'bf16' since split3/split2m degrade to one bf16 pass there).
    'highest' keeps the precomputed metric: the in-kernel Jacobian matmul
    runs as a split3 hi/lo bf16 pair on TPU (~1e-5-class geometry
    perturbation, measured 6-8e-6 max rel), which would silently weaken
    the exact-f32 contract —
    force --geometry onthefly to accept the trade.  ``n_q`` is the actual
    quadrature count when a caller overrides the q = p+2 reference
    default (benchmark.h:290-313); the dispatch is degree/rung-based
    (padding handles any q), so it is accepted for interface stability.
    """
    if metric != "auto":
        return metric
    if solver == "fused" and windowing == "pieces":
        q = n_q if n_q is not None else degree + 2
        dense_odd_q = factor == "dense" and q % 2 == 1
        if precision in ("bf16", "bf16sr"):
            return ("onthefly" if degree >= 3 and not dense_odd_q
                    else "precomputed")
        if precision in ("split3", "split2m"):
            return ("onthefly" if degree >= 2 and not dense_odd_q
                    else "precomputed")
    return "precomputed"


def resolve_cofactor(cofactor: str, degree: int, factor: str, metric: str,
                     precision: str = "split2m") -> str:
    """Resolve cofactor='auto' to the measured-optimal inversion chain.

    The on-the-fly rebuild's 3x3 inversion + metric assembly can run as
    the adjugate-of-J chain ('adjj', the reference's ``do_invert`` form,
    ``poisson_operator.h:27-63``) or as G = w adj(J^T J) rsqrt(det C)
    ('jtj') — mathematically identical (C^{-1} = J^{-1} J^{-T},
    det C = det(J)^2), ~12% fewer VPU ops, an rsqrt instead of a divide.
    Interleaved inner=50 slope A/Bs (tools/PROBE_R5_COFACTOR.txt,
    PROBE_R5_JTJ2.txt) measured jtj faster at every TWOSTAGE degree
    p >= 5 — trimmed means -3.6% (p=7) to -11% (p=6), neutral only at
    p=8 (+0.1%), and -7%/-4% on the bf16 rung at p=9 — but slower at
    p=4 twostage (+8..18%) and neutral on the dense path (p=2).
    Iteration histories at the convergent points are in class (itCG
    identical at p=4 s=7 and p=6 s=4, history dev <= 4e-2).  The
    precomputed-metric path has no inversion in-kernel — 'adjj' is
    returned as the inert default there.
    """
    if cofactor != "auto":
        return cofactor
    if metric != "onthefly" or factor != "twostage":
        return "adjj"
    return "jtj" if degree >= 5 else "adjj"


def resolve_config(degree: int, solver: str, windowing: str,
                   precision: str, dtype: torch.dtype, factor: str = "auto",
                   metric: str = "auto",
                   cofactor: str = "auto") -> tuple[str, str, str]:
    """(factor, metric, cofactor) as the JAX ``run_one(...,
    backend="pallas")`` resolves them; raises for a configuration the port
    lacks or the JAX CLI refuses."""
    factor = resolve_factor(factor, degree, windowing, precision=precision,
                            solver=solver, metric=metric)
    metric = resolve_metric(metric, solver, windowing, factor, degree,
                            precision=precision)
    cofactor = resolve_cofactor(cofactor, degree, factor, metric,
                                precision=precision)
    laplace_cuda.check_config(precision, factor, metric, cofactor, dtype,
                              windowing, solver, degree)
    return factor, metric, cofactor


def solver_call(problem: bp4.BP4Problem, solver: str):
    """A zero-argument call that solves ``problem`` with ``solver``: the
    merged or baseline CG on flat vectors, or the fused CG on the lattice."""
    if solver == "merged":
        return lambda: bp4.solve_merged(problem)
    if solver == "baseline":
        return lambda: bp4.solve_baseline(problem)
    lat = problem.lattice_shape
    b = problem.b.reshape(lat)
    prec = problem.inv_diag.reshape((1,) + lat[1:])
    return lambda: cg_fused.fused_merged_cg_solve(problem.op, lat[1:], b,
                                                  prec)


def run_one(degree: int, s: int, solver: str = "merged",
            dtype: torch.dtype = torch.float32, verbose: bool = False,
            precision: str = "highest", windowing: str = "reshape",
            factor: str = "auto", solve_repeats: int = 4,
            matvec_repeats: int = 2, matvec_inner: int = 50,
            metric: str = "auto", cofactor: str = "auto",
            device: torch.device | str = "cuda") -> RunResult:
    """Set up and time one (p, s) benchmark point (``benchmark.h:50-226``)
    on a CUDA ``device``; raises without one.

    The configuration resolves as the JAX package's ``run_one(...,
    backend="pallas")`` does.  The fused solver's kernels work on the
    lattice in place of the piece windowing; the merged and baseline
    solvers run on the apply family (B3-B6, ``ops/laplace_apply``).
    """
    factor, metric, cofactor = resolve_config(
        degree, solver, windowing, precision, dtype, factor, metric, cofactor)
    device = timing.require_cuda(device)

    setup_t0 = time.perf_counter()
    problem = bp4.build(s, degree, dtype=dtype, precision=precision,
                        factor=factor, metric=metric, cofactor=cofactor,
                        device=device, windowing=windowing)
    op = problem.op
    if verbose:
        # reference verbose mode: diagonal norm + setup time
        # (benchmark.h:149-154, 178-182)
        diag_norm = float(torch.linalg.norm(1.0 / problem.inv_diag))
        print(f"Norm of diagonal for preconditioner: {diag_norm:.6e}",
              file=sys.stderr)
        print(f"Setup time:         {time.perf_counter() - setup_t0:.3f}s",
              file=sys.stderr)

    # the operator's own matvec, applied back to back (benchmark.h:204-215):
    # the fused path's on the solver's lattice vectors; for merged and
    # baseline the full vmult on b, as the JAX run_one times it
    if solver == "fused":
        d = (problem.b.reshape(problem.lattice_shape) * op.mask).contiguous()
        h = torch.empty_like(d)
        work = fk.Workspace(op)
        matvec = lambda: fk.matvec(op, d, out=h, work=work)  # noqa: E731
    else:
        a_full = problem.a_apply_full
        matvec = lambda: a_full(problem.b)  # noqa: E731
    return _time_point(problem, solver_call(problem, solver), matvec, device,
                       verbose, solve_repeats, matvec_repeats, matvec_inner)


def _time_point(problem, solve, matvec, device, verbose: bool,
                solve_repeats: int, matvec_repeats: int,
                matvec_inner: int) -> RunResult:
    """Time the solve (minimum over repeats, after a warm-up solve that also
    gives the iteration count) and ``matvec_inner`` back-to-back matvecs."""
    result = solve()
    n_it = result.n_iterations
    solver_time = timing.time_per_call(solve, device, repeats=solve_repeats,
                                       warmup=0)
    matvec_time = timing.time_per_call(matvec, device, inner=matvec_inner,
                                       repeats=matvec_repeats)
    if verbose:
        hist = result.res_history[: n_it + 1].tolist()
        print(f"  solver residual history: {hist[:4]} ... {hist[-2:]}",
              file=sys.stderr)
    degree = problem.layout.degree
    return RunResult(
        degree=degree,
        n_q=degree + 2,
        n_cells=problem.layout.mesh.n_cells,
        n_dofs=problem.n_dofs,
        time_per_it=solver_time / max(n_it, 1),
        dofs_per_s_per_it=problem.n_dofs / solver_time * n_it,
        n_iterations=n_it,
        time_per_matvec=matvec_time,
        converged=result.converged,
        time_per_it_wall=solver_time / max(n_it, 1),
    )


def ladder_sizes(degree: int, n_components: int = 3,
                 n_devices: int = 1) -> list[int]:
    """The reference auto size ladder (``benchmark.h:243-257``)."""
    s = 1 + int(math.log2(n_devices))
    out = []
    while (degree + 1) ** 3 * (1 << s) * n_components < 6_000_000 * n_devices:
        out.append(s)
        s += 1
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("degree", type=int, nargs="?", default=1)
    ap.add_argument("s", type=int, nargs="?", default=-1,
                    help="mesh size exponent (2^s cells); <1 runs the ladder")
    ap.add_argument("compact", type=int, nargs="?", default=1)
    ap.add_argument("--solver", choices=["merged", "baseline", "fused"],
                    default="merged",
                    help="merged = 7-dot merged CG, baseline = textbook "
                         "PCG (both on the apply family); fused = one "
                         "fused-iteration kernel per CG iteration "
                         "(requires --windowing pieces)")
    ap.add_argument("--dtype", choices=list(DTYPES), default="f32")
    ap.add_argument("--precision", choices=["highest", "split2m"],
                    default="highest",
                    help="kernel matmul rung: highest = exact at the "
                         "working dtype; split2m = bf16-rounded matrices "
                         "with a hi/lo-split stream (f32 only)")
    ap.add_argument("--windowing", choices=["reshape", "pieces", "zslab"],
                    default="reshape",
                    help="lattice<->cell form: reshape = cell batches "
                         "(B3/B4), pieces = lattice apply with the mask "
                         "from indices (B5; the fused solver's), zslab = "
                         "lattice apply with the mask tensor (B6)")
    ap.add_argument("--geometry", choices=["auto", "qpoint", "onthefly"],
                    default="auto",
                    help="metric source: qpoint = streamed precomputed "
                         "metric, onthefly = rebuilt per q-point in the "
                         "kernel (B4 on reshape; either in the fused "
                         "solver)")
    ap.add_argument("--factor", choices=["auto", "dense", "twostage"],
                    default="auto",
                    help="contraction factorization: dense (the apply "
                         "family; the fused solver at p=1..4) or twostage "
                         "(the fused solver; under split2m at p=4 only)")
    ap.add_argument("--cofactor", choices=["auto", "adjj", "jtj"],
                    default="auto",
                    help="onthefly inversion chain; the port has adjj only")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if not 1 <= args.degree <= 11:
        raise SystemExit("Only degrees 1..11 implemented")  # benchmark.h:313
    sizes = [args.s] if args.s >= 1 else ladder_sizes(args.degree)
    print(HEADER)
    for s in sizes:
        r = run_one(args.degree, s, solver=args.solver,
                    dtype=DTYPES[args.dtype], verbose=not args.compact,
                    precision=args.precision, windowing=args.windowing,
                    factor=args.factor,
                    metric={"auto": "auto", "qpoint": "precomputed",
                            "onthefly": "onthefly"}[args.geometry],
                    cofactor=args.cofactor, device=args.device)
        print(r.row() + ("" if r.converged else "   [not converged]"))


if __name__ == "__main__":
    main()
