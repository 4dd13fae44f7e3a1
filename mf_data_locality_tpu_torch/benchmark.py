"""BP4 benchmark harness and CLI on a CUDA card.

The reference harness's protocol (``common_code/benchmark.h:50-318``): set
up one (p, s) point, time the CG solve (minimum over repeats) and the
operator apply (50 back-to-back applies, minimum over repeats), and print
the fixed-width result row::

   p |  q | n_element |     n_dofs |     time/it |   dofs/s/it | itCG | time/matvec

Usage (the reference's positional CLI, ``benchmark.h:280-288``)::

   python -m mf_data_locality_tpu_torch.benchmark <degree> [s] [compact] \
       [--solver merged|baseline|fused] \
       [--precision highest|split3|split2m|bf16] \
       [--windowing reshape|pieces|zslab] [--geometry auto|qpoint|onthefly] \
       [--dtype f32|f64|bf16] [--metric-dtype f32|bf16] \
       [--backend pallas|structured|general] [--prec-dtype f32|bf16] \
       [--x-dtype f32|bf16] [--devices N [--device cuda|cpu]]

The defaults are the JAX CLI's: the merged CG on the cell-batched operator
(``--windowing reshape``, kernel B3) at ``--precision highest``, at every
degree of the reference's table, 1..11.  The fused solver needs
``--windowing pieces`` and runs on the configurations the resolvers give
it (``laplace_cuda.fused_configs``): under ``highest`` (f32, f64) at
degrees 1..11 every (factor, metric) pair — dense or twostage, the metric
streamed or rebuilt by either chain, ``--cofactor adjj|jtj`` (the auto
path at p >= 5 is twostage + the streamed metric) —; under the
tensor-core rungs ``split2m``, ``split3`` and ``bf16`` the dense pair at
degrees 1..11 (adjj) and twostage with either metric at 4..11, the
rebuilt one by either chain (the auto path from p=5 is twostage +
onthefly + jtj); the merged and baseline solvers on every windowing at
every degree and rung.  ``--dtype bf16`` stores the solver's operator
stream in bf16 — d and h of the merged and fused solvers, p and Ap of the
baseline — with every solver, windowing and rung, on one device and on
the ranks, as the JAX package does (x, g and the sums at f32; the
configuration resolves as with the bf16 rung, the JAX ``run_one``'s
``eff_prec``, the operator keeping ``--precision``); ``--metric-dtype
bf16`` streams the metric in bf16 on every rung.  ``--prec-dtype bf16``
and ``--x-dtype bf16`` store the fused solver's preconditioner and
solution x in bf16, in every configuration, beside ``--dtype bf16`` and
``--metric-dtype bf16`` too.  ``--dtype f64 --precision
split2m`` runs every solver, windowing, geometry and fused configuration
on one device at every degree (the tensor-core passes' f64 form: the bf16
parts of f64 values, the products' sums in f64 for the merged and
baseline solvers' applies and in f32 for the fused solver's, as the JAX
package sums them).  ``--backend structured`` and
``--backend general`` run the merged and baseline solvers on the plain
lattice and gather/scatter operators (``ops/laplace_structured``,
``ops/laplace``); ``--precision``, ``--windowing`` and ``--geometry`` then
change nothing, as in the JAX single-device ``run_one``.  What the port
still lacks raises NotImplementedError naming its ROADMAP item, with no
fallback to another rung or to the plain version: ``--dtype f64`` with
split3, bf16 or ``--metric-dtype bf16``, with ``--devices N`` under a
tensor-core rung, and the fused solver's ``--prec-dtype``/``--x-dtype
bf16`` beside it on the card (queue B item 6h).  ``s < 1`` runs the
reference's auto size ladder.

``--devices N`` runs the merged, baseline or fused CG over N z-slab ranks
(:func:`run_one_distributed`, ``parallel/``): processes on the card(s)
joined by gloo, or with ``--device cpu`` on the CPU (the plain versions,
no times); the operator is the dense factorization (the fused solver's
metric streamed, or rebuilt with ``--geometry onthefly``), on every rung.
``--overlap`` overlaps the halo exchange with the interior cell layers'
compute (the merged and baseline solves and the matvec column; with
``--solver fused`` the matvec column only, as the JAX CLI, whose fused
solve takes no ``overlap``: ``parallel.dist_fused.solve_fused(...,
overlap=True)`` is the overlapped fused solve).  ``--backend general
--devices N`` runs the merged or baseline CG over N cell-chunk ranks
(``parallel/dist_general.py``).  The (z, y), (z, y, x) and 2-level rank
meshes, which the JAX CLI does not reach either, run through
``parallel.distributed.Job(mesh_shape=...)`` and ``parallel/dryrun.py``.

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

DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
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
                   metric: str = "auto", cofactor: str = "auto",
                   metric_dtype: torch.dtype | None = None
                   ) -> tuple[str, str, str]:
    """(factor, metric, cofactor) as the JAX ``run_one(...,
    backend="pallas")`` resolves them; raises for a configuration the port
    lacks or the JAX CLI refuses.  With a bf16 state the streamed operands
    are bf16 whatever the rung, so the dispatch sees the bf16 rung (the
    JAX ``run_one``'s ``eff_prec``)."""
    eff_prec = "bf16" if dtype == torch.bfloat16 else precision
    factor = resolve_factor(factor, degree, windowing, precision=eff_prec,
                            solver=solver, metric=metric)
    metric = resolve_metric(metric, solver, windowing, factor, degree,
                            precision=eff_prec)
    cofactor = resolve_cofactor(cofactor, degree, factor, metric,
                                precision=eff_prec)
    laplace_cuda.check_config(precision, factor, metric, cofactor, dtype,
                              windowing, solver, degree, metric_dtype)
    return factor, metric, cofactor


def solver_call(problem: bp4.BP4Problem, solver: str,
                prec_dtype: torch.dtype | None = None,
                x_dtype: torch.dtype | None = None):
    """A zero-argument call that solves ``problem`` with ``solver``: the
    merged or baseline CG on flat vectors, or the fused CG on the lattice
    (with P and x stored at ``prec_dtype``, ``x_dtype``)."""
    if solver == "merged":
        return lambda: bp4.solve_merged(problem)
    if solver == "baseline":
        return lambda: bp4.solve_baseline(problem)
    lat = problem.lattice_shape
    b = problem.b.reshape(lat)
    prec = problem.inv_diag.reshape((1,) + lat[1:])
    return lambda: cg_fused.fused_merged_cg_solve(
        problem.op, lat[1:], b, prec, prec_dtype=prec_dtype,
        x_dtype=x_dtype)


def check_problem(problem: bp4.BP4Problem, backend: str, factor: str,
                  metric: str, precision: str, cofactor: str) -> None:
    """Raise ValueError unless a prebuilt ``problem`` is the configuration
    the timings will be labelled with (the JAX ``run_one``'s checks, which
    it makes on the pallas backend; the backend itself too)."""
    if problem.backend != backend:
        raise ValueError(f"prebuilt problem has backend="
                         f"{problem.backend!r}, call passed {backend!r}")
    if backend != "pallas":
        return
    op = problem.op
    if op.factor != factor:
        raise ValueError(f"prebuilt problem has factor={op.factor!r}, call "
                         f"resolved {factor!r}")
    if op.metric != metric:
        raise ValueError(f"prebuilt problem geometry ({op.metric}) != "
                         f"call's resolved metric {metric!r}")
    if op.precision != precision:
        raise ValueError(f"prebuilt problem has precision="
                         f"{op.precision!r}, call passed {precision!r}")
    if op.cofactor != cofactor:
        raise ValueError(f"prebuilt problem has cofactor={op.cofactor!r}, "
                         f"call resolved {cofactor!r}")


def run_one(degree: int, s: int, solver: str = "merged",
            dtype: torch.dtype = torch.float32, verbose: bool = False,
            precision: str = "highest", windowing: str = "reshape",
            factor: str = "auto", solve_repeats: int = 4,
            matvec_repeats: int = 2, matvec_inner: int = 50,
            metric: str = "auto", cofactor: str = "auto",
            device: torch.device | str = "cuda",
            metric_dtype: torch.dtype | None = None,
            backend: str = "pallas", prec_dtype: torch.dtype | None = None,
            x_dtype: torch.dtype | None = None,
            problem: bp4.BP4Problem | None = None) -> RunResult:
    """Set up and time one (p, s) benchmark point (``benchmark.h:50-226``)
    on a CUDA ``device``; raises without one.

    The configuration resolves as the JAX package's ``run_one`` does.  The
    fused solver's kernels work on the lattice in place of the piece
    windowing; the merged and baseline solvers run on ``backend``'s
    operator: the apply family (B3-B6, ``ops/laplace_apply``) on
    ``"pallas"`` (the default here and in the JAX CLI), the plain lattice
    or gather/scatter operator on ``"structured"`` / ``"general"``, where
    ``precision``, ``windowing``, ``factor``, ``metric`` and ``cofactor``
    change nothing (the JAX ``bp4.build`` passes them to the pallas
    builder only) and the fused solver is refused.
    ``dtype=torch.bfloat16``: the bf16 state (d and h, the baseline's p
    and Ap) of every solver on every rung; ``metric_dtype``: the streamed
    metric's storage;
    ``prec_dtype``, ``x_dtype``: the fused solver's P and x storage.
    ``problem``: a prebuilt problem of the same configuration (ValueError
    where it is not, the JAX ``run_one``'s checks).
    """
    if backend not in bp4.BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if solver == "fused" and not (backend == "pallas"
                                  and windowing == "pieces"):
        raise ValueError("--solver fused requires --backend pallas "
                         "--windowing pieces")
    if backend == "pallas":
        factor, metric, cofactor = resolve_config(
            degree, solver, windowing, precision, dtype, factor, metric,
            cofactor, metric_dtype)
    if problem is not None:
        check_problem(problem, backend, factor, metric, precision, cofactor)
    device = timing.require_cuda(device)

    setup_t0 = time.perf_counter()
    if problem is None:
        problem = bp4.build(s, degree, dtype=dtype, precision=precision,
                            factor=factor, metric=metric, cofactor=cofactor,
                            device=device, windowing=windowing,
                            metric_dtype=metric_dtype, backend=backend)
    op = problem.op
    if verbose:
        # reference verbose mode: diagonal norm + setup time
        # (benchmark.h:149-154, 178-182)
        diag_norm = float(torch.linalg.norm(1.0 / problem.inv_diag.to(
            op.dtype)))
        print(f"Norm of diagonal for preconditioner: {diag_norm:.6e}",
              file=sys.stderr)
        print(f"Setup time:         {time.perf_counter() - setup_t0:.3f}s",
              file=sys.stderr)

    # the operator's own matvec, applied back to back (benchmark.h:204-215):
    # the fused path's on the solver's lattice vectors; for merged and
    # baseline the full vmult on b, as the JAX run_one times it
    if solver == "fused":
        d = (problem.b.reshape(problem.lattice_shape) * op.mask).to(
            problem.b.dtype).contiguous()
        h = torch.empty_like(d)
        work = fk.Workspace(op, d.shape[0])
        matvec = lambda: fk.matvec(op, d, out=h, work=work)  # noqa: E731
    else:
        a_full = problem.a_apply_full
        matvec = lambda: a_full(problem.b)  # noqa: E731
    return _time_point(problem,
                       solver_call(problem, solver, prec_dtype, x_dtype),
                       matvec, device, verbose, solve_repeats,
                       matvec_repeats, matvec_inner)


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
        n_q=problem.n_q,
        n_cells=problem.layout.mesh.n_cells,
        n_dofs=problem.n_dofs,
        time_per_it=solver_time / max(n_it, 1),
        dofs_per_s_per_it=problem.n_dofs / solver_time * n_it,
        n_iterations=n_it,
        time_per_matvec=matvec_time,
        converged=result.converged,
        time_per_it_wall=solver_time / max(n_it, 1),
    )


def run_one_distributed(degree: int, s: int, n_devices: int,
                        solver: str = "merged",
                        dtype: torch.dtype = torch.float32,
                        backend: str = "pallas", overlap: bool = False,
                        precision: str = "highest",
                        windowing: str = "reshape", solve_repeats: int = 4,
                        matvec_repeats: int = 2, matvec_inner: int = 50,
                        metric: str = "auto",
                        device: torch.device | str = "cuda"
                        ) -> tuple[RunResult, dict]:
    """The distributed solve and matvec over ``n_devices`` z-slab ranks
    (``run_one_distributed`` of the JAX package; ``parallel/``): one
    7-scalar all-reduce a merged or fused iteration, the halo shifts in
    the operator.  The fused solver runs on dense slab operators, the
    metric streamed (``metric="auto"``) or rebuilt (``"onthefly"``; its
    matvec column then times the streamed-metric twin, as the JAX harness
    does).  Returns the result row and the ranks' merged results
    (``parallel.distributed.launch``: x, history, collectives and
    launches per rank, ``transport``).

    On a CUDA ``device`` the ranks share the card(s) and the times are
    the slowest rank's CUDA-event times; ``device="cpu"`` runs the ranks'
    plain versions on the CPU and measures no time (the row's times are
    NaN).  ``overlap``, as the JAX harness (``mf_data_locality_tpu/
    benchmark.py:391, 460, 475, 568``): the merged and baseline solves
    and the matvec column boundary-first (``distributed.dist_vmult``); with
    the fused solver the matvec column only (its solve takes none there,
    ``:432``).  ``backend="general"``: the merged or baseline solver over
    cell-chunk ranks (``parallel/dist_general.py``; ``overlap`` raises
    ValueError there, which the JAX harness ignores).
    """
    from mf_data_locality_tpu_torch.parallel import comm, distributed

    if solver == "fused":
        metric = "precomputed" if metric == "auto" else metric
        windowing = "pieces"
    elif metric == "auto":
        metric = "precomputed"
    distributed.check_distributed(solver, backend, windowing, metric,
                                  overlap)
    if backend == "pallas":
        laplace_cuda.check_config(precision, "dense", metric, "adjj", dtype,
                                  windowing, solver, degree)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        timing.require_cuda(device)
    job = distributed.Job(solver, s, degree, dtype, backend, precision,
                          windowing, metric, timed=cuda,
                          solve_repeats=solve_repeats,
                          matvec_repeats=matvec_repeats,
                          matvec_inner=matvec_inner,
                          overlap=overlap and solver != "fused",
                          overlap_matvec=overlap)
    out = distributed.launch([job], n_devices, str(device))[0]
    out["transport"] = comm.describe(n_devices, str(device))
    return dist_row(job, out), out


def dist_row(job, out: dict) -> RunResult:
    """The result row of a distributed ``job``
    (``parallel.distributed.Job``) from its merged rank results: the
    slowest rank's times, or NaN where the job was not timed (CPU ranks,
    which have no device time, or a drive run untimed)."""
    n_it = out["it"]
    nan = float("nan")
    solve_s = out.get("solve_s", nan)
    notes = ([] if job.timed else ["times not measured"]) + (
        ["matvec: precomputed-metric twin"]
        if job.solver == "fused" and job.metric == "onthefly" else [])
    n_dofs, n_cells = out["n_dofs"], out["n_cells"]
    return RunResult(
        degree=job.degree, n_q=job.degree + 2, n_cells=n_cells,
        n_dofs=n_dofs, time_per_it=solve_s / max(n_it, 1),
        dofs_per_s_per_it=n_dofs / solve_s * n_it,
        n_iterations=n_it, time_per_matvec=out.get("matvec_s", nan),
        converged=out["converged"], note="; ".join(notes),
        time_per_it_wall=solve_s / max(n_it, 1))


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
    ap.add_argument("--dtype", choices=list(DTYPES), default="f32",
                    help="vector storage: bf16 stores the operator stream "
                         "(d and h; the baseline's p and Ap) in bf16 with "
                         "every solver and rung, x, g and the sums at f32")
    ap.add_argument("--precision",
                    choices=["highest", "split3", "split2m", "bf16"],
                    default="highest",
                    help="kernel matmul rung: highest = exact at the "
                         "working dtype; split3 = bf16 hi/lo matrices and "
                         "stream, three products; split2m = bf16-rounded "
                         "matrices with a hi/lo-split stream; bf16 = one "
                         "product of bf16-rounded operands (the three f32 "
                         "only)")
    ap.add_argument("--metric-dtype", choices=["f32", "bf16"], default="f32",
                    help="storage dtype of the precomputed metric stream "
                         "(bf16: every rung)")
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
                         "family, or the fused solver) or twostage (the "
                         "fused solver; under split2m from p=4)")
    ap.add_argument("--cofactor", choices=["auto", "adjj", "jtj"],
                    default="auto",
                    help="onthefly inversion chain of the fused solver "
                         "(under split2m jtj in twostage only; B4 always "
                         "runs adjj)")
    ap.add_argument("--backend", choices=list(bp4.BACKENDS),
                    default="pallas",
                    help="operator of the merged and baseline solvers: "
                         "pallas = the kernels (B3-B6), structured = the "
                         "plain lattice operator, general = the plain "
                         "gather/scatter operator (the fused solver needs "
                         "pallas)")
    ap.add_argument("--prec-dtype", choices=["f32", "bf16"], default="f32",
                    help="fused solver: storage of the preconditioner "
                         "(bf16 = ~0.4%% Jacobi perturbation)")
    ap.add_argument("--x-dtype", choices=["f32", "bf16"], default="f32",
                    help="fused solver: storage of the solution x only "
                         "(bf16 halves x's traffic; the residual history "
                         "is unchanged, the delivered x is rounded)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (with --devices: the "
                         "ranks' plain versions on the CPU, no times)")
    ap.add_argument("--devices", type=int, default=0,
                    help="distribute over N z-slab ranks, processes on "
                         "the card(s) joined by gloo (0 = the "
                         "single-device path)")
    ap.add_argument("--overlap", action="store_true",
                    help="overlap the halo exchange with interior compute "
                         "(--devices N on z-slabs: the merged and baseline "
                         "solves and the matvec column; with --solver "
                         "fused the matvec column only, as the JAX CLI)")
    args = ap.parse_args(argv)

    if not 1 <= args.degree <= 11:
        raise SystemExit("Only degrees 1..11 implemented")  # benchmark.h:313
    metric = {"auto": "auto", "qpoint": "precomputed",
              "onthefly": "onthefly"}[args.geometry]
    if args.devices > 0:
        single = [f"--{k.replace('_', '-')}" for k, default in (
            ("factor", "auto"), ("cofactor", "auto"), ("metric_dtype", "f32"),
            ("prec_dtype", "f32"), ("x_dtype", "f32"))
            if getattr(args, k) != default]
        if single:
            raise SystemExit(f"{', '.join(single)}: the single-device "
                             f"path's options; the distributed path "
                             f"runs the dense factorization (adjj)")
    sizes = ([args.s] if args.s >= 1 else
             ladder_sizes(args.degree, n_devices=max(args.devices, 1)))
    if args.devices > 0:
        from mf_data_locality_tpu_torch.parallel import comm

        print(f"transport: {comm.describe(args.devices, args.device)}")
    print(HEADER)
    for s in sizes:
        if args.devices > 0:
            r, _ = run_one_distributed(
                args.degree, s, args.devices, solver=args.solver,
                dtype=DTYPES[args.dtype], backend=args.backend,
                overlap=args.overlap, precision=args.precision,
                windowing=args.windowing, metric=metric, device=args.device)
            print(r.row() + ("" if r.converged else "   [not converged]"))
            continue
        if args.overlap:
            raise SystemExit("--overlap needs --devices N")
        r = run_one(args.degree, s, solver=args.solver,
                    dtype=DTYPES[args.dtype], verbose=not args.compact,
                    precision=args.precision, windowing=args.windowing,
                    factor=args.factor, metric=metric,
                    cofactor=args.cofactor, device=args.device,
                    metric_dtype=(torch.bfloat16 if args.metric_dtype == "bf16"
                                  else None),
                    backend=args.backend,
                    prec_dtype=(torch.bfloat16 if args.prec_dtype == "bf16"
                                else None),
                    x_dtype=(torch.bfloat16 if args.x_dtype == "bf16"
                             else None))
        print(r.row() + ("" if r.converged else "   [not converged]"))


if __name__ == "__main__":
    main()
