#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits nonzero):

1. require a CUDA device; print the card's name and power limit;
2. build the kernels from ``mf_data_locality_tpu_torch/csrc`` with nvcc;
3. compare each kernel with its plain PyTorch version on the same inputs,
   and time both beside the bound of its work: at the main paths' size
   (p=4, 2^13 cells, 1,635,075 DoFs) B1/B2 twostage + onthefly (f32 split2m
   — the tensor-core cell pass —, f32 highest and f64 — the sum-factorized
   pass with the metric rebuilt) and B3-B6 (f32 highest — the
   sum-factorized pass, B4's with the metric rebuilt —, f32 split2m except
   B4 — the tensor-core pass of B3/B5/B6 —, f64 highest); B1/B2 in each
   dense configuration of DENSE_RUNS at the p and s of its drive in phase
   5 (dense + precomputed under f32 and f64 highest — the sum-factorized
   pass, the metric streamed —, under f32 split2m at p=1, 3 — the dense
   tensor-core pass, the metric streamed —, dense + onthefly under f32
   split2m at p=2 and p=4 — the same pass, the metric rebuilt);
4. convergence class at p=4, s=7: f64 "highest" must take 91 iterations —
   fused, merged (streamed metric and ``metric="onthefly"``) and baseline
   alike — f32 "split2m" (fused; merged with ``--windowing reshape``) and
   f32 "highest" (fused, merged, baseline) 91..94 and converge; and the
   fused solver through the auto-dispatch at the parity points of
   PARITY.md:91-123: f64 p=2 s=11 87 and p=4 s=7 91 (equal to the merged
   solver's), p=3 s=9 94..95 (on the tolerance's edge); f32 split2m p=2
   s=11 87..90, p=3 s=9 94..98 converged, or, where the rung's floor lies
   above the tolerance, at the cap within 10x the tolerance by the f64
   count with ``edge_witness`` showing the kernel's sums right; f32
   highest the f64 count + 0..3;
5. the paths, each with the kernels' launch counters zeroed just before and
   read just after:
   - the fused path ``benchmark.run_one(4, 13, solver="fused",
     precision="split2m", windowing="pieces")`` (B1, B2);
   - the JAX CLI's default path ``benchmark.run_one(4, 13,
     solver="merged", windowing="reshape", precision="highest")`` (B3);
   - the same path under f32 split2m ``benchmark.run_one(4, 13,
     solver="merged", windowing="reshape", precision="split2m")`` (B3 on
     the tensor cores);
   - the fused solver in each dense configuration of DENSE_RUNS at its p
     and s, through the auto-dispatch except split2m at p=4: at full width
     ``run_one(4, 13, solver="fused", windowing="pieces",
     precision="highest")`` (dense + precomputed) and ``run_one(2, 16, ...,
     precision="split2m")`` (dense + onthefly), the others short;
   - short runs at s=11 of the baseline solver (B3), ``--geometry
     onthefly`` (B4), ``--windowing pieces`` (B5) and ``zslab`` (B6),
     ``zslab`` under split2m (B6 on the tensor cores), and the fused solver
     under f32 highest (B1, B2 on the sum-factorized pass);
   then the solutions of the three p=4 s=13 paths are checked for shape,
   finiteness, and their true residual against the solver's estimate;
6. print the kernels' JSON line (B1/B2 at f32 split2m, also with their f32
   highest and f64 times and, for each dense configuration, fields with
   its suffix — ``ms_dense``, ``launches_dense_split2m_p3``, ... — and its
   ``p_s``; B3-B6 at f32 highest, also with their f64 and (B3/B5/B6)
   split2m times; each row with the bound of its work on this card, from
   the shapes) and, last, the device JSON line.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import torch

DEGREE, S, S_SHORT = 4, 13, 11
CSRC = "mf_data_locality_tpu_torch/csrc/"
# tolerances of kernel vs plain version (max |diff| / max |plain|): the two
# sum in different orders; f32 sums of ~2e2-term (B1/B2) and ~6e2-term
# (B3-B6) contractions and, for the scalars, of ~5e6 dot-product terms
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
TOL_SCAL_F32 = 1e-4
# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores, f32 and
# f64 CUDA cores, HBM3
PEAK_BF16, PEAK_F32, PEAK_F64, HBM_BPS = 989e12, 67e12, 34e12, 3.35e12
METRIC_FMA = 117  # adjj rebuild per q-point: J 72, adjugate 21, entries 24
# the fused solver's configuration at p=4 under split2m (B1, B2), and its
# dense configurations (the auto-dispatch's under highest, and at p=2 under
# split2m)
FUSED = dict(factor="twostage", metric="onthefly", windowing="pieces")
DENSE_PRE = dict(factor="dense", metric="precomputed", windowing="pieces")
DENSE_OTF = dict(factor="dense", metric="onthefly", windowing="pieces")
# B1/B2 in the dense configurations: (dtype, precision, configuration, p, s,
# key suffix in the kernels line).  Phase 3 compares and times each at its
# p and s; phase 5 drives the fused solver in the same configuration at the
# same p and s, and that drive's counts are the row's launches.  The first
# two are the auto-dispatch's full-width paths; "_dense_split2m_p4" is
# explicit (split2m auto at p=4 is twostage), the others auto.
DENSE_RUNS = ((torch.float32, "highest", DENSE_PRE, 4, S, "_dense"),
              (torch.float32, "split2m", DENSE_OTF, 2, 16, "_dense_split2m"),
              (torch.float64, "highest", DENSE_PRE, 4, S, "_dense_f64"),
              (torch.float32, "split2m", DENSE_OTF, 4, S, "_dense_split2m_p4"),
              (torch.float32, "split2m", DENSE_PRE, 1, S_SHORT,
               "_dense_split2m_p1"),
              (torch.float32, "split2m", DENSE_PRE, 3, S_SHORT,
               "_dense_split2m_p3"),
              (torch.float64, "highest", DENSE_PRE, 1, S_SHORT, "_dense_f64_p1"),
              (torch.float64, "highest", DENSE_PRE, 3, S_SHORT, "_dense_f64_p3"))
FULL_WIDTH = ("_dense", "_dense_split2m")
# B1/B2 runs of phase 3: the twostage + onthefly ones fill the row's own
# fields (split2m) and its "_highest" and "_f64" ones
FUSED_RUNS = ((torch.float32, "split2m", FUSED, DEGREE, S, ""),
              (torch.float32, "highest", FUSED, DEGREE, S, "_highest"),
              (torch.float64, "highest", FUSED, DEGREE, S, "_f64"),
              *DENSE_RUNS)


def sumfac_fma(p: int, q: int) -> int:
    """FMAs of the sum-factorized apply a cell, three components: forward
    x pass (S, D), y pass (3), z pass (3), and the same backward."""
    p1 = p + 1
    return 3 * 2 * (2 * p1 ** 3 * q + 3 * p1 ** 2 * q ** 2 + 3 * p1 * q ** 3)


def bound(name: str, op, split: bool) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for the
    kernel's work on ``op``'s shapes — the larger of its bytes (inputs read
    once, outputs written once) over HBM_BPS and its operations over the
    peak of their type (under split2m the products on the tensor cores in
    bf16, counting both stream parts, the rest in f32; else all at the
    working type).  The products: under split2m the dense count (B3-B6,
    B1/B2 dense) or twostage's 2D stage (B1/B2 twostage), because split2m's
    rounding of those entries defines that function; under highest the
    sum-factorized count, the least work for the function.  The metric:
    6 q^3 words a cell streamed, or 24 coefficient words a cell and its
    rebuild's FMAs."""
    p, q, nc = op.degree, op.n_q, op.n_cells
    nz, ny, nx = op.n_nodes_axis
    nn, p13, q3 = nz * ny * nx, (p + 1) ** 3, q ** 3
    word = op.dtype.itemsize
    if name in ("matvec", "fused_cg_iteration"):
        rebuilt = op.gmetric is None
        if split and op.factor == "twostage":  # the 2D stage, tensor cores
            products = 3 * q * 2 * 3 * q * q * (p + 1) ** 2
            other = 12 * q * p13 + 27 * q3
        elif split:  # the dense M on the tensor cores
            products = 2 * 3 * 3 * q3 * p13
            other = 27 * q3
        else:
            products = sumfac_fma(p, q)
            other = 27 * q3
        other += METRIC_FMA * q3 if rebuilt else 0
        words = ((6 if name == "matvec" else 25) * nn
                 + (24 if rebuilt else 6 * q3) * nc)
    else:  # the apply family; metric streamed, or rebuilt (B4)
        products = 2 * 3 * 3 * q3 * p13 if split else sumfac_fma(p, q)
        onthefly = name == "apply_local_batched_onthefly"
        other = 27 * q3 + (METRIC_FMA * q3 if onthefly else 0)
        words = ((6 * p13 * nc if name.startswith("apply_local") else 6 * nn)
                 + (24 if onthefly else 6 * q3) * nc
                 + (nn if name == "apply_lattice_zslab" else 0))
    t_bytes = words * word / HBM_BPS
    if split:
        t_ops = max(2 * 2 * products * nc / PEAK_BF16,
                    2 * other * nc / PEAK_F32)
    else:
        peak = PEAK_F32 if op.dtype == torch.float32 else PEAK_F64
        t_ops = 2 * (products + other) * nc / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b| / max |b|, max |a - b|)."""
    diff = (a - b).abs().max().item()
    return diff / b.abs().max().item(), diff


def check(name: str, err: float, tol: float) -> None:
    print(f"  {name}: max rel err {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel and plain version disagree "
                             f"({err:.3e} > {tol:.0e})")


def random_state(op, n: int, seed: int):
    gen = torch.Generator(device=op.device).manual_seed(seed)
    shape = (3,) + op.n_nodes_axis
    return [(torch.randn(shape, generator=gen, device=op.device,
                         dtype=op.dtype) * op.mask).contiguous()
            for _ in range(n)]


def time_pair(kern, plain, dev, timing, inner: int = 20):
    """(kernel ms, plain ms): alternate plain, kernel, kernel, plain."""
    tp1 = timing.time_per_call(plain, dev, inner=5, repeats=3)
    tk1 = timing.time_per_call(kern, dev, inner=inner, repeats=3)
    tk2 = timing.time_per_call(kern, dev, inner=inner, repeats=3)
    tp2 = timing.time_per_call(plain, dev, inner=5, repeats=3)
    return min(tk1, tk2) * 1e3, min(tp1, tp2) * 1e3


def stepped_solve(op, b, prec, carry64: bool) -> tuple[list, float]:
    """The fused solve's loop (``cg_fused.fused_merged_cg_solve``), stepped
    here with the 7 update3b sums recomputed in f64 from each iteration's
    vectors: (residual estimate / res0 by iteration, the largest relative
    error of the kernel's alpha, beta and res2 against the scalars from the
    f64 sums).  ``carry64``: those scalars go on in place of the kernel's."""
    from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk

    P = prec[:1].contiguous()
    g0 = (-(b * op.mask)).contiguous()
    res0 = torch.sqrt(torch.sum(g0 * g0)).item()
    scal = torch.zeros((8,), dtype=op.dtype, device=op.device)
    scal[4] = 1.0
    state = (torch.zeros_like(g0), g0, torch.zeros_like(g0),
             torch.zeros_like(g0), scal)
    spare = tuple(torch.empty_like(t) for t in state)
    work = fk.Workspace(op)
    hist, err, pick = [1.0], 0.0, [0, 1, 5]
    for _ in range(100):
        _, g, d, h, new = fk.fused_cg_iteration(op, *state, P, out=spare,
                                                work=work)
        g, d, h, p64 = (t.double() for t in (g, d, h, P))
        s = torch.stack([torch.sum(d * h), torch.sum(h * h),
                         torch.sum(g * h), torch.sum(g * g),
                         torch.sum(g * p64 * h), torch.sum(h * p64 * h),
                         torch.sum(g * p64 * g),
                         torch.zeros((), dtype=torch.float64, device=g.device)])
        old = state[4].double()
        ref = fk.scalar_recurrence(s, old[0], old[1], old[4])
        err = max(err, ((new.double() - ref)[pick].abs()
                        / ref[pick].abs()).max().item())
        if carry64:
            new.copy_(ref)
        state, spare = spare, state
        res = math.sqrt(max(new[5].item(), 0.0))
        hist.append(res / res0)
        if res <= 1e-8 * res0:
            break
    return hist, err


def edge_witness(pb, hist, n: int, s: int, p: int) -> bool:
    """Readings at a parity point where the f32 split2m fused solve did not
    converge (``n`` iterations, history ``hist``): the solve stepped with its sums recomputed
    in f64 (:func:`stepped_solve`, with the kernel's scalars and with the
    f64 ones carried); the operator's asymmetry |v.Au - u.Av| / (|v| |Au|)
    on the card, against f32 highest's at the same point; the plain
    version's solve on the CPU.  True when the stepped solve repeats the
    solver's history and the kernel's scalars agree with the f64 sums' to
    1e-5 relative: then the floor is the rung's, not a fault of the
    kernel's sums."""
    from mf_data_locality_tpu_torch.models import bp4
    from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
    from mf_data_locality_tpu_torch.solvers import cg_fused

    op, lat = pb.op, pb.layout.n_nodes_axis
    b, prec = pb.b.reshape((3,) + lat), pb.inv_diag.reshape((1,) + lat)
    mine, err = stepped_solve(op, b, prec, carry64=False)
    h64, err64 = stepped_solve(op, b, prec, carry64=True)
    same = len(mine) == n + 1 and all(
        abs(a - c / hist[0]) <= 1e-6 * a for a, c in zip(mine, hist))
    print(f"  witness: stepped solve {len(mine) - 1} iterations, history "
          f"{'equal to' if same else 'DIFFERENT from'} the solver's; kernel "
          f"alpha, beta, res2 vs the f64 sums' max rel err {err:.3e}; with "
          f"the f64 scalars carried: {len(h64) - 1} iterations, lowest "
          f"{min(h64):.3e} res0 (max rel err {err64:.3e})")
    for precision in ("split2m", "highest"):
        o = op if precision == "split2m" else bp4.build(
            s, p, torch.float32, "highest", factor=op.factor,
            metric=op.metric, windowing="pieces", device=op.device).op
        u, v = random_state(o, 2, seed=5)
        au, av = fk.matvec(o, u).double(), fk.matvec(o, v).double()
        u, v = u.double(), v.double()
        asym = (torch.sum(v * au) - torch.sum(u * av)).abs() / (
            v.norm() * au.norm())
        print(f"  witness: asymmetry of the f32 {precision} operator on the "
              f"card {asym.item():.3e}")
    cpu = bp4.build(s, p, torch.float32, "split2m", factor=op.factor,
                    metric=op.metric, windowing="pieces", device="cpu")
    r = cg_fused.fused_merged_cg_solve(
        cpu.op, lat, cpu.b.reshape((3,) + lat),
        cpu.inv_diag.reshape((1,) + lat))
    print(f"  witness: the plain version on the CPU: itCG {r.n_iterations}, "
          f"converged {r.converged}")
    return same and err <= 1e-5


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from mf_data_locality_tpu_torch import benchmark
    from mf_data_locality_tpu_torch.models import bp4
    from mf_data_locality_tpu_torch.ops import _build
    from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
    from mf_data_locality_tpu_torch.ops import laplace_apply as la
    from mf_data_locality_tpu_torch.solvers import cg_fused
    from mf_data_locality_tpu_torch.utils import timing

    # name -> (wrapper, source, TPU kernel it replaces)
    kernels = {
        "matvec": (fk.matvec, "cg_fused.cu", "cg_fused_kernel.py:1116"),
        "fused_cg_iteration": (fk.fused_cg_iteration, "cg_fused.cu",
                               "cg_fused_kernel.py:1476"),
        "apply_local_batched_g": (la.apply_local_batched_g,
                                  "apply_sumfac.cuh", "laplace_pallas.py:1023"),
        "apply_local_batched_onthefly": (la.apply_local_batched_onthefly,
                                         "apply_sumfac.cuh",
                                         "laplace_pallas.py:1043"),
        "apply_lattice_pieces": (la.apply_lattice_pieces, "apply_sumfac.cuh",
                                 "laplace_pallas.py:947"),
        "apply_lattice_zslab": (la.apply_lattice_zslab, "apply_sumfac.cuh",
                                "laplace_pallas.py:664"),
    }

    def zero_counts():
        for fn, _, _ in kernels.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, (fn, _, _) in kernels.items()}

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({lib_path.name})")
    entry = ""  # the kernel a ptxas line is about
    for line in log.splitlines():
        if "Function properties for" in line:
            entry = line.split("for ")[-1].strip()
        elif re.search(r"[1-9]\d* bytes spill", line):
            print("  ptxas:", entry[:60], line.strip())

    # -- 3. kernels vs plain versions at the main paths' size -------------
    print("kernels vs plain:")
    errs, times, errs_split, times_split, bounds = {}, {}, {}, {}, {}
    # B1-B6 at f64 highest, B1/B2 at f32 highest and in the dense
    # configurations: (kernel ms, plain ms), bound, max |diff|
    f64, highest = {}, {}
    dense = {run[-1]: {} for run in DENSE_RUNS}
    for dtype, precision, config, p, s, sfx in FUSED_RUNS:
        pb = bp4.build(s, p, dtype, precision, device=dev, **config)
        op = pb.op
        prec = pb.inv_diag.reshape((1,) + op.n_nodes_axis).contiguous()
        tag = (f"p={p} s={s} {str(dtype)[6:]} {precision} {op.factor} "
               f"{op.metric}")

        (d,) = random_state(op, 1, seed=1)
        rel, diff = rel_err(fk.matvec(op, d), fk._matvec_plain(op, d))
        check(f"matvec {tag}", rel, TOL[dtype])

        x, g, dd, h = random_state(op, 4, seed=2)
        scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6],
                            dtype=dtype, device=dev)
        got = fk.fused_cg_iteration(op, x, g, dd, h, scal, prec)
        want = fk._fused_iteration_plain(op, x, g, dd, h, scal, prec)
        fdiff = 0.0
        for name, a, b in zip(("x'", "g'", "d'", "h'"), got[:4], want[:4]):
            r, dv = rel_err(a, b)
            fdiff = max(fdiff, dv)
            check(f"fused_cg_iteration {tag} {name}", r, TOL[dtype])
        scal_rel = ((got[4] - want[4]).abs() / want[4].abs().clamp_min(
            torch.finfo(dtype).tiny)).max().item()
        check(f"fused_cg_iteration {tag} scal",
              scal_rel, TOL_SCAL_F32 if dtype == torch.float32
              else TOL[dtype])

        out = torch.empty_like(d)
        work = fk.Workspace(op)
        bufs = tuple(torch.empty_like(t) for t in (x, g, dd, h, scal))
        t = {"matvec": time_pair(
                 lambda: fk.matvec(op, d, out=out, work=work),
                 lambda: fk._matvec_plain(op, d), dev, timing),
             "fused_cg_iteration": time_pair(
                 lambda: fk.fused_cg_iteration(op, x, g, dd, h, scal, prec,
                                               out=bufs, work=work),
                 lambda: fk._fused_iteration_plain(op, x, g, dd, h, scal,
                                                   prec), dev, timing)}
        for name, err in (("matvec", diff), ("fused_cg_iteration", fdiff)):
            b = bound(name, op, split=precision == "split2m")
            print(f"  {name} {tag}: kernel {t[name][0]:.4f} ms, plain "
                  f"{t[name][1]:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
            if sfx in dense:
                dense[sfx][name] = t[name], b, err
            elif dtype == torch.float64:
                f64[name] = t[name], b, err
            elif precision == "highest":
                highest[name] = t[name], b, err
            else:
                errs[name], times[name], bounds[name] = err, t[name], b
        del pb, op, d, x, g, dd, h, want, got
        out = work = bufs = None
        torch.cuda.empty_cache()

    for dtype, precision in ((torch.float32, "highest"),
                             (torch.float32, "split2m"),
                             (torch.float64, "highest")):
        tag = f"p={DEGREE} s={S} {str(dtype)[6:]} {precision}"
        ops = {"precomputed": bp4.build(S, DEGREE, dtype, precision,
                                        factor="dense", metric="precomputed",
                                        windowing="reshape", device=dev).op}
        if precision == "highest":  # B4 is exact on every rung
            ops["onthefly"] = bp4.build(S, DEGREE, dtype, precision,
                                        factor="dense", metric="onthefly",
                                        windowing="reshape", device=dev).op
        opg = ops["precomputed"]
        (u,) = random_state(opg, 1, seed=3)
        u_loc = la.to_cell_batches(u, DEGREE).contiguous()
        split = precision == "split2m"
        cases = {
            "apply_local_batched_g": (
                lambda: la.apply_local_batched_g(opg, u_loc),
                lambda: la._batched_plain(opg, u_loc, la._metric(opg),
                                          split)),
            "apply_lattice_pieces": (
                lambda: la.apply_lattice_pieces(opg, u),
                lambda: la._lattice_plain(opg, u, la._index_mask(opg))),
            "apply_lattice_zslab": (
                lambda: la.apply_lattice_zslab(opg, u),
                lambda: la._lattice_plain(opg, u, opg.mask)),
        }
        if "onthefly" in ops:
            opo = ops["onthefly"]
            cases["apply_local_batched_onthefly"] = (
                lambda: la.apply_local_batched_onthefly(opo, u_loc),
                lambda: la._batched_plain(opo, u_loc, la._metric(opo),
                                          False))
        for name, (kern, plain) in cases.items():
            rel, diff = rel_err(kern(), plain())
            check(f"{name} {tag}", rel, TOL[dtype])
            onthefly = name.endswith("onthefly")
            t = time_pair(kern, plain, dev, timing, inner=10)
            b = bound(name, opo if onthefly else opg, split)
            print(f"  {name} {tag}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} "
                  f"ms, bound {b[0]:.4f} ms ({b[1]})")
            if dtype == torch.float64:
                f64[name] = t, b, diff
            elif precision == "highest":
                errs[name], times[name], bounds[name] = diff, t, b
            else:
                errs_split[name], times_split[name] = diff, t
                bounds[name + "_split2m"] = b
        del ops, opg, u, u_loc, cases
        torch.cuda.empty_cache()

    # -- 4. convergence class at the parity point p=4, s=7 ---------------
    for dtype, precision, allowed in ((torch.float64, "highest", (91,)),
                                      (torch.float32, "highest",
                                       (91, 92, 93, 94)),
                                      (torch.float32, "split2m",
                                       (91, 92, 93, 94))):
        pb = bp4.build(7, DEGREE, dtype, precision, device=dev, **FUSED)
        lat = pb.layout.n_nodes_axis
        res = cg_fused.fused_merged_cg_solve(
            pb.op, lat, pb.b.reshape((3,) + lat),
            pb.inv_diag.reshape((1,) + lat))
        print(f"p=4 s=7 fused {str(dtype)[6:]} {precision}: itCG "
              f"{res.n_iterations}, converged {res.converged}")
        if res.n_iterations not in allowed or not res.converged:
            raise AssertionError(f"p=4 s=7 fused {precision}: itCG "
                                 f"{res.n_iterations} not in {allowed}")
    for dtype, precision, metric, allowed, solvers in (
            (torch.float64, "highest", "precomputed", (91,),
             ("merged", "baseline")),
            (torch.float64, "highest", "onthefly", (91,), ("merged",)),
            (torch.float32, "highest", "precomputed", (91, 92, 93, 94),
             ("merged", "baseline")),
            (torch.float32, "split2m", "precomputed", (91, 92, 93, 94),
             ("merged",))):
        pb = bp4.build(7, DEGREE, dtype, precision, factor="dense",
                       metric=metric, windowing="reshape", device=dev)
        its = {}
        for solver in solvers:
            res = benchmark.solver_call(pb, solver)()
            its[solver] = res.n_iterations
            print(f"p=4 s=7 {solver} {str(dtype)[6:]} {precision} {metric}: "
                  f"itCG {res.n_iterations}, converged {res.converged}")
            if res.n_iterations not in allowed or not res.converged:
                raise AssertionError(f"p=4 s=7 {solver} {metric}: itCG "
                                     f"{res.n_iterations} not in {allowed}")
        if dtype == torch.float64 and len(set(its.values())) > 1:
            raise AssertionError(f"merged and baseline itCG differ: {its}")

    # the fused solver through the auto-dispatch at the parity points
    # (PARITY.md:91-123): (p, s, f64 itCG allowed, split2m allowed or None).
    # p=3 s=9 sits on the tolerance's edge: JAX merged f64 stops at 95 with
    # its residual 0.3% above it, so any summation order may stop one
    # earlier.  f32 split2m levels off there at 0.9-2.4e-8 res0, about the
    # 1e-8 tolerance (the TPU stopped at 96, the plain version on the CPU
    # stops at 96): if it does not converge, edge_witness must show that the
    # kernel's sums are right and that it is the rung's floor, and the
    # residual must be within 10x the tolerance by the f64 count
    for p, s, allowed64, allowed_split in ((2, 11, (87,), range(87, 91)),
                                           (3, 9, (94, 95), range(94, 99)),
                                           (4, 7, (91,), None)):
        its = {}
        for dtype, precision in ((torch.float64, "highest"),
                                 (torch.float32, "highest"),
                                 (torch.float32, "split2m")):
            if precision == "split2m" and allowed_split is None:
                continue  # p=4 split2m: twostage + onthefly, checked above
            factor, metric, _ = benchmark.resolve_config(
                p, "fused", "pieces", precision, dtype)
            pb = bp4.build(s, p, dtype, precision, factor=factor,
                           metric=metric, windowing="pieces", device=dev)
            lat = pb.layout.n_nodes_axis
            res = cg_fused.fused_merged_cg_solve(
                pb.op, lat, pb.b.reshape((3,) + lat),
                pb.inv_diag.reshape((1,) + lat))
            n = its[(dtype, precision)] = res.n_iterations
            n64 = its[(torch.float64, "highest")]  # run first
            allowed = (allowed64 if dtype == torch.float64 else allowed_split
                       if precision == "split2m" else range(n64, n64 + 4))
            hist = res.res_history.cpu().numpy()
            at64 = hist[min(n, n64)] / hist[0]
            print(f"p={p} s={s} fused auto {str(dtype)[6:]} {precision} "
                  f"({factor}, {metric}), n_dofs {pb.n_dofs}: itCG {n}, "
                  f"converged {res.converged}, residual at it {n64} "
                  f"{at64:.3e} res0")
            ok = res.converged and n in allowed
            if not res.converged and (p, precision, n) == (3, "split2m", 100):
                ok = at64 <= 1e-7 and edge_witness(pb, hist, n, s, p)
            if not ok:
                raise AssertionError(f"p={p} s={s} fused {precision}: itCG "
                                     f"{n}, converged {res.converged}; "
                                     f"allowed {tuple(allowed)}")
        if p != 3:  # fused == merged in f64 away from the tolerance's edge
            pb = bp4.build(s, p, torch.float64, "highest", device=dev)
            n = bp4.solve_merged(pb).n_iterations
            print(f"p={p} s={s} merged f64 highest: itCG {n}")
            if n != its[(torch.float64, "highest")]:
                raise AssertionError(f"p={p} s={s}: fused and merged f64 "
                                     f"itCG differ ({its}, merged {n})")
        del pb

    # -- 5. the paths -----------------------------------------------------
    bw = timing.measure_hbm_bandwidth(dev)
    launches, launches_split, launches_highest = {}, {}, {}

    def drive(label, s, expect, into=launches, degree=DEGREE, **kw):
        zero_counts()
        r = benchmark.run_one(degree, s, device=dev, **kw)
        got = counts()
        share = r.dofs_per_s_per_it / (bw / 36)  # 9 f32 words/DoF (bench.py)
        print(f"{label} p={degree} s={s}: n_dofs {r.n_dofs} itCG "
              f"{r.n_iterations} converged {r.converged} time/it "
              f"{r.time_per_it:.6e} s DoF/s/it {r.dofs_per_s_per_it:.6e} "
              f"time/matvec {r.time_per_matvec:.6e} s roofline share "
              f"{share:.4f}")
        print(f"  launches: { {k: v for k, v in got.items() if v} }")
        if min(got[name] for name in expect) <= 0:
            raise AssertionError(f"{label}: a kernel of the path never "
                                 f"ran: {got}")
        if not (0 < r.n_iterations <= 100 and r.time_per_it > 0
                and r.time_per_matvec > 0):
            raise AssertionError(f"{label}: implausible row: {r}")
        if into is not None:
            into.update({name: got[name] for name in expect})
        return r

    print(f"triad {bw / 1e9:.1f} GB/s")
    r_fused = drive("fused path (f32 split2m, pieces)", S,
                    ("matvec", "fused_cg_iteration"), solver="fused",
                    precision="split2m", windowing="pieces")
    r_main = drive("main path (merged, f32 highest, reshape)", S,
                   ("apply_local_batched_g",), solver="merged",
                   precision="highest", windowing="reshape")
    r_split = drive("merged, f32 split2m, reshape", S,
                    ("apply_local_batched_g",), into=launches_split,
                    solver="merged", precision="split2m", windowing="reshape")
    short = dict(solve_repeats=1, matvec_repeats=1, matvec_inner=5)
    # the fused solver in each dense configuration of phase 3, at its p and s
    launches_dense = {sfx: {} for sfx in dense}
    full = [r_fused, r_main, r_split]
    for dtype, precision, config, p, s, sfx in DENSE_RUNS:
        fm = (config["factor"], config["metric"])
        auto = benchmark.resolve_config(p, "fused", "pieces", precision,
                                        dtype)[:2] == fm
        r = drive(f"fused {'auto' if auto else 'explicit'}, "
                  f"{str(dtype)[6:]} {precision} {fm}", s,
                  ("matvec", "fused_cg_iteration"),
                  into=launches_dense[sfx], degree=p, solver="fused",
                  dtype=dtype, precision=precision, windowing="pieces",
                  **({} if auto else dict(zip(("factor", "metric"), fm))),
                  **({} if sfx in FULL_WIDTH else short))
        if sfx in FULL_WIDTH:
            full.append(r)
    if len(full) != 3 + len(FULL_WIDTH) or any(
            r.n_dofs != 1_635_075 for r in full):
        raise AssertionError(f"main-path rows at the wrong size: {full}")
    # B3's count in the kernels line is the main path's
    drive("baseline (reshape)", S_SHORT, ("apply_local_batched_g",),
          into=None, solver="baseline", **short)
    drive("merged --geometry onthefly", S_SHORT,
          ("apply_local_batched_onthefly",), solver="merged",
          metric="onthefly", **short)
    drive("merged --windowing pieces", S_SHORT, ("apply_lattice_pieces",),
          solver="merged", windowing="pieces", **short)
    drive("merged --windowing zslab", S_SHORT, ("apply_lattice_zslab",),
          solver="merged", windowing="zslab", **short)
    drive("merged --windowing zslab, f32 split2m", S_SHORT,
          ("apply_lattice_zslab",), into=launches_split, solver="merged",
          windowing="zslab", precision="split2m", **short)
    drive("fused, f32 highest (twostage, onthefly)", S_SHORT,
          ("matvec", "fused_cg_iteration"), into=launches_highest,
          solver="fused", precision="highest", factor="twostage",
          metric="onthefly", windowing="pieces", **short)

    # the three p=4 s=13 solutions: shape, finite, and their true residual
    # |b - A x| equal to the recurrence's residual estimate (at s=13 the
    # f32 solves stop at the 100-iteration cap, so the residual is not small)
    pb = bp4.build(S, DEGREE, torch.float32, "split2m", device=dev, **FUSED)
    lat = pb.layout.n_nodes_axis
    b = pb.b.reshape((3,) + lat)
    res = cg_fused.fused_merged_cg_solve(pb.op, lat, b,
                                         pb.inv_diag.reshape((1,) + lat))
    solutions = [("fused", res, torch.linalg.norm(
        b - fk.matvec(pb.op, res.x.contiguous())).item(), (3,) + lat,
        r_fused)]
    del pb, b
    for precision, row in (("highest", r_main), ("split2m", r_split)):
        pb = bp4.build(S, DEGREE, torch.float32, precision, factor="dense",
                       metric="precomputed", windowing="reshape", device=dev)
        res = bp4.solve_merged(pb)
        solutions.append((f"merged {precision}", res, torch.linalg.norm(
            pb.b - pb.a_apply(res.x)).item(), tuple(pb.b.shape), row))
        del pb
    for label, res, true_res, shape, row in solutions:
        gap = abs(true_res - res.res_norm) / res.res_norm
        print(f"{label} solution: shape {tuple(res.x.shape)}, itCG "
              f"{res.n_iterations}, |b - Ax| {true_res:.6e} vs estimate "
              f"{res.res_norm:.6e} (rel gap {gap:.2e}, tol 1e-3)")
        if tuple(res.x.shape) != shape or not torch.isfinite(res.x).all() \
                or res.n_iterations != row.n_iterations or not gap < 1e-3:
            raise AssertionError(f"{label} solution is wrong")

    # no single PyTorch call computes any of these functions (each is a
    # fused chain of contractions, the metric apply and masking), so
    # library_ms is null throughout
    rows = []
    for name, (_, src, line) in kernels.items():
        row = {"name": name, "route": "cuda", "source": CSRC + src,
               "replaces": f"mf_data_locality_tpu/ops/{line}",
               "launches": launches[name], "max_abs_err": errs[name],
               "ms": times[name][0], "plain_ms": times[name][1],
               "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
               "library_ms": None}
        if name in highest:  # B1, B2: measured at split2m, then highest
            (k, pl), (bms, by), err = highest[name]
            row.update(source_split2m=CSRC + "cell_mma.cuh",
                       source_highest=CSRC + "apply_sumfac.cuh",
                       ms_highest=k, plain_ms_highest=pl,
                       max_abs_err_highest=err, bound_ms_highest=bms,
                       bound_by_highest=by,
                       launches_highest=launches_highest[name])
        for _, precision, _, p, s, sfx in DENSE_RUNS:  # B1, B2: dense
            if name in dense[sfx]:
                (k, pl), (bms, by), err = dense[sfx][name]
                src = ("apply_mma.cuh" if precision == "split2m"
                       else "apply_sumfac.cuh")
                row.update({f"source{sfx}": CSRC + src, f"p_s{sfx}": [p, s],
                            f"ms{sfx}": k, f"plain_ms{sfx}": pl,
                            f"max_abs_err{sfx}": err, f"bound_ms{sfx}": bms,
                            f"bound_by{sfx}": by,
                            f"launches{sfx}": launches_dense[sfx][name]})
        if name in times_split:  # B3, B5, B6: the tensor-core split2m pass
            row.update(source_split2m=CSRC + "apply_mma.cuh",
                       ms_split2m=times_split[name][0],
                       plain_ms_split2m=times_split[name][1],
                       max_abs_err_split2m=errs_split[name],
                       bound_ms_split2m=bounds[name + "_split2m"][0],
                       bound_by_split2m=bounds[name + "_split2m"][1])
            if name in launches_split:
                row["launches_split2m"] = launches_split[name]
        if name in f64:  # every kernel at f64 highest
            (k, pl), (bms, by), err = f64[name]
            row.update(ms_f64=k, plain_ms_f64=pl, max_abs_err_f64=err,
                       bound_ms_f64=bms, bound_by_f64=by)
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
