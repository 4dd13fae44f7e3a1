#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits nonzero):

1. require a CUDA device; print the card's name and power limit;
2. build the kernels from ``mf_data_locality_tpu_torch/csrc`` with nvcc;
3. at the main path's size (p=4, 2^13 cells, 1,635,075 DoFs) compare each
   kernel with its plain PyTorch version on the same inputs, and time both;
4. convergence class at p=4, s=7: f64 "highest" must take 91 iterations,
   f32 "split2m" 91..94 and converge;
5. the main path: ``benchmark.run_one(4, 13, solver="fused",
   precision="split2m")`` with the kernels' launch counters zeroed just
   before and read just after; then the solution of the same solve is
   checked for shape, finiteness, and its true residual against the
   solver's estimate;
6. print the kernels' JSON line and, last, the device JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

DEGREE, S = 4, 13
SOURCE = "mf_data_locality_tpu_torch/csrc/cg_fused.cu"
# tolerances of kernel vs plain version (max |diff| / max |plain|): the two
# sum in different orders; f32 sums of ~2e2-term contractions and, for the
# scalars, of ~5e6 dot-product terms
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
TOL_SCAL_F32 = 1e-4


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from mf_data_locality_tpu_torch import benchmark
    from mf_data_locality_tpu_torch.models import bp4
    from mf_data_locality_tpu_torch.ops import _build
    from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
    from mf_data_locality_tpu_torch.solvers import cg_fused
    from mf_data_locality_tpu_torch.utils import timing

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
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # -- 3. kernels vs plain versions at the main path's size -------------
    print(f"kernels vs plain at p={DEGREE}, s={S}:")
    errs, times = {}, {}
    for dtype, precision in ((torch.float32, "split2m"),
                             (torch.float64, "highest")):
        pb = bp4.build(S, DEGREE, dtype, precision, device=dev)
        op = pb.op
        prec = pb.inv_diag.reshape((1,) + op.n_nodes_axis).contiguous()
        tag = f"{str(dtype)[6:]} {precision}"

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

        if dtype != torch.float32:
            continue
        errs["matvec"], errs["fused_cg_iteration"] = diff, fdiff
        out = torch.empty_like(d)
        work = fk.Workspace(op)
        bufs = tuple(torch.empty_like(t) for t in (x, g, dd, h, scal))
        for name, kern, plain in (
                ("matvec", lambda: fk.matvec(op, d, out=out, work=work),
                 lambda: fk._matvec_plain(op, d)),
                ("fused_cg_iteration",
                 lambda: fk.fused_cg_iteration(op, x, g, dd, h, scal, prec,
                                               out=bufs, work=work),
                 lambda: fk._fused_iteration_plain(op, x, g, dd, h, scal,
                                                   prec))):
            # alternate plain, kernel, kernel, plain on the same card
            tp1 = timing.time_per_call(plain, dev, inner=5, repeats=3)
            tk1 = timing.time_per_call(kern, dev, inner=20, repeats=3)
            tk2 = timing.time_per_call(kern, dev, inner=20, repeats=3)
            tp2 = timing.time_per_call(plain, dev, inner=5, repeats=3)
            times[name] = (min(tk1, tk2) * 1e3, min(tp1, tp2) * 1e3)
            print(f"  {name} f32 split2m: kernel {times[name][0]:.4f} ms, "
                  f"plain {times[name][1]:.4f} ms")
        del pb, op, d, x, g, dd, h, want, got, bufs, work, out
        torch.cuda.empty_cache()

    # -- 4. convergence class at the parity point p=4, s=7 ---------------
    for dtype, precision, allowed in ((torch.float64, "highest", (91,)),
                                      (torch.float32, "split2m",
                                       (91, 92, 93, 94))):
        pb = bp4.build(7, DEGREE, dtype, precision, device=dev)
        lat = pb.layout.n_nodes_axis
        res = cg_fused.fused_merged_cg_solve(
            pb.op, lat, pb.b.reshape((3,) + lat),
            pb.inv_diag.reshape((1,) + lat))
        print(f"p=4 s=7 {str(dtype)[6:]} {precision}: itCG "
              f"{res.n_iterations}, converged {res.converged}")
        if res.n_iterations not in allowed or not res.converged:
            raise AssertionError(f"p=4 s=7 {precision}: itCG "
                                 f"{res.n_iterations} not in {allowed}")

    # -- 5. the main path -----------------------------------------------
    bw = timing.measure_hbm_bandwidth(dev)
    fk.matvec.launches = 0
    fk.fused_cg_iteration.launches = 0
    r = benchmark.run_one(DEGREE, S, solver="fused", precision="split2m",
                          device=dev)
    launches = {"matvec": fk.matvec.launches,
                "fused_cg_iteration": fk.fused_cg_iteration.launches}
    share = r.dofs_per_s_per_it / (bw / 36)  # 9 f32 words/DoF (bench.py)
    print(f"main path p={DEGREE} s={S} f32 split2m: n_dofs {r.n_dofs} "
          f"itCG {r.n_iterations} converged {r.converged} "
          f"time/it {r.time_per_it:.6e} s DoF/s/it {r.dofs_per_s_per_it:.6e} "
          f"time/matvec {r.time_per_matvec:.6e} s triad {bw / 1e9:.1f} GB/s "
          f"roofline share {share:.4f}")
    print(f"launches in the main path: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches}")
    if not (r.n_dofs == 1_635_075 and 0 < r.n_iterations <= 100
            and r.time_per_it > 0 and r.time_per_matvec > 0):
        raise AssertionError(f"implausible main-path row: {r}")

    # the main path's solution: shape, finite, and its true residual
    # |b - A x| equal to the recurrence's residual estimate (at s=13 the
    # solve stops at the 100-iteration cap, so the residual is not small)
    pb = bp4.build(S, DEGREE, torch.float32, "split2m", device=dev)
    lat = pb.layout.n_nodes_axis
    b = pb.b.reshape((3,) + lat)
    res = cg_fused.fused_merged_cg_solve(pb.op, lat, b,
                                         pb.inv_diag.reshape((1,) + lat))
    true_res = torch.linalg.norm(
        b - fk.matvec(pb.op, res.x.contiguous())).item()
    gap = abs(true_res - res.res_norm) / res.res_norm
    print(f"main-path solution: shape {tuple(res.x.shape)}, itCG "
          f"{res.n_iterations}, |b - Ax| {true_res:.6e} vs estimate "
          f"{res.res_norm:.6e} (rel gap {gap:.2e}, tol 1e-3)")
    if tuple(res.x.shape) != (3,) + lat or not torch.isfinite(res.x).all() \
            or res.n_iterations != r.n_iterations or not gap < 1e-3:
        raise AssertionError("main-path solution is wrong")

    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": f"mf_data_locality_tpu/ops/cg_fused_kernel.py:"
                            f"{line}",
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": times[name][0], "plain_ms": times[name][1]}
               for name, line in (("matvec", 1116),
                                  ("fused_cg_iteration", 1476))]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
