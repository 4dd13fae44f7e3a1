"""The plain modules on a card: ``chip_smoke.py`` section 12.

    python -m mf_data_locality_tpu_torch.utils.modules_check

builds the kernels and runs, at full width, each module that the JAX
package computes without a Pallas kernel and that the port writes as
plain PyTorch, every check raising on a miss:

* the mass operator (``ops/mass.py``), CEED BP2 and BP1 at p=4 s=13
  (1,635,075 and 545,025 DoFs): 1^T M 1 in f64 equal to the box's volume
  2^(13 mod 3) = 2 to 1e-10 relative, ``apply_cells`` on the card against
  the same function on the CPU on one seeded vector (f64, 1e-12
  relative), the f32 ``vmult``'s error against the f64 one, and the time
  of one ``vmult`` in f32 and f64;
* the general hex mesh (``mesh/general.py``): an L-shaped prism, the
  s=13 box's (16, 16, 32) cell lattice without the cells with cy >= 8 and
  cx >= 16 (6,144 cells, 1,235,715 DoFs at p=4), spacing 1/16, deformed
  by ``manifold.push_forward``: ``ops/laplace.vmult`` on the card against
  the CPU (f64, 1e-12), and a merged CG (Jacobi from
  ``diagonal.compute_inverse_diagonal``, f64, cap 100) timed;
* the 2D operator (``ops/laplace2d.py``) on 256 x 512 cells at p=4
  (4,200,450 DoFs): ``vmult2d`` on the card against the CPU (f64, 1e-12)
  and 100 iterations of the merged CG with the identity preconditioner;
* the trace (``utils/profiling.trace``, ``marker``,
  ``utils/trace_summary``): 5 iterations of the fused split2m solver at
  p=4 s=13 (B2 on ``csrc/cell_mma.cuh``) inside ``marker("cg_solver")``;
  the summary's top ops hold B2's cell, assemble and finalize kernels, the
  trace the annotation, and B2's time an iteration by the summary lies
  within 10% of ``kernel_breakdown``'s in a separate call.

Each vmult is timed by CUDA events beside the least time its bytes take
at the triad bandwidth measured in the same call (each input read once,
each output written once).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import tempfile
import time

import numpy as np
import torch

from mf_data_locality_tpu_torch.mesh import manifold
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.mesh.general import macro_hex_layout
from mf_data_locality_tpu_torch.ops import diagonal, laplace, laplace2d, mass
from mf_data_locality_tpu_torch.utils import profiling, timing, trace_summary

DEGREE, S = 4, 13
MASS_DOFS = {3: 1_635_075, 1: 545_025}  # BP2, BP1
L_LATTICE, L_CELLS, L_DOFS = (16, 16, 32), 6144, 1_235_715
CELLS_2D, DOFS_2D = (256, 512), 4_200_450
TOL = 1e-12  # card vs CPU, f64, relative to the largest entry
TOL_VOLUME = 1e-10
TRACE_ITERS = 5
B2_KERNELS = ("cells_mma_kernel", "assemble_kernel", "finalize_kernel")
TOL_TRACE = 0.10  # the summary's B2 time against kernel_breakdown's
F32, F64 = torch.float32, torch.float64


def _moved(op, device):
    """An operator dataclass with every tensor on ``device``."""
    return dataclasses.replace(op, **{
        f.name: getattr(op, f.name).to(device)
        for f in dataclasses.fields(op)})


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _seeded(shape, seed: int) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape))


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _timed(fn, dev, nbytes: int, triad: float) -> dict:
    """fn's time by CUDA events (10 calls, best of 3) beside its bytes'
    least time at the triad bandwidth, both in ms."""
    return dict(ms=timing.time_per_call(fn, dev, inner=10, repeats=3) * 1e3,
                bytes_ms=nbytes / triad * 1e3)


def _timed_solve(solve, dev) -> tuple:
    """(result, host seconds an iteration) of one solve, synchronised."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = solve()
    torch.cuda.synchronize(dev)
    return res, (time.perf_counter() - t0) / max(res.n_iterations, 1)


def _solve_checks(res, a_apply, b, what: str) -> dict:
    """A CG result's checks: x finite, its true residual |b - A x| the
    recurrence's estimate to 1e-8 res0, and the energy 1/2 x.Ax - b.x
    below its start 0 (CG lowers it every iteration; the residual may
    rise)."""
    hist = res.res_history[:res.n_iterations + 1].cpu().numpy()
    ax = a_apply(res.x)
    true = torch.linalg.norm(b - ax).item()
    energy = (0.5 * torch.sum(res.x * ax) - torch.sum(b * res.x)).item()
    _require(bool(torch.isfinite(res.x).all()) and np.isfinite(hist).all()
             and abs(true - hist[-1]) <= 1e-8 * hist[0] and energy < 0,
             f"{what}: |b - Ax| {true!r} against the estimate "
             f"{hist[-1]!r} (res0 {hist[0]!r}), energy {energy!r}")
    return dict(it=res.n_iterations, converged=res.converged,
                res_rel=float(hist[-1] / hist[0]),
                true_res_rel=true / float(hist[0]), energy=energy)


def mass_readings(dev, triad: float) -> dict:
    """BP2 and BP1 at p=4 s=13: the volume, card vs CPU, f32 vs f64, the
    vmult times."""
    layout = DofLayout(BoxMesh.from_s(S), DEGREE)
    op64 = mass.make_mass_operator(layout, dtype=F64, device=dev)
    op32 = mass.make_mass_operator(layout, dtype=F32, device=dev)
    cpu = _moved(op64, "cpu")
    ones = torch.ones((1, layout.n_nodes), dtype=F64, device=dev)
    volume = mass.apply_cells(op64, ones).sum().item()
    _require(abs(volume - 2.0) <= TOL_VOLUME * 2.0,
             f"mass: 1^T M 1 = {volume!r}, not the volume 2")
    out = dict(volume=volume)
    for c, name in ((3, "BP2"), (1, "BP1")):
        _require(c * layout.n_nodes == MASS_DOFS[c], f"{name}: DoFs")
        u = _seeded((c, layout.n_nodes), 19 + c)
        u_dev = u.to(dev)
        err = _rel(mass.apply_cells(op64, u_dev), mass.apply_cells(cpu, u))
        _require(err <= TOL, f"{name} apply_cells card vs CPU {err:.3e}")
        v64 = mass.vmult(op64, u_dev)
        err32 = _rel(mass.vmult(op32, u_dev.float()), v64)
        row = dict(dofs=MASS_DOFS[c], card_vs_cpu=err, f32_vs_f64=err32)
        for dt, op in ((F32, op32), (F64, op64)):
            x = u_dev.to(dt)
            fields = [getattr(op, f.name) for f in dataclasses.fields(op)]
            row[str(dt)[6:]] = _timed(lambda: mass.vmult(op, x), dev,
                                      _nbytes(x, x, *fields), triad)
        out[name] = row
        del u_dev, v64
    return out


def l_shape_layout():
    """The L-shaped prism on the s=13 box's cell lattice."""
    cz, cy, cx = np.meshgrid(*(np.arange(n) for n in L_LATTICE),
                             indexing="ij")
    cells = np.stack([cz, cy, cx], axis=-1).reshape(-1, 3)
    cells = cells[~((cells[:, 1] >= L_LATTICE[1] // 2)
                    & (cells[:, 2] >= L_LATTICE[2] // 2))]
    return macro_hex_layout(cells, DEGREE, spacing=1.0 / L_LATTICE[0],
                            deform=manifold.push_forward)


def l_shape_readings(dev, triad: float) -> dict:
    """The general operator on the L-shape: card vs CPU, the vmult time, a
    merged CG with the Jacobi preconditioner."""
    from mf_data_locality_tpu_torch.models import bp4
    from mf_data_locality_tpu_torch.solvers import cg_merged

    lay = l_shape_layout()
    _require(3 * lay.n_nodes == L_DOFS and lay.mesh.n_cells == L_CELLS,
             f"L-shape: {lay.mesh.n_cells} cells, {3 * lay.n_nodes} DoFs")
    op = laplace.make_operator(lay, dtype=F64, device=dev)
    u = _seeded((3, lay.n_nodes), 7)
    u_dev = u.to(dev)
    err = _rel(laplace.vmult(op, u_dev), laplace.vmult(_moved(op, "cpu"), u))
    _require(err <= TOL, f"L-shape vmult card vs CPU {err:.3e}")
    fields = [getattr(op, f.name) for f in dataclasses.fields(op)]
    out = dict(cells=lay.mesh.n_cells, dofs=L_DOFS, card_vs_cpu=err,
               vmult=_timed(lambda: laplace.vmult(op, u_dev), dev,
                            _nbytes(u_dev, u_dev, *fields), triad))
    inv = torch.as_tensor(diagonal.compute_inverse_diagonal(lay),
                          device=dev)[None]
    b = torch.as_tensor(np.ascontiguousarray(bp4.rhs(lay)), device=dev)
    def a_apply(v):
        return laplace.vmult(op, v, constrained_identity=False)

    res, per_it = _timed_solve(lambda: cg_merged.merged_cg_solve(
        a_apply, b, inv, max_iter=100), dev)
    out.update(_solve_checks(res, a_apply, b, "L-shape CG"), s_per_it=per_it)
    return out


def two_d_readings(dev, triad: float) -> dict:
    """The 2D operator: card vs CPU, the vmult time, 100 merged CG
    iterations with the identity preconditioner."""
    from mf_data_locality_tpu_torch.solvers import cg_merged

    mesh = laplace2d.BoxMesh2D(n_cells_axis=CELLS_2D,
                               spacing=1.0 / max(CELLS_2D))
    lay = laplace2d.DofLayout2D(mesh, DEGREE)
    _require(2 * lay.n_nodes == DOFS_2D, "2D: DoFs")
    op = laplace2d.make_operator2d(lay, device=dev)
    u = _seeded((2, lay.n_nodes), 11)
    u_dev = u.to(dev)
    err = _rel(laplace2d.vmult2d(op, u_dev),
               laplace2d.vmult2d(_moved(op, "cpu"), u))
    _require(err <= TOL, f"2D vmult2d card vs CPU {err:.3e}")
    fields = [getattr(op, f.name) for f in dataclasses.fields(op)]
    out = dict(dofs=DOFS_2D, card_vs_cpu=err,
               vmult=_timed(lambda: laplace2d.vmult2d(op, u_dev), dev,
                            _nbytes(u_dev, u_dev, *fields), triad))
    b = torch.where(torch.as_tensor(lay.boundary_node_mask, device=dev), 0.0,
                    torch.arange(lay.n_nodes, device=dev, dtype=F64) % 8.0
                    )[None]
    def a_apply(v):
        return laplace2d.vmult2d(op, v, constrained_identity=False)

    res, per_it = _timed_solve(lambda: cg_merged.merged_cg_solve(
        a_apply, b, torch.ones_like(b), max_iter=100), dev)
    _require(res.n_iterations == 100, f"2D CG: {res.n_iterations} "
             f"iterations, not 100")
    out.update(_solve_checks(res, a_apply, b, "2D CG"), s_per_it=per_it)
    return out


def trace_readings(dev) -> dict:
    """5 fused split2m iterations at p=4 s=13 under ``profiling.trace``:
    B2's kernels in the summary's top ops, the annotation, and B2's time
    an iteration against ``kernel_breakdown``'s in a separate call."""
    from mf_data_locality_tpu_torch.models import bp4
    from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
    from mf_data_locality_tpu_torch.solvers import cg_fused

    pb = bp4.build(S, DEGREE, F32, "split2m", factor="twostage",
                   metric="onthefly", windowing="pieces", device=dev)
    lat = pb.layout.n_nodes_axis
    b = pb.b.reshape((3,) + lat)
    prec = pb.inv_diag.reshape((1,) + lat)

    def solve():
        return cg_fused.fused_merged_cg_solve(pb.op, lat, b, prec,
                                              max_iter=TRACE_ITERS)

    def b2_us(items: list) -> dict:
        return {k: sum(us for name, us in items if k in name)
                for k in B2_KERNELS}

    solve()  # warm-up
    fk.fused_cg_iteration.launches = 0
    with tempfile.TemporaryDirectory(prefix="bp4_trace_") as d:
        with profiling.trace(d):
            with profiling.marker("cg_solver"):
                res = solve()
        launches = fk.fused_cg_iteration.launches
        top = trace_summary.top_ops(d, 10)
        traced = b2_us(list(trace_summary.op_durations(d).items()))
        notes = {e.get("name") for e in trace_summary._trace_events(d)
                 if e.get("cat") == "user_annotation"}
    _require(res.n_iterations == TRACE_ITERS == launches,
             f"trace: {res.n_iterations} iterations, {launches} B2 launches")
    for k in B2_KERNELS:
        _require(any(k in name for name, _ in top),
                 f"trace: {k} not in the top ops {[n for n, _ in top]}")
    _require("cg_solver" in notes, f"trace: no cg_solver annotation {notes}")
    rows, _ = profiling.kernel_breakdown(solve, dev)
    broken = b2_us([(name, sec * 1e6) for name, _, sec in rows])
    per_it = sum(traced.values()) / TRACE_ITERS
    per_it_kb = sum(broken.values()) / TRACE_ITERS
    _require(abs(per_it - per_it_kb) <= TOL_TRACE * per_it_kb,
             f"trace: B2 {per_it:.2f} us/it against kernel_breakdown's "
             f"{per_it_kb:.2f}")
    return dict(b2_us_per_it=per_it, b2_us_per_it_breakdown=per_it_kb,
                b2_kernels_us=traced, b2_kernels_us_breakdown=broken,
                launches=launches,
                top=[(name[:60], us) for name, us in top[:5]])


def run_all(dev) -> dict:
    """Section 12: every reading above, each check raising on a miss;
    prints them and the section's wall time, returns them."""
    t12 = time.perf_counter()
    triad = timing.measure_hbm_bandwidth(dev)
    out = dict(triad_tb_s=triad / 1e12)
    print(f"  triad bandwidth {triad / 1e12:.4f} TB/s")
    for name, fn in (("mass", lambda: mass_readings(dev, triad)),
                     ("l_shape", lambda: l_shape_readings(dev, triad)),
                     ("two_d", lambda: two_d_readings(dev, triad)),
                     ("trace", lambda: trace_readings(dev))):
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.empty_cache()
        print(f"  {name} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(out[name])}")
    out["seconds"] = time.perf_counter() - t12
    print(f"section 12: {out['seconds']:.1f} s")
    return out


def main() -> None:
    from mf_data_locality_tpu_torch.ops import _build

    dev = timing.require_cuda("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    print("the plain modules (mass, general mesh, 2D, trace):")
    run_all(dev)
    print("modules_check ok")


if __name__ == "__main__":
    main()
