"""PyTorch port: the CUDA kernels against their plain PyTorch versions.

Every test that launches a kernel needs a CUDA device and ``nvcc``; it is
marked ``cuda`` and skips with a reason without one.  This file imports no
JAX, so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import pytest
import torch

from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.ops import laplace_cuda
from mf_data_locality_tpu_torch.solvers import cg_fused

P = 4
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
# the fused solver's configuration (B1, B2)
FUSED = dict(factor="twostage", metric="onthefly", windowing="pieces")
# kernel vs plain (max |diff| / max |plain|): another summation order
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _state(op, n, seed):
    gen = torch.Generator(device=op.device).manual_seed(seed)
    return [(torch.randn((3,) + op.n_nodes_axis, generator=gen,
                         device=op.device, dtype=op.dtype) * op.mask)
            .contiguous() for _ in range(n)]


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def test_wrappers_refuse_other_devices():
    """Only CPU (plain version) and CUDA (kernel) tensors are accepted."""
    op = bp4.build(3, P, torch.float64, "highest", device="cpu", **FUSED).op
    d = torch.empty((3,) + op.n_nodes_axis, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fk.matvec(op, d)
    with pytest.raises(ValueError, match="meta"):
        fk.fused_cg_iteration(op, d, d, d, d, torch.empty(8, device="meta"),
                              d[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "split2m"), (torch.float32, "highest"),
    (torch.float64, "highest")])
def test_matvec_kernel_matches_plain(cuda_device, dtype, precision):
    op = bp4.build(5, P, dtype, precision, device=cuda_device, **FUSED).op
    (u,) = _state(op, 1, seed=0)
    before = fk.matvec.launches
    got = fk.matvec(op, u)
    assert fk.matvec.launches == before + 1
    assert _rel(got, fk._matvec_plain(op, u)) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "split2m"), (torch.float32, "highest"),
    (torch.float64, "highest")])
def test_fused_iteration_kernel_matches_plain(cuda_device, dtype, precision):
    pb = bp4.build(5, P, dtype, precision, device=cuda_device, **FUSED)
    op = pb.op
    x, g, d, h = _state(op, 4, seed=1)
    prec = pb.inv_diag.reshape((1,) + op.n_nodes_axis).contiguous()
    scal = torch.tensor(SCAL, dtype=dtype, device=cuda_device)
    got = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    want = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
    for a, b in zip(got[:4], want[:4]):
        assert _rel(a, b) < TOL[dtype]
    scal_tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    assert ((got[4] - want[4]).abs() / want[4].abs().clamp_min(1e-30)
            ).max().item() < scal_tol


@pytest.mark.cuda
@pytest.mark.parametrize("s", [3, 5, 7, 10])
def test_split2m_cell_pass_matches_plain_and_repeats(cuda_device, s):
    """B1 and B2 under f32 split2m run the tensor-core cell pass: against
    their plain versions, and two calls give bitwise-equal output (fixed
    order, no atomics).  s=3: 8 cells, one ragged 16-cell tile; s=5, 7:
    tiles that cross rows of cells (4 and 8 cells a row); s=10: every tile
    one row of 16 cells (the row gather)."""
    pb = bp4.build(s, P, torch.float32, "split2m", device=cuda_device,
                   **FUSED)
    op = pb.op
    (u,) = _state(op, 1, seed=20 + s)
    got, again = fk.matvec(op, u), fk.matvec(op, u)
    torch.cuda.synchronize()
    assert _rel(got, fk._matvec_plain(op, u)) < TOL[torch.float32]
    assert torch.equal(got, again)
    x, g, d, h = _state(op, 4, seed=30 + s)
    prec = pb.inv_diag.reshape((1,) + op.n_nodes_axis).contiguous()
    scal = torch.tensor(SCAL, device=cuda_device)
    got = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    again = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    want = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
    for a, b in zip(got[:4], want[:4]):
        assert _rel(a, b) < TOL[torch.float32]
    assert ((got[4] - want[4]).abs() / want[4].abs().clamp_min(1e-30)
            ).max().item() < 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh", ["ragged", 3, 5, 7])
def test_highest_cell_pass_matches_plain_and_repeats(cuda_device, mesh,
                                                     dtype):
    """B1 and B2 under f32 and f64 highest run the sum-factorized pass with
    the metric rebuilt in the kernel: against their plain versions (the
    twostage form, summed in another order), and two calls give
    bitwise-equal output.  "ragged": 3 x 5 x 7 = 105 cells, not a multiple
    of a block's cells; s=3, 5, 7: 8, 32 and 128 cells."""
    if mesh == "ragged":
        layout = DofLayout(BoxMesh((3, 5, 7), 0.25), P)
        op = laplace_cuda.make_operator(layout, dtype, "highest",
                                        device=cuda_device, **FUSED)
        prec = (_state(op, 1, seed=5)[0][:1].abs() + 0.5) * op.mask
    else:
        pb = bp4.build(mesh, P, dtype, "highest", device=cuda_device, **FUSED)
        op = pb.op
        prec = pb.inv_diag.reshape((1,) + op.n_nodes_axis)
    prec = prec.contiguous()
    (u,) = _state(op, 1, seed=40)
    got, again = fk.matvec(op, u), fk.matvec(op, u)
    torch.cuda.synchronize()
    assert _rel(got, fk._matvec_plain(op, u)) < TOL[dtype]
    assert torch.equal(got, again)
    x, g, d, h = _state(op, 4, seed=41)
    scal = torch.tensor(SCAL, dtype=dtype, device=cuda_device)
    got = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    again = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    want = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
    for a, b in zip(got[:4], want[:4]):
        assert _rel(a, b) < TOL[dtype]
    scal_tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    assert ((got[4] - want[4]).abs() / want[4].abs().clamp_min(1e-30)
            ).max().item() < scal_tol
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_kernel_wrappers_check_their_arguments(cuda_device):
    pb = bp4.build(4, P, torch.float32, "split2m", device=cuda_device,
                   **FUSED)
    op = pb.op
    x, g, d, h = _state(op, 4, seed=2)
    prec = pb.inv_diag.reshape((1,) + op.n_nodes_axis).contiguous()
    scal = torch.tensor(SCAL, device=cuda_device)
    with pytest.raises(ValueError):
        fk.matvec(op, d.double())
    with pytest.raises(ValueError):
        fk.matvec(op, d.transpose(2, 3))
    with pytest.raises(ValueError, match="in place"):
        fk.fused_cg_iteration(op, x, g, d, h, scal, prec,
                              out=(x, g, d, h, scal))


@pytest.mark.cuda
def test_solve_on_card_matches_plain_solve(cuda_device):
    """The kernel solve and the plain solve (same problem, on the CPU)
    take the same iterations at p=4, s=5 in f64, with one kernel launch
    per iteration."""
    pb = bp4.build(5, P, torch.float64, "highest", device=cuda_device,
                   **FUSED)
    lat = pb.layout.n_nodes_axis
    args = (pb.b.reshape((3,) + lat), pb.inv_diag.reshape((1,) + lat))
    before = fk.fused_cg_iteration.launches
    res = cg_fused.fused_merged_cg_solve(pb.op, lat, *args)
    assert fk.fused_cg_iteration.launches - before == res.n_iterations
    cpu = bp4.build(5, P, torch.float64, "highest", device="cpu", **FUSED)
    ref = cg_fused.fused_merged_cg_solve(
        cpu.op, lat, *(a.cpu() for a in args))
    assert res.converged and res.n_iterations == ref.n_iterations
    assert _rel(res.x.cpu(), ref.x) < 1e-10


@pytest.mark.cuda
def test_run_one_on_card(cuda_device):
    r = benchmark.run_one(4, 5, solver="fused", precision="split2m",
                          windowing="pieces", solve_repeats=1,
                          matvec_repeats=1, matvec_inner=5,
                          device=cuda_device)
    assert r.converged and r.time_per_it > 0 and r.time_per_matvec > 0


RUNGS = [(torch.float32, "highest"), (torch.float32, "split2m"),
         (torch.float64, "highest")]
APPLY_CASES = [(p, kernel, dtype, precision)
               for p in (1, 2, 3, 4)
               for kernel in ("batched_g", "batched_onthefly", "pieces",
                              "zslab")
               for dtype, precision in RUNGS
               if not (kernel == "batched_onthefly" and precision == "split2m")]


@pytest.mark.cuda
@pytest.mark.parametrize("p,kernel,dtype,precision", APPLY_CASES)
def test_apply_kernel_matches_plain(cuda_device, p, kernel, dtype, precision):
    """B3 (batched_g), B4 (batched_onthefly), B5 (pieces), B6 (zslab) at
    every instantiated degree; at p=2 the mesh (2 cells, one interior
    node row) is smaller than one block's cells: the ragged tail."""
    s = {1: 4, 2: 1, 3: 4, 4: 5}[p]
    metric = "onthefly" if kernel == "batched_onthefly" else "precomputed"
    op = bp4.build(s, p, dtype, precision, factor="dense", metric=metric,
                   windowing="reshape", device=cuda_device).op
    (u,) = _state(op, 1, seed=p)
    if kernel.startswith("batched"):
        u_loc = la.to_cell_batches(u, p).contiguous()
        wrapper = (la.apply_local_batched_g if kernel == "batched_g"
                   else la.apply_local_batched_onthefly)
        args = (op, u_loc)
        want = la._batched_plain(op, u_loc, la._metric(op),
                                 precision == "split2m" and metric != "onthefly")
    else:
        wrapper = (la.apply_lattice_pieces if kernel == "pieces"
                   else la.apply_lattice_zslab)
        args = (op, u)
        want = la._lattice_plain(op, u, op.mask)
    before = wrapper.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert _rel(got, want) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "split2m"), (torch.float32, "highest"),
    (torch.float64, "highest")])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("kernel", ["batched_g", "zslab", "batched_onthefly"])
def test_split2m_kernels_ragged_and_deterministic(cuda_device, p, kernel,
                                                  dtype, precision):
    """The cell passes of B3 and B6 on every rung — the tensor-core pass
    (f32 split2m) and the sum-factorized pass (f32 and f64 highest) — and
    of B4 (the sum-factorized pass with the metric rebuilt, exact on every
    rung) on 3 x 5 x 7 = 105 cells, not a multiple of a block's cells (the
    ragged last block stores nothing past the end), against the plain
    version; two calls give bitwise-equal output (fixed order, no
    atomics)."""
    layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
    onthefly = kernel == "batched_onthefly"
    op = laplace_cuda.make_operator(
        layout, dtype, precision, factor="dense",
        metric="onthefly" if onthefly else "precomputed", device=cuda_device,
        windowing="reshape" if onthefly else "zslab")
    (u,) = _state(op, 1, seed=10 + p)
    if onthefly:
        x = la.to_cell_batches(u, p).contiguous()
        wrapper = la.apply_local_batched_onthefly
        want = la._batched_plain(op, x, la._metric(op), False)
    elif kernel == "batched_g":
        x = la.to_cell_batches(u, p).contiguous()
        wrapper = la.apply_local_batched_g
        want = la._batched_plain(op, x, la._metric(op),
                                 precision == "split2m")
    else:
        x, wrapper = u, la.apply_lattice_zslab
        want = la._lattice_plain(op, u, op.mask)
    got, again = wrapper(op, x), wrapper(op, x)
    torch.cuda.synchronize()
    assert _rel(got, want) < TOL[dtype]
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["merged", "baseline"])
@pytest.mark.parametrize("windowing", ["reshape", "pieces", "zslab"])
def test_solves_on_card_match_plain_solves(cuda_device, solver, windowing):
    """f64 at p=4, s=5: the card's solve takes the CPU plain solve's
    iterations and reaches its solution."""
    solve = bp4.solve_merged if solver == "merged" else bp4.solve_baseline
    kw = dict(factor="dense", metric="precomputed", windowing=windowing)
    res = solve(bp4.build(5, P, torch.float64, "highest", device=cuda_device,
                          **kw))
    ref = solve(bp4.build(5, P, torch.float64, "highest", device="cpu",
                          **kw))
    assert res.converged and res.n_iterations == ref.n_iterations
    assert _rel(res.x.cpu(), ref.x) < 1e-10


@pytest.mark.cuda
def test_run_one_merged_and_baseline_on_card(cuda_device):
    rows = [benchmark.run_one(4, 5, solver=solver, solve_repeats=1,
                              matvec_repeats=1, matvec_inner=5,
                              device=cuda_device)
            for solver in ("merged", "baseline")]
    assert all(r.converged and r.time_per_it > 0 for r in rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,precision", RUNGS)
@pytest.mark.parametrize("metric", ["precomputed", "onthefly"])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_dense_fused_kernels_match_plain_and_repeat(cuda_device, p, metric,
                                                    dtype, precision):
    """B1 and B2 in the dense configurations of the fused solver — the
    sum-factorized pass under f32/f64 highest, the dense tensor-core pass
    under f32 split2m, the metric streamed or rebuilt — on 3 x 5 x 7 = 105
    cells (a ragged last block) at every degree: against their plain
    versions, each twice and bitwise equal."""
    layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
    op = laplace_cuda.make_operator(layout, dtype, precision, factor="dense",
                                    metric=metric, windowing="pieces",
                                    device=cuda_device)
    prec = ((_state(op, 1, seed=6)[0][:1].abs() + 0.5) * op.mask).contiguous()
    (u,) = _state(op, 1, seed=50 + p)
    before = fk.matvec.launches
    got, again = fk.matvec(op, u), fk.matvec(op, u)
    torch.cuda.synchronize()
    assert fk.matvec.launches == before + 2
    assert _rel(got, fk._matvec_plain(op, u)) < TOL[dtype]
    assert torch.equal(got, again)
    x, g, d, h = _state(op, 4, seed=60 + p)
    scal = torch.tensor(SCAL, dtype=dtype, device=cuda_device)
    got = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    again = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    want = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
    for a, b in zip(got[:4], want[:4]):
        assert _rel(a, b) < TOL[dtype]
    scal_tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    assert ((got[4] - want[4]).abs() / want[4].abs().clamp_min(1e-30)
            ).max().item() < scal_tol
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,precision", RUNGS)
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_run_one_fused_every_degree_on_card(cuda_device, p, dtype,
                                            precision):
    """The fused solver at every degree through the auto-dispatch (dense +
    precomputed under highest; under split2m dense + precomputed at p=1, 3,
    dense + onthefly at p=2, twostage + onthefly at p=4): B1 and B2
    launch, and the solve converges."""
    before = fk.matvec.launches, fk.fused_cg_iteration.launches
    r = benchmark.run_one(p, 5, solver="fused", dtype=dtype,
                          precision=precision, windowing="pieces",
                          solve_repeats=1, matvec_repeats=1, matvec_inner=5,
                          device=cuda_device)
    assert fk.matvec.launches > before[0]
    assert fk.fused_cg_iteration.launches > before[1]
    assert r.converged and r.time_per_it > 0 and r.time_per_matvec > 0
