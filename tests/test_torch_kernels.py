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
from mf_data_locality_tpu_torch.utils import bf16_check, storage_check

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


HIGH = (5, 6, 7, 8, 9, 10, 11)
HIGHEST = [(torch.float32, "highest"), (torch.float64, "highest")]
# B1/B2 at p >= 5: the auto path's configuration, the metric rebuilt by
# each chain, the dense factorization
HIGH_FUSED = [("twostage", "precomputed", "adjj"),
              ("twostage", "onthefly", "jtj"),
              ("twostage", "onthefly", "adjj"),
              ("dense", "precomputed", "adjj")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,precision", HIGHEST)
@pytest.mark.parametrize("p", HIGH)
def test_high_degree_apply_kernels_match_plain(cuda_device, p, dtype,
                                               precision):
    """B3-B6 at p = 5..11 (the sum-factorized pass; from p=7 fewer cells a
    block) on 3 x 5 x 7 = 105 cells: against their plain versions, each
    twice and bitwise equal."""
    layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
    opg = laplace_cuda.make_operator(layout, dtype, precision,
                                     device=cuda_device)
    opo = laplace_cuda.make_operator(layout, dtype, precision,
                                     metric="onthefly", device=cuda_device)
    (u,) = _state(opg, 1, seed=70 + p)
    u_loc = la.to_cell_batches(u, p).contiguous()
    cases = [(la.apply_local_batched_g, opg, u_loc,
              lambda: la._batched_plain(opg, u_loc, la._metric(opg), False)),
             (la.apply_local_batched_onthefly, opo, u_loc,
              lambda: la._batched_plain(opo, u_loc, la._metric(opo), False)),
             (la.apply_lattice_pieces, opg, u,
              lambda: la._lattice_plain(opg, u, la._index_mask(opg))),
             (la.apply_lattice_zslab, opg, u,
              lambda: la._lattice_plain(opg, u, opg.mask))]
    for fn, op, arg, plain in cases:
        before = fn.launches
        got, again = fn(op, arg), fn(op, arg)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        assert _rel(got, plain()) < TOL[dtype]
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("config", HIGH_FUSED)
@pytest.mark.parametrize("dtype,precision", HIGHEST)
@pytest.mark.parametrize("p", HIGH)
def test_high_degree_fused_kernels_match_plain(cuda_device, p, dtype,
                                               precision, config):
    """B1 and B2 at p = 5..11 in the fused solver's configurations under
    highest (the metric streamed, or rebuilt by adjj or jtj) on 105 cells:
    against their plain versions, each twice and bitwise equal."""
    factor, metric, cofactor = config
    layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
    op = laplace_cuda.make_operator(layout, dtype, precision, factor=factor,
                                    metric=metric, cofactor=cofactor,
                                    windowing="pieces", device=cuda_device)
    prec = ((_state(op, 1, seed=6)[0][:1].abs() + 0.5) * op.mask).contiguous()
    (u,) = _state(op, 1, seed=80 + p)
    got, again = fk.matvec(op, u), fk.matvec(op, u)
    torch.cuda.synchronize()
    assert _rel(got, fk._matvec_plain(op, u)) < TOL[dtype]
    assert torch.equal(got, again)
    x, g, d, h = _state(op, 4, seed=90 + p)
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
@pytest.mark.parametrize("p", HIGH)
def test_run_one_every_path_high_degree_on_card(cuda_device, p):
    """At p = 5..11 the JAX CLI's default path (merged, reshape: B3), the
    fused auto path under f64 (twostage + precomputed: B1, B2) and the
    fused solver with the metric rebuilt (jtj) launch their kernels and
    converge, or from p=8 reach the 100-iteration cap at s=4 as their
    plain versions do; so does the default path under split2m (B3 on the
    dense tensor-core pass)."""
    wrappers = (la.apply_local_batched_g, fk.matvec, fk.fused_cg_iteration)
    before = [w.launches for w in wrappers]
    short = dict(solve_repeats=1, matvec_repeats=1, matvec_inner=2,
                 device=cuda_device)
    rows = [benchmark.run_one(p, 4, **short),
            benchmark.run_one(p, 4, solver="fused", dtype=torch.float64,
                              windowing="pieces", **short),
            benchmark.run_one(p, 4, solver="fused", windowing="pieces",
                              metric="onthefly", **short)]
    assert all(w.launches > b for w, b in zip(wrappers, before))
    assert all((r.converged if p < 8 else r.n_iterations == 100)
               and r.time_per_it > 0 for r in rows)
    before = la.apply_local_batched_g.launches
    r = benchmark.run_one(p, 4, precision="split2m", **short)
    assert la.apply_local_batched_g.launches > before
    assert (r.converged or r.n_iterations == 100) and r.time_per_it > 0


# B1/B2 under f32 split2m in twostage: (metric, cofactor); at p=1..3 and
# from p=5 the tensor-core pass of csrc/cell_mma_hd.cuh, at p=4 that of
# cell_mma.cuh with the metric rebuilt and cell_mma_hd.cuh's with it
# streamed
SPLIT_TWOSTAGE = [("onthefly", "jtj"), ("onthefly", "adjj"),
                  ("precomputed", "adjj")]


@pytest.mark.cuda
@pytest.mark.parametrize("metric,cofactor", SPLIT_TWOSTAGE)
@pytest.mark.parametrize("p", (1, 2, 3, 4) + HIGH)
def test_split2m_twostage_kernels_match_plain(cuda_device, p, metric,
                                              cofactor):
    """B1 and B2 under f32 split2m in twostage at p = 1..11 (the metric
    rebuilt by jtj or adjj, or streamed) on 3 x 5 x 7 = 105 cells, not a
    multiple of the 8 cells of a task: against their plain versions, each
    twice and bitwise equal, each launch counted."""
    layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
    op = laplace_cuda.make_operator(layout, torch.float32, "split2m",
                                    factor="twostage", metric=metric,
                                    cofactor=cofactor, windowing="pieces",
                                    device=cuda_device)
    prec = ((_state(op, 1, seed=6)[0][:1].abs() + 0.5) * op.mask).contiguous()
    (u,) = _state(op, 1, seed=110 + p)
    before = fk.matvec.launches, fk.fused_cg_iteration.launches
    got, again = fk.matvec(op, u), fk.matvec(op, u)
    torch.cuda.synchronize()
    assert _rel(got, fk._matvec_plain(op, u)) < TOL[torch.float32]
    assert torch.equal(got, again)
    x, g, d, h = _state(op, 4, seed=120 + p)
    scal = torch.tensor(SCAL, device=cuda_device)
    got = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    again = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    want = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
    for a, b in zip(got[:4], want[:4]):
        assert _rel(a, b) < TOL[torch.float32]
    assert ((got[4] - want[4]).abs() / want[4].abs().clamp_min(1e-30)
            ).max().item() < 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (fk.matvec.launches, fk.fused_cg_iteration.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("p", HIGH)
def test_run_one_fused_split2m_high_degree_on_card(cuda_device, p):
    """At p = 5..11 the fused solver under split2m through the
    auto-dispatch (twostage + onthefly + jtj) launches B1 and B2 and
    converges, or from p=8 reaches the 100-iteration cap at s=4 as the
    ``highest`` paths do; so does its dense factorization, on the dense
    tensor-core pass (``csrc/apply_mma_hd.cuh``)."""
    before = fk.matvec.launches, fk.fused_cg_iteration.launches
    short = dict(solve_repeats=1, matvec_repeats=1, matvec_inner=2,
                 device=cuda_device)
    r = benchmark.run_one(p, 4, solver="fused", windowing="pieces",
                          precision="split2m", **short)
    assert fk.matvec.launches > before[0]
    assert fk.fused_cg_iteration.launches > before[1]
    assert (r.converged if p < 8 else r.n_iterations == 100)
    assert r.time_per_it > 0
    before = fk.matvec.launches, fk.fused_cg_iteration.launches
    r = benchmark.run_one(p, 4, solver="fused", windowing="pieces",
                          precision="split2m", factor="dense", **short)
    assert fk.matvec.launches > before[0]
    assert fk.fused_cg_iteration.launches > before[1]
    assert (r.converged if p < 8 else r.n_iterations == 100)
    assert r.time_per_it > 0


# the reduced rungs: (precision, state dtype, metric dtype) — split3, bf16
# with an f32 state, bf16 with the bf16 state and the bf16 metric stream
REDUCED = [("split3", torch.float32, None), ("bf16", torch.float32, None),
           ("bf16", torch.bfloat16, torch.bfloat16)]
# B1/B2's configurations under them: dense at p=1..11 (from p=5 the dense
# pass of csrc/apply_mma_hd.cuh; the metric rebuilt by jtj too,
# csrc/mma_jtj.cu), twostage at p=1..11
REDUCED_CONFIGS = ([(p, "dense", m, "adjj") for p in (1, 2, 3, 4) + HIGH
                    for m in ("precomputed", "onthefly")]
                   + [(p, "twostage", m, c) for p in (4,) + HIGH
                      for m, c in SPLIT_TWOSTAGE]
                   + [(p, "twostage", m, c) for p in (1, 2, 3)
                      for m, c in SPLIT_TWOSTAGE]
                   + [(p, "dense", "onthefly", "jtj")
                      for p in (1, 2, 3, 4) + HIGH])


def _close(rung, got, want):
    """Kernel vs plain at the rung's tolerance: split3 as f32; bf16
    relative L2 3e-4 and max 1e-2 (a t value the two sum in another order
    can round to the other side of a bf16 boundary, 2^-8 of it).  The L2
    limit lies between the bf16 readings (kernel vs plain) and those of
    split2m's product set in place of bf16's (``bf16_check.control_op``),
    both printed by ``utils/bf16_check.py`` for this box and these
    inputs."""
    if rung != "bf16":
        return _rel(got, want) < TOL[torch.float32]
    return (bf16_check.l2(got, want) <= 3e-4
            and _rel(got.double(), want.double()) <= 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,state,mdt", REDUCED)
@pytest.mark.parametrize("p,factor,metric,cofactor", REDUCED_CONFIGS)
def test_reduced_rung_fused_kernels_match_plain(cuda_device, p, factor,
                                                metric, cofactor, precision,
                                                state, mdt):
    """B1 and B2 under split3 and bf16 (f32 state; bf16 state with the bf16
    metric) in every configuration of ``fused_configs`` on 3 x 5 x 7 = 105
    cells: against their plain versions at the rung's tolerance (the
    scalars 1e-4), each twice and bitwise equal, each launch counted; under
    bf16 the plain version with split2m's product set is refused, and with
    the bf16 state the scalars see the rounding point of d'
    (``bf16_check.rounding_point``: the unrounded-d' variant misses 1e-4)."""
    layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
    op = laplace_cuda.make_operator(
        layout, state, precision, factor=factor, metric=metric,
        cofactor=cofactor, windowing="pieces", device=cuda_device,
        metric_dtype=mdt if metric == "precomputed" else None)
    prec = ((_state(op, 1, seed=6)[0][:1].abs() + 0.5) * op.mask).contiguous()
    (u,) = (v.to(state) for v in _state(op, 1, seed=130 + p))
    before = fk.matvec.launches, fk.fused_cg_iteration.launches
    got, again = fk.matvec(op, u), fk.matvec(op, u)
    torch.cuda.synchronize()
    assert got.dtype == state
    assert _close(precision, got, fk._matvec_plain(op, u))
    if precision == "bf16":
        ctl = fk._matvec_plain(bf16_check.control_op(op), u)
        assert bf16_check.l2(got, ctl) > 3e-4
    assert torch.equal(got, again)
    x, g, d, h = _state(op, 4, seed=140 + p)
    d, h = d.to(state), h.to(state)
    scal = torch.tensor(SCAL, device=cuda_device)
    got = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    again = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    want = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and _close(precision, a, b)
    assert ((got[4] - want[4]).abs() / want[4].abs().clamp_min(1e-30)
            ).max().item() < 1e-4
    if precision == "bf16":
        ctl = fk._fused_iteration_plain(bf16_check.control_op(op), x, g, d,
                                        h, scal, prec)
        assert bf16_check.l2(got[3], ctl[3]) > 3e-4
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (fk.matvec.launches, fk.fused_cg_iteration.launches) == (
        before[0] + 2, before[1] + 2)
    if state == torch.bfloat16:
        err, control = bf16_check.rounding_point(op, seed=160 + p)
        assert err < 1e-4 < control


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", [None, torch.bfloat16])
@pytest.mark.parametrize("precision", ["split3", "bf16"])
@pytest.mark.parametrize("p", (1, 2, 3, 4) + HIGH)
@pytest.mark.parametrize("kernel", ["batched_g", "pieces", "zslab"])
def test_reduced_rung_apply_kernels_match_plain(cuda_device, kernel, p,
                                                precision, mdt):
    """B3, B5 and B6 under split3 and bf16, the metric streamed in f32 or
    bf16, on 105 cells (p <= 4 ``csrc/apply_mma.cuh``, from p=5
    ``csrc/apply_mma_hd.cuh``): against the plain version at the rung's
    tolerance, twice and bitwise equal; under bf16 the plain version with
    split2m's product set is refused."""
    layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
    op = laplace_cuda.make_operator(
        layout, torch.float32, precision, factor="dense",
        metric="precomputed", device=cuda_device,
        windowing="reshape" if kernel == "batched_g" else kernel,
        metric_dtype=mdt)
    (u,) = _state(op, 1, seed=150 + p)
    if kernel == "batched_g":
        x = la.to_cell_batches(u, p).contiguous()
        wrapper = la.apply_local_batched_g
        want = la._batched_plain(op, x, la._metric(op), True)
    else:
        x = u
        wrapper = (la.apply_lattice_pieces if kernel == "pieces"
                   else la.apply_lattice_zslab)
        want = la._lattice_plain(op, u, la._index_mask(op)
                                 if kernel == "pieces" else op.mask)
    before = wrapper.launches
    got, again = wrapper(op, x), wrapper(op, x)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert _close(precision, got, want)
    if precision == "bf16":
        ctl_op = bf16_check.control_op(op)
        ctl = (la._batched_plain(ctl_op, x, la._metric(op), True)
               if kernel == "batched_g" else la._lattice_plain(
                   ctl_op, u, la._index_mask(op)
                   if kernel == "pieces" else op.mask))
        assert bf16_check.l2(got, ctl) > 3e-4
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,state,mdt", [REDUCED[0], REDUCED[2]])
@pytest.mark.parametrize("p", (1, 2, 3, 4) + HIGH)
def test_run_one_fused_reduced_rungs_on_card(cuda_device, p, precision,
                                             state, mdt):
    """The fused solver under split3 (f32 state) and bf16 (the bf16 state
    and metric) through the auto-dispatch at every degree launches B1 and
    B2 and gives a finite row; so does the merged solver under the rung,
    launching B3."""
    before = (fk.matvec.launches, fk.fused_cg_iteration.launches,
              la.apply_local_batched_g.launches)
    short = dict(solve_repeats=1, matvec_repeats=1, matvec_inner=2,
                 device=cuda_device, precision=precision, metric_dtype=mdt)
    r = benchmark.run_one(p, 4, solver="fused", windowing="pieces",
                          dtype=state, **short)
    assert fk.matvec.launches > before[0]
    assert fk.fused_cg_iteration.launches > before[1]
    assert 0 < r.n_iterations <= 100 and r.time_per_it > 0
    r = benchmark.run_one(p, 4, solver="merged", **short)
    assert la.apply_local_batched_g.launches > before[2]
    assert r.converged or r.n_iterations == 100


@pytest.mark.cuda
@pytest.mark.parametrize("p", HIGH)
def test_split2m_dense_kernels_match_plain(cuda_device, p):
    """The dense tensor-core pass at p=5..11 under split2m
    (``csrc/apply_mma_hd.cuh``) on 105 cells: B3, B5 and B6 (B5 also on
    the twostage operator of the merged solver's ``pieces``, which reads
    the dense M) and B1/B2 dense with the metric streamed and rebuilt,
    each against its plain version (1e-5; B2's scalars 1e-4), twice and
    bitwise equal, each launch counted."""
    layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
    (u,) = _state(laplace_cuda.make_operator(
        layout, torch.float32, "split2m", device=cuda_device), 1, seed=170)
    for factor in ("dense", "twostage"):
        op = laplace_cuda.make_operator(
            layout, torch.float32, "split2m", factor=factor,
            metric="precomputed", windowing="pieces", device=cuda_device)
        cases = {la.apply_lattice_pieces: (
            u, la._lattice_plain(op, u, la._index_mask(op)))}
        if factor == "dense":
            x = la.to_cell_batches(u, p).contiguous()
            cases[la.apply_local_batched_g] = (
                x, la._batched_plain(op, x, la._metric(op), True))
            cases[la.apply_lattice_zslab] = (
                u, la._lattice_plain(op, u, op.mask))
        for wrapper, (arg, want) in cases.items():
            before = wrapper.launches
            got, again = wrapper(op, arg), wrapper(op, arg)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 2
            assert _rel(got, want) < TOL[torch.float32], (factor, wrapper)
            assert torch.equal(got, again)
    for metric in ("precomputed", "onthefly"):
        op = laplace_cuda.make_operator(
            layout, torch.float32, "split2m", factor="dense", metric=metric,
            windowing="pieces", device=cuda_device)
        prec = ((_state(op, 1, seed=6)[0][:1].abs() + 0.5)
                * op.mask).contiguous()
        before = fk.matvec.launches, fk.fused_cg_iteration.launches
        got, again = fk.matvec(op, u), fk.matvec(op, u)
        assert _rel(got, fk._matvec_plain(op, u)) < TOL[torch.float32]
        assert torch.equal(got, again)
        x, g, d, h = _state(op, 4, seed=180 + p)
        scal = torch.tensor(SCAL, device=cuda_device)
        got = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
        again = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
        want = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
        for a, b in zip(got[:4], want[:4]):
            assert _rel(a, b) < TOL[torch.float32]
        assert ((got[4] - want[4]).abs() / want[4].abs().clamp_min(1e-30)
                ).max().item() < 1e-4
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert (fk.matvec.launches, fk.fused_cg_iteration.launches) == (
            before[0] + 2, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("p", (1, 2, 3, 4) + HIGH)
def test_split2m_dense_jtj_kernels_match_plain(cuda_device, p):
    """B1 and B2 dense with the metric rebuilt by jtj under split2m
    (the dense tensor-core passes' kJtjChain instantiations,
    ``csrc/mma_jtj.cu`` to p=4, ``apply_mma_pNN.cu`` from p=5) on 105 cells against their plain versions (1e-5; B2's
    scalars 1e-4), twice and bitwise equal, each launch counted; and at
    p <= 4 B5 on the twostage operator of the merged solver's ``--factor
    twostage --windowing pieces`` (the dense tables) against its plain
    version."""
    layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
    op = laplace_cuda.make_operator(
        layout, torch.float32, "split2m", factor="dense", metric="onthefly",
        cofactor="jtj", windowing="pieces", device=cuda_device)
    prec = ((_state(op, 1, seed=6)[0][:1].abs() + 0.5) * op.mask).contiguous()
    (u,) = _state(op, 1, seed=190 + p)
    before = fk.matvec.launches, fk.fused_cg_iteration.launches
    got, again = fk.matvec(op, u), fk.matvec(op, u)
    assert _rel(got, fk._matvec_plain(op, u)) < TOL[torch.float32]
    assert torch.equal(got, again)
    x, g, d, h = _state(op, 4, seed=200 + p)
    scal = torch.tensor(SCAL, device=cuda_device)
    got = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    again = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    want = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
    for a, b in zip(got[:4], want[:4]):
        assert _rel(a, b) < TOL[torch.float32]
    assert ((got[4] - want[4]).abs() / want[4].abs().clamp_min(1e-30)
            ).max().item() < 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (fk.matvec.launches, fk.fused_cg_iteration.launches) == (
        before[0] + 2, before[1] + 2)
    if p <= 4:
        op = laplace_cuda.make_operator(
            layout, torch.float32, "split2m", factor="twostage",
            metric="precomputed", windowing="pieces", device=cuda_device)
        before = la.apply_lattice_pieces.launches
        got = la.apply_lattice_pieces(op, u)
        assert la.apply_lattice_pieces.launches == before + 1
        assert _rel(got, la._lattice_plain(op, u, la._index_mask(op))) < \
            TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("p", HIGH)
def test_run_one_merged_split2m_high_degree_on_card(cuda_device, p):
    """The merged and baseline solvers under split2m at p=5..11 on every
    windowing (pieces on the twostage operator the resolvers give) launch
    B3, B5 or B6 on the dense tensor-core pass and give a finite row."""
    short = dict(solve_repeats=1, matvec_repeats=1, matvec_inner=2,
                 device=cuda_device, precision="split2m")
    for solver, windowing, wrapper in (
            ("merged", "reshape", la.apply_local_batched_g),
            ("merged", "pieces", la.apply_lattice_pieces),
            ("baseline", "zslab", la.apply_lattice_zslab)):
        before = wrapper.launches
        r = benchmark.run_one(p, 4, solver=solver, windowing=windowing,
                              **short)
        assert wrapper.launches > before
        assert 0 < r.n_iterations <= 100 and r.time_per_it > 0


STORAGE_RUNGS = [("highest", torch.float32), ("highest", torch.float64),
                 ("split2m", torch.float32), ("split3", torch.float32),
                 ("bf16", torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision,dtype", STORAGE_RUNGS)
@pytest.mark.parametrize("p", (1, 2, 3, 4) + HIGH)
def test_fused_storage_kernels_match_plain(cuda_device, p, precision, dtype):
    """B2 with P or x stored in bf16 (``csrc/cg_fused_px.cu``) in every
    configuration of ``fused_configs`` on 105 cells, bf16 with its bf16
    state (``utils.storage_check.compare``): with x in bf16, g', d', h' and
    the scalars bitwise equal to the working-x kernel's and x' within one
    bf16 step of the plain version; with P in bf16 (and with both) the
    kernel against the plain version at the rung's tolerance, and the
    plain version with P unrounded (the control) outside it."""
    layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
    key = "highest64" if dtype == torch.float64 else precision
    state = torch.bfloat16 if precision == "bf16" else dtype
    before = fk.fused_cg_iteration.launches
    n = 0
    for factor, metric in laplace_cuda.fused_configs(precision, p):
        chains = ("adjj", "jtj") if metric == "onthefly" else ("adjj",)
        for cofactor in chains:
            op = laplace_cuda.make_operator(
                layout, dtype, precision, factor=factor, metric=metric,
                cofactor=cofactor, windowing="pieces", device=cuda_device)
            ok, report = storage_check.compare(op, cuda_device, state,
                                               storage_check.TOL[key])
            assert ok, (factor, metric, cofactor, report)
            n += 1
    assert fk.fused_cg_iteration.launches == before + 4 * n


@pytest.mark.cuda
@pytest.mark.parametrize("p,precision", [(2, "highest"), (4, "split2m"),
                                         (6, "split2m"), (6, "highest")])
def test_fused_storage_solves_on_card(cuda_device, p, precision):
    """The fused solver with x in bf16 takes the working-x solve's history
    bit for bit; with P in bf16 it converges within 3 iterations of it
    (``tests/test_cg_fused.py:332``); ``run_one`` takes both flags."""
    factor, metric, cofactor = benchmark.resolve_config(
        p, "fused", "pieces", precision, torch.float32)
    pb = bp4.build(5, p, torch.float32, precision, factor=factor,
                   metric=metric, cofactor=cofactor, windowing="pieces",
                   device=cuda_device)
    ref = benchmark.solver_call(pb, "fused")()
    rx = benchmark.solver_call(pb, "fused", x_dtype=torch.bfloat16)()
    rp = benchmark.solver_call(pb, "fused", prec_dtype=torch.bfloat16)()
    n = ref.n_iterations
    assert rx.n_iterations == n
    assert torch.equal(rx.res_history[:n + 1], ref.res_history[:n + 1])
    assert abs(rp.n_iterations - n) <= 3 and rp.converged == ref.converged
    before = fk.fused_cg_iteration.launches
    r = benchmark.run_one(p, 5, solver="fused", windowing="pieces",
                          precision=precision, prec_dtype=torch.bfloat16,
                          x_dtype=torch.bfloat16, problem=pb,
                          solve_repeats=1, matvec_repeats=1, matvec_inner=2,
                          device=cuda_device)
    assert fk.fused_cg_iteration.launches > before
    assert 0 < r.n_iterations <= 100 and r.time_per_it > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("backend", ["structured", "general"])
def test_plain_backends_on_card(cuda_device, backend, dtype):
    """``--backend structured|general`` on the card: vmult against B3 (the
    JAX CLI's default operator) at 1e-5 (f32) / 1e-12 (f64) relative L2,
    and ``run_one`` of both solvers, the f64 count equal to B3's."""
    ref = bp4.build(6, 3, dtype, "highest", device=cuda_device)
    pb = bp4.build(6, 3, dtype, device=cuda_device, backend=backend)
    u = torch.randn(ref.b.shape, device=cuda_device, dtype=dtype,
                    generator=torch.Generator(device=cuda_device)
                    .manual_seed(5))
    want = ref.a_apply_full(u)
    err = torch.linalg.norm(pb.a_apply_full(u) - want) / torch.linalg.norm(
        want)
    assert err.item() <= TOL[dtype]
    for solver in ("merged", "baseline"):
        r = benchmark.run_one(3, 6, solver=solver, dtype=dtype,
                              backend=backend, problem=pb, solve_repeats=1,
                              matvec_repeats=1, matvec_inner=2,
                              device=cuda_device)
        assert 0 < r.n_iterations <= 100 and r.time_per_it > 0
        if dtype == torch.float64:
            assert r.n_iterations == benchmark.solver_call(
                ref, solver)().n_iterations


# B2's block form (the distributed fused solver's): (rung, state dtype) on
# the two slabs of the s=9 mesh over 3 ranks (rank 1: a halo plane above;
# rank 2: one dummy layer)
SLAB_RUNGS = [("highest", torch.float64), ("highest", torch.float32),
              ("split2m", torch.float32), ("split3", torch.float32),
              ("bf16", torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["precomputed", "onthefly"])
@pytest.mark.parametrize("precision,state", SLAB_RUNGS)
@pytest.mark.parametrize("p", [2, 4, 6])
def test_slab_form_matches_plain(cuda_device, p, precision, state, metric):
    """B2's block form on z-slab operators (``bp4_fused_iteration_block``
    on blocks of a (3,) mesh: the Dirichlet faces by global position, the
    raw sums over the owned planes, the carry in h''s top plane) against
    its plain version: every plane of x',
    g', d', h' and the 7 sums at the rung's tolerance (bf16 with its
    state: relative L2 3e-4, sums 1e-4, split2m's product set refused);
    twice, bitwise equal."""
    from mf_data_locality_tpu_torch.parallel import distributed

    for rank in (1, 2):
        op = distributed.build_slab(9, p, rank, 3, state, "pallas",
                                    precision, "pieces", metric,
                                    cuda_device).op
        x, g, d, h = _state(op, 4, 170 + rank)
        d, h = d.to(state).contiguous(), h.to(state).contiguous()
        prec = ((_state(op, 1, 6)[0][:1].abs() + 0.5) * op.mask).contiguous()
        scal = torch.tensor(SCAL, device=cuda_device, dtype=op.dtype)
        got = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
        again = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
        want = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert got[4][7] == 0
        if precision == "bf16":
            ctl = fk._fused_iteration_plain(bf16_check.control_op(op), x, g,
                                            d, h, scal, prec)
            assert max(bf16_check.l2(a, b)
                       for a, b in zip(got[:4], want[:4])) <= 3e-4
            assert bf16_check.scal_err(got[4], want[4]) <= 1e-4
            assert bf16_check.l2(got[3], ctl[3]) > 3e-4
            err, unrounded = bf16_check.rounding_point(op, 190 + p)
            assert err <= 1e-4 < unrounded
        else:
            for a, b in zip(got[:4], want[:4]):
                assert _rel(a, b) <= TOL[op.dtype]
            assert bf16_check.scal_err(got[4][:7], want[4][:7]) <= (
                1e-4 if op.dtype == torch.float32 else 1e-11)


# blocks of the s=9 mesh: every ghost face an upper neighbour's ((2, 2),
# (2, 2, 2)), and one at the global top on z and x with a dummy x column
BLOCKS = [((2, 2), (0, 0)), ((2, 2, 2), (0, 0, 0)), ((2, 1, 3), (1, 0, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["precomputed", "onthefly"])
@pytest.mark.parametrize("precision,state", SLAB_RUNGS)
@pytest.mark.parametrize("p", [2, 4, 6])
def test_block_form_matches_plain(cuda_device, p, precision, state, metric):
    """B2 on block operators (``bp4_fused_iteration_block``: the Dirichlet
    faces by global position on every axis, the raw sums over the owned
    nodes, h''s ghost faces the partial sums owed upward) against its plain
    version, as test_slab_form_matches_plain holds it on z-slabs."""
    from mf_data_locality_tpu_torch.parallel import distributed

    for k, (mesh, coords) in enumerate(BLOCKS):
        op = distributed.build_block(9, p, coords, mesh, state, "pallas",
                                     precision, "pieces", metric,
                                     cuda_device).op
        x, g, d, h = _state(op, 4, 270 + k)
        d, h = d.to(state).contiguous(), h.to(state).contiguous()
        prec = ((_state(op, 1, 6)[0][:1].abs() + 0.5) * op.mask).contiguous()
        scal = torch.tensor(SCAL, device=cuda_device, dtype=op.dtype)
        got = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
        again = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
        want = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert got[4][7] == 0
        if precision == "bf16":
            ctl = fk._fused_iteration_plain(bf16_check.control_op(op), x, g,
                                            d, h, scal, prec)
            assert max(bf16_check.l2(a, b)
                       for a, b in zip(got[:4], want[:4])) <= 3e-4
            assert bf16_check.scal_err(got[4], want[4]) <= 1e-4
            assert bf16_check.l2(got[3], ctl[3]) > 3e-4
            err, unrounded = bf16_check.rounding_point(op, 290 + p)
            assert err <= 1e-4 < unrounded
        else:
            for a, b in zip(got[:4], want[:4]):
                assert _rel(a, b) <= TOL[op.dtype]
            assert bf16_check.scal_err(got[4][:7], want[4][:7]) <= (
                1e-4 if op.dtype == torch.float32 else 1e-11)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [(2, 2), (2, 2, 2), (2, 2, True)])
def test_mesh_solves_on_card(cuda_device, mesh):
    """The fused, merged and baseline solvers on a (2, 2) and a (2, 2, 2)
    rank mesh sharing the card, and the fused one on a 2-level (2, 2)
    grid: at p=2 s=6 in f64 the single-device solve's itCG and x within
    1e-11 max(1, |x|), one all-reduce an iteration, every iteration
    through the kernels (B2's block form; B3)."""
    from mf_data_locality_tpu_torch.parallel import distributed

    two_level = mesh[-1] is True
    shape = mesh[:2] if two_level else mesh
    solvers = ("fused",) if two_level else ("fused", "merged", "baseline")
    jobs = [distributed.Job(solver, 6, 2, mesh_shape=shape,
                            two_level=two_level) for solver in solvers]
    fpb = bp4.build(6, 2, torch.float64, device=cuda_device, factor="dense",
                    metric="precomputed", windowing="pieces")
    lat = (3,) + fpb.layout.n_nodes_axis
    mpb = bp4.build(6, 2, torch.float64, device=cuda_device)
    refs = [cg_fused.fused_merged_cg_solve(
                fpb.op, lat[1:], fpb.b.reshape(lat),
                fpb.inv_diag.reshape((1,) + lat[1:])),
            bp4.solve_merged(mpb), bp4.solve_baseline(mpb)]
    n = 4 if len(shape) == 2 else 8
    for job, got, ref in zip(jobs, distributed.launch(jobs, n, "cuda"),
                             refs):
        x1 = ref.x.reshape(lat).cpu()
        assert got["it"] == ref.n_iterations
        assert (got["x"] - x1).abs().max() <= 1e-11 * max(1.0,
                                                          x1.abs().max())
        kern = ("fused_cg_iteration" if job.solver == "fused"
                else "apply_local_batched_g")
        assert sum(r["launches_solve"][kern] for r in got["ranks"]) == (
            n * got["it"])
        if job.solver != "baseline":
            assert all(r["allreduces"] == got["it"] + 1
                       for r in got["ranks"])


@pytest.mark.cuda
def test_b1_refuses_slab_operators(cuda_device):
    from mf_data_locality_tpu_torch.parallel import distributed

    op = distributed.build_slab(6, 2, 1, 2, torch.float64, "pallas",
                                "highest", "pieces", "precomputed",
                                cuda_device).op
    with pytest.raises(NotImplementedError, match="runs B5"):
        fk.matvec(op, _state(op, 1, 3)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3])
def test_distributed_solves_on_card(cuda_device, n):
    """The fused, merged and baseline solvers on n ranks sharing the card
    (gloo): at p=2 s=6 in f64 the single-device solve's itCG and x within
    1e-11 max(1, |x|), one all-reduce a merged or fused iteration, and
    every iteration through the kernels (B2's block form; B3)."""
    from mf_data_locality_tpu_torch.parallel import distributed

    jobs = [distributed.Job(solver, 6, 2) for solver in
            ("fused", "merged", "baseline")]
    fpb = bp4.build(6, 2, torch.float64, device=cuda_device, factor="dense",
                    metric="precomputed", windowing="pieces")
    lat = (3,) + fpb.layout.n_nodes_axis
    mpb = bp4.build(6, 2, torch.float64, device=cuda_device)
    refs = [cg_fused.fused_merged_cg_solve(
                fpb.op, lat[1:], fpb.b.reshape(lat),
                fpb.inv_diag.reshape((1,) + lat[1:])),
            bp4.solve_merged(mpb), bp4.solve_baseline(mpb)]
    for job, got, ref in zip(jobs, distributed.launch(jobs, n, "cuda"),
                             refs):
        x1 = ref.x.reshape(lat).cpu()
        assert got["it"] == ref.n_iterations
        assert (got["x"] - x1).abs().max() <= 1e-11 * max(1.0,
                                                          x1.abs().max())
        kern = ("fused_cg_iteration" if job.solver == "fused"
                else "apply_local_batched_g")
        assert sum(r["launches_solve"][kern] for r in got["ranks"]) == (
            n * got["it"])
        if job.solver != "baseline":
            assert all(r["allreduces"] == got["it"] + 1
                       for r in got["ranks"])


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["precomputed", "onthefly"])
@pytest.mark.parametrize("precision,state", SLAB_RUNGS)
@pytest.mark.parametrize("p", [2, 4, 6])
def test_layer_range_form_is_the_one_launch(cuda_device, p, precision, state,
                                            metric):
    """B2's layer-range form (``fused_cg_iteration`` with ``cells``, then
    ``fused_cg_assemble``: ``bp4_fused_iteration_block``'s cell pass over
    a range of cells, then its node passes) on z-slabs of 3 cell layers
    (rank 1 with a halo plane, rank 2 with a dummy layer): the ranges
    [0, 2) + [2, 3) and [0, 1) + [1, 3) give x', g', d', h' and the sums
    bitwise the one launch's."""
    from mf_data_locality_tpu_torch.parallel import distributed

    for rank in (1, 2):
        op = distributed.build_slab(9, p, rank, 3, state, "pallas",
                                    precision, "pieces", metric,
                                    cuda_device).op
        x, g, d, h = _state(op, 4, 370 + rank)
        d, h = d.to(state).contiguous(), h.to(state).contiguous()
        prec = ((_state(op, 1, 6)[0][:1].abs() + 0.5) * op.mask).contiguous()
        scal = torch.tensor(SCAL, device=cuda_device, dtype=op.dtype)
        want = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
        for cut in (2, 1):
            out = tuple(torch.full_like(t, float("nan"))
                        for t in (x, g, d, h, scal))
            work = fk.Workspace(op)
            for cells in ((0, cut), (cut, 3)):
                fk.fused_cg_iteration(op, x, g, d, h, scal, prec, out=out,
                                      work=work, cells=cells)
            fk.fused_cg_assemble(op, out, prec, scal, work)
            assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
@pytest.mark.parametrize("windowing", ["reshape", "pieces", "zslab"])
@pytest.mark.parametrize("precision,dtype", [("highest", torch.float64),
                                             ("highest", torch.float32),
                                             ("split2m", torch.float32)])
@pytest.mark.parametrize("p", [2, 4, 6])
def test_sub_range_applies_match_plain(cuda_device, windowing, precision,
                                       dtype, p):
    """B3/B5/B6 on a z-slab's operator and on those of its cell-layer
    sub-ranges (``laplace_cuda.sub_operator``, the overlapped apply's)
    against their plain versions at the rung's tolerance: B5/B6 on a
    block's lattice keep the partial sums of its faces (the halo exchange
    completes them), the mask tensor's zeros aside."""
    from mf_data_locality_tpu_torch.parallel import distributed

    op, cpu = (distributed.build_slab(9, p, 1, 2, dtype, "pallas",
                                      precision, windowing, "precomputed",
                                      dev).op
               for dev in (cuda_device, "cpu"))
    u = _state(op, 1, 9)[0]
    for c0, c1 in ((0, 4), (0, 1), (1, 3), (3, 4)):
        us = u[:, c0 * p:c1 * p + 1].contiguous()
        got = la.apply_lattice(laplace_cuda.sub_operator(op, c0, c1), us)
        want = la.apply_lattice(laplace_cuda.sub_operator(cpu, c0, c1),
                                us.cpu())
        assert _rel(got.cpu(), want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("p", range(1, 12))
def test_shape_kernels_match_plain(cuda_device, p):
    """The shapes beyond BP4's (one component, q = p + 1, both; queue B
    item 6g): B3-B6 and B1/B2 in every fused configuration under highest
    (f32, f64) and split2m against their plain versions on the 105-cell
    box (``utils/shape_check.compare_degree``: 1e-5 f32, 1e-12 f64)."""
    from mf_data_locality_tpu_torch.utils import shape_check

    worst = shape_check.compare_degree(p, cuda_device)
    assert {k[0] for k in worst} == {"bp3", "q1", "bp3_q1"}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (3, 1)])
@pytest.mark.parametrize("solver,precision", [("merged", "highest"),
                                              ("fused", "highest"),
                                              ("fused", "split2m")])
def test_shape_solves_on_card(cuda_device, shape, solver, precision):
    """BP3 and q = p + 1 through ``run_one(problem=)`` on the card at p=4
    s=7: the f64 itCG of the parity points (BP3 93, q = p + 1 91) under
    highest at f64, split2m within +0..3 of it (or C8's cap)."""
    c, dq = shape
    dtype = torch.float64 if precision == "highest" else torch.float32
    config = benchmark.resolve_config(4, solver, "pieces" if solver ==
                                      "fused" else "reshape", precision,
                                      dtype)
    kw = dict(zip(("factor", "metric", "cofactor"), config))
    windowing = "pieces" if solver == "fused" else "reshape"
    pb = bp4.build(7, 4, dtype, precision, windowing=windowing,
                   device=cuda_device, n_components=c, n_q=4 + dq, **kw)
    r = benchmark.run_one(4, 7, solver=solver, dtype=dtype,
                          precision=precision, windowing=windowing,
                          device=cuda_device, problem=pb, solve_repeats=1,
                          matvec_repeats=1, matvec_inner=2, **kw)
    want = 93 if c == 1 else 91
    assert r.n_dofs == pb.n_dofs and r.n_q == 4 + dq
    if precision == "highest":
        assert r.n_iterations == want
    else:
        assert want <= r.n_iterations <= want + 3 or r.n_iterations == 100


@pytest.mark.cuda
@pytest.mark.parametrize("p", range(1, 12))
def test_bp3_rank_forms_match_plain(cuda_device, p):
    """CEED BP3 (one component) in the ranks' kernel forms: B2's block
    form on a z-slab and a (2, 2) block under highest (f32: 1e-5, f64:
    1e-12 max relative) and split2m (1e-5), both metrics, and its
    layer-range form bitwise the one launch; with the bf16 state the same
    forms, C10's carry over one component and B3/B5/B6 on a slab
    (``utils/bp3_ranks_check.compare_ranks``: the bf16 limits with their
    controls)."""
    from mf_data_locality_tpu_torch.utils import bp3_ranks_check as b3c

    for rung, dtype, tol in (("highest", torch.float64, 1e-12),
                             ("highest", torch.float32, 1e-5),
                             ("split2m", torch.float32, 1e-5)):
        for _, coords, mesh in b3c.PARTS:
            for metric in ("precomputed", "onthefly"):
                op = b3c.part_op(b3c.S_PART, p, coords, mesh, dtype, rung,
                                 metric, dev=cuda_device)
                x, g, d, h, scal, prec = b3c.iteration_args(op, 60 + p)
                args = (x, g, d.to(dtype), h.to(dtype), scal, prec)
                got = fk.fused_cg_iteration(op, *args)
                want = fk._fused_iteration_plain(op, *args)
                for a, b in zip(got[:4], want[:4]):
                    assert ((a - b).abs().max()
                            <= tol * b.abs().max()), (rung, dtype, metric)
                cut = op.n_cells_axis[0] - 1
                for a, b in zip(b3c.range_iteration(op, args, cut), got):
                    assert torch.equal(a, b)
    worst = b3c.compare_ranks(p, cuda_device)
    assert ("C10 carry", "split2m") in worst


@pytest.mark.cuda
@pytest.mark.parametrize("p", range(1, 12))
def test_bp3_bf16_state_matches_plain(cuda_device, p):
    """The bf16 state at one component on one device: B3, B4, B5, B6 and
    B1/B2 in every fused configuration under highest and split2m on the
    105-cell box (``utils/bp3_ranks_check.compare_one_device``)."""
    from mf_data_locality_tpu_torch.utils import bp3_ranks_check

    worst = bp3_ranks_check.compare_one_device(p, cuda_device)
    assert {k[0] for k in worst} >= {"B1", "B2", "batched_g", "pieces"}


@pytest.mark.cuda
@pytest.mark.parametrize("n,mesh", [(2, None), (3, None), (4, (2, 2))])
def test_bp3_distributed_solves_on_card(cuda_device, n, mesh):
    """BP3's f64 parity point p=4 s=7 on the ranks (processes on the
    card): the fused and merged solvers at one component take the
    single-device count, 93."""
    from mf_data_locality_tpu_torch.parallel import distributed

    jobs = [distributed.Job(solver, 7, 4, torch.float64, n_components=1,
                            mesh_shape=mesh) for solver in ("fused",
                                                            "merged")]
    for r in distributed.launch(jobs, n, "cuda"):
        assert r["it"] == 93 and r["x"].shape[0] == 1
