"""PyTorch port: the CUDA kernels against their plain PyTorch versions.

Every test that launches a kernel needs a CUDA device and ``nvcc``; it is
marked ``cuda`` and skips with a reason without one.  This file imports no
JAX, so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import pytest
import torch

from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.solvers import cg_fused

P = 4
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
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
    op = bp4.build(3, P, torch.float64, "highest").op
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
    op = bp4.build(5, P, dtype, precision, device=cuda_device).op
    (u,) = _state(op, 1, seed=0)
    before = fk.matvec.launches
    got = fk.matvec(op, u)
    assert fk.matvec.launches == before + 1
    assert _rel(got, fk._matvec_plain(op, u)) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "split2m"), (torch.float64, "highest")])
def test_fused_iteration_kernel_matches_plain(cuda_device, dtype, precision):
    pb = bp4.build(5, P, dtype, precision, device=cuda_device)
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
def test_kernel_wrappers_check_their_arguments(cuda_device):
    pb = bp4.build(4, P, torch.float32, "split2m", device=cuda_device)
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
    pb = bp4.build(5, P, torch.float64, "highest", device=cuda_device)
    lat = pb.layout.n_nodes_axis
    args = (pb.b.reshape((3,) + lat), pb.inv_diag.reshape((1,) + lat))
    before = fk.fused_cg_iteration.launches
    res = cg_fused.fused_merged_cg_solve(pb.op, lat, *args)
    assert fk.fused_cg_iteration.launches - before == res.n_iterations
    cpu = bp4.build(5, P, torch.float64, "highest")
    ref = cg_fused.fused_merged_cg_solve(
        cpu.op, lat, *(a.cpu() for a in args))
    assert res.converged and res.n_iterations == ref.n_iterations
    assert _rel(res.x.cpu(), ref.x) < 1e-10


@pytest.mark.cuda
def test_run_one_on_card(cuda_device):
    r = benchmark.run_one(4, 5, solver="fused", precision="split2m",
                          solve_repeats=1, matvec_repeats=1, matvec_inner=5,
                          device=cuda_device)
    assert r.converged and r.time_per_it > 0 and r.time_per_matvec > 0
