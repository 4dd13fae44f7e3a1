"""PyTorch port: ``--devices N`` of the CLI and the dry run, on gloo CPU
ranks (``--device cpu``), against the JAX package's distributed solves.

At the parity point p=4 s=7 in f64 (PARITY.md: itCG 91) the merged
(reshape), fused (pieces) and baseline paths of ``benchmark
.run_one_distributed`` on 2 ranks give the JAX package's itCG and x
within TOL_X max(1, |x|); the dry run's legs 1-3 give the JAX legs'
iterations and residuals (f32, 1e-5).

TOL_X: at this point 91 iterations amplify rounding in x (|x| = 1231)
well past the 1e-11 the JAX tests use at s=6, p <= 3 (where the spreads
below are ~1e-15): the JAX package's own fused solve on 1 and on 2
devices differs by 5.1e-10 max(1, |x|), its merged one by 9.1e-11; the
port's distributed solves differ from the JAX ones by 2.0e-10 (fused) and
8.1e-11 (merged), from its own single-device ones by 1.0e-10 and 3.9e-10
(CPU readings; the iteration counts are equal throughout).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.parallel import dist_fused as jdist_fused
from mf_data_locality_tpu.parallel import distributed as jdist
from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.parallel import dryrun

P, S, N = 4, 7, 2
TOL_X = 1e-9


def _jax(solver):
    if solver == "fused":
        dp, mesh = jdist_fused.build_dist_fused(S, P, n_devices=N,
                                                dtype=jnp.float64)
        r = jdist_fused.solve_fused(dp, mesh)
    else:
        dp, mesh = jdist.build_distributed(S, P, n_devices=N,
                                           dtype=jnp.float64)
        r = jdist.solve(dp, mesh, solver=solver)
    return r, jdist.gather_global(r.x, nz=dp.ncz_global * P + 1)


@pytest.mark.parametrize("solver,windowing", [("merged", "reshape"),
                                              ("fused", "pieces"),
                                              ("baseline", "reshape")])
def test_run_one_distributed_matches_jax(solver, windowing):
    row, out = benchmark.run_one_distributed(
        P, S, N, solver=solver, dtype=torch.float64, windowing=windowing,
        device="cpu")
    want, xw = _jax(solver)
    assert row.n_iterations == int(want.n_iterations) == 91
    assert row.converged and row.n_dofs == 28611
    assert np.isnan(row.time_per_it) and "not measured" in row.note
    assert out["transport"] == "gloo, 2 ranks on the CPU"
    np.testing.assert_allclose(out["x"].numpy(), xw, rtol=0,
                               atol=TOL_X * max(1.0, np.abs(xw).max()))


def test_cli_devices_row(capsys):
    """``python -m mf_data_locality_tpu_torch.benchmark 4 7 --devices 2
    --dtype f64 --device cpu``: the transport line, the header, one row
    with the f64 itCG."""
    benchmark.main(["4", "7", "--devices", "2", "--dtype", "f64",
                    "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "transport: gloo, 2 ranks on the CPU"
    assert lines[1] == benchmark.HEADER
    assert lines[2].split("|")[6].strip() == "91"
    assert len(lines) == 3


def test_dryrun_legs_match_jax():
    """Legs 1-3 on 4 ranks (s=6, p=2, f32, 5 iterations): the JAX legs'
    iteration counts and residuals."""
    out = dryrun.dryrun_multichip(4, "cpu")
    s = 6
    dp, mesh = jdist.build_distributed(s, 2, n_devices=4, dtype=jnp.float32,
                                       backend="structured")
    want = [jdist.solve(dp, mesh, solver="merged", max_iter=5, rel_tol=1e-3)]
    for metric in ("precomputed", "onthefly"):
        dpf, meshf = jdist_fused.build_dist_fused(s, 2, n_devices=4,
                                                  dtype=jnp.float32,
                                                  metric=metric)
        want.append(jdist_fused.solve_fused(dpf, meshf, max_iter=5,
                                            rel_tol=1e-3))
    for got, w in zip(out, want):
        assert got["it"] == int(w.n_iterations) == 5
        assert got["res"] == pytest.approx(float(w.res_norm), rel=1e-5)
