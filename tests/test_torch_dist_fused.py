"""PyTorch port: the distributed fused CG (B2's block form on z-slabs) on
gloo CPU ranks against the JAX package's ``parallel.dist_fused.
solve_fused``.

The port's ranks (``parallel/comm.py``) run the plain block-form iteration
(``cg_fused_kernel._fused_iteration_plain`` on slab operators); the JAX
side runs its fused kernel in interpret mode under ``shard_map`` on the 8
virtual CPU devices of ``tests/conftest.py``, at the sizes of
``tests/test_dist_fused.py`` and a rank count that does not divide ncz.
f64: itCG identical, x within 1e-11 max(1, |x|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.parallel import dist_fused as jdist_fused
from mf_data_locality_tpu.parallel import distributed as jdist
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.parallel import distributed as dist
from mf_data_locality_tpu_torch.solvers import cg_fused

TOL_X = 1e-11
# (s, p, ranks): tests/test_dist_fused.py's, and (7, 2, 3), whose ncz = 4
# leaves rank 2 all dummy layers, and (9, 2, 3) (ncz = 8: rank 2 with
# one dummy layer)
POINTS = ((6, 2, 4), (6, 1, 8), (6, 3, 2), (7, 2, 3), (9, 2, 3))
METRICS = ("precomputed", "onthefly")
CASES = [(s, p, n, m) for s, p, n in POINTS for m in METRICS]


# the bf16 rung with its state (d, h in bf16) on 4 ranks at (6, 2)
BF16 = dist.Job("fused", 6, 2, torch.bfloat16, precision="bf16")


@pytest.fixture(scope="module")
def runs():
    """The port's fused solves, one spawn a rank count."""
    out = {}
    for n in sorted({c[2] for c in CASES}):
        cases = [c for c in CASES if c[2] == n]
        jobs = [dist.Job("fused", s, p, metric=m) for s, p, _, m in cases]
        if n == 4:
            cases.append("bf16")
            jobs.append(BF16)
        out.update(zip(cases, dist.launch(jobs, n, "cpu")))
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_matches_jax_distributed(runs, case):
    """Against ``solve_fused`` on the same rank count: itCG identical, x
    within 1e-11 max(1, |x|), the residual history to 1e-10 of res0."""
    s, p, n, metric = case
    dp, mesh = jdist_fused.build_dist_fused(s, p, n_devices=n,
                                            dtype=jnp.float64, metric=metric)
    want = jdist_fused.solve_fused(dp, mesh)
    xw = jdist.gather_global(want.x, nz=dp.ncz_global * p + 1)
    got = runs[case]
    assert got["it"] == int(want.n_iterations)
    assert got["converged"] and bool(want.converged)
    np.testing.assert_allclose(got["x"].numpy(), xw, rtol=0,
                               atol=TOL_X * max(1.0, np.abs(xw).max()))
    k = got["it"] + 1
    hist = np.asarray(want.res_history)[:k]
    np.testing.assert_allclose(got["history"][:k], hist, rtol=0,
                               atol=1e-10 * hist[0])


@pytest.mark.parametrize("case", [c for c in CASES if c[3] == "precomputed"],
                         ids=lambda c: "-".join(map(str, c)))
def test_fused_matches_single_device(runs, case):
    """Against the port's single-device fused solve (dense, the metric
    streamed; tests/test_dist_fused.py's check)."""
    s, p, _, _ = case
    pb = bp4.build(s, p, torch.float64, device="cpu", factor="dense",
                   metric="precomputed", windowing="pieces")
    lat = (3,) + pb.layout.n_nodes_axis
    ref = cg_fused.fused_merged_cg_solve(pb.op, lat[1:], pb.b.reshape(lat),
                                         pb.inv_diag.reshape((1,) + lat[1:]))
    got = runs[case]
    assert got["it"] == ref.n_iterations
    assert (got["x"] - ref.x).abs().max() <= TOL_X * max(
        1.0, ref.x.abs().max())


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_collectives(runs, case):
    """Every rank: one all-reduce an iteration (the 7 sums) and one for
    res0; two shifts an iteration (the halo down, the carry up) and one
    each for the preconditioner's ghost plane and x's top plane."""
    got = runs[case]
    it = got["it"]
    assert {(r["allreduces"], r["shifts"]) for r in got["ranks"]} == {
        (it + 1, 2 * it + 2)}


def test_fused_bf16_state_converges(runs):
    """The bf16 rung with d and h in bf16 on 4 ranks converges within 6
    iterations of the f32 single-device solve (the JAX package's
    ``test_dist_fused_bf16_storage_converges``; there its rung is
    ``highest``, a degraded combination the port refuses, 6d) and within
    2 of the port's own single-device bf16 solve (the carry is added as
    h' stores it, in bf16)."""
    got = runs["bf16"]
    lat = None
    its = {}
    for dtype, precision in ((torch.float32, "highest"),
                             (torch.bfloat16, "bf16")):
        pb = bp4.build(6, 2, dtype, precision, device="cpu", factor="dense",
                       metric="precomputed", windowing="pieces")
        lat = (3,) + pb.layout.n_nodes_axis
        its[precision] = cg_fused.fused_merged_cg_solve(
            pb.op, lat[1:], pb.b.reshape(lat),
            pb.inv_diag.reshape((1,) + lat[1:])).n_iterations
    assert got["converged"]
    assert abs(got["it"] - its["highest"]) <= 6
    assert abs(got["it"] - its["bf16"]) <= 2
    assert got["x"].shape == lat and torch.isfinite(got["x"]).all()


def test_replication_restored(runs):
    """x's top plane on each rank is the upper rank's plane 0 (zero on the
    top rank), as gather_global and the merged path take it."""
    for got in runs.values():
        xs = [r["x"] for r in got["ranks"]]
        for a, b in zip(xs, xs[1:]):
            assert torch.equal(a[:, -1], b[:, 0])
        assert not xs[-1][:, -1].any()
