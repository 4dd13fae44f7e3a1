"""PyTorch port: distributed solves on the JAX package's own slabs.

Each gloo CPU rank builds its slab problem from the JAX ``DistributedBP4``'s
arrays of the same device (``models/bp4.slab_from_jax_arrays``, handed to
the ranks as numpy), so both packages iterate on the same inputs; then
the same checks as ``test_torch_dist_merged.py`` / ``_fused.py``: itCG
identical, x within 1e-11 max(1, |x|) in f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.parallel import dist_fused as jdist_fused
from mf_data_locality_tpu.parallel import distributed as jdist
from mf_data_locality_tpu_torch.parallel import distributed as dist
from test_torch_dist_slab import jax_rank_arrays

TOL_X = 1e-11
N = 3
# label -> (port job, JAX build, JAX solve)
CASES = {
    "merged-pieces": (
        dist.Job("merged", 7, 2, windowing="pieces"),
        lambda: jdist.build_distributed(7, 2, n_devices=N, dtype=jnp.float64,
                                        windowing="pieces"),
        lambda dp, mesh: jdist.solve(dp, mesh, solver="merged")),
    "baseline-reshape": (
        dist.Job("baseline", 7, 2),
        lambda: jdist.build_distributed(7, 2, n_devices=N,
                                        dtype=jnp.float64),
        lambda dp, mesh: jdist.solve(dp, mesh, solver="baseline")),
    "merged-structured": (
        dist.Job("merged", 7, 2, backend="structured"),
        lambda: jdist.build_distributed(7, 2, n_devices=N, dtype=jnp.float64,
                                        backend="structured"),
        lambda dp, mesh: jdist.solve(dp, mesh, solver="merged")),
    "fused": (
        dist.Job("fused", 9, 2),
        lambda: jdist_fused.build_dist_fused(9, 2, n_devices=N,
                                             dtype=jnp.float64),
        jdist_fused.solve_fused),
    "fused-onthefly": (
        dist.Job("fused", 9, 2, metric="onthefly"),
        lambda: jdist_fused.build_dist_fused(9, 2, n_devices=N,
                                             dtype=jnp.float64,
                                             metric="onthefly"),
        jdist_fused.solve_fused),
}


@pytest.fixture(scope="module")
def built():
    """The JAX problems and, for each, the port's solve on its slabs."""
    jax_side, jobs = {}, []
    for label, (job, build, _) in CASES.items():
        dp, mesh = build()
        jax_side[label] = dp, mesh
        backend = job.backend
        arrays = tuple(jax_rank_arrays(dp, r, backend) for r in range(N))
        jobs.append(dist.Job(job.solver, job.s, job.degree, arrays=arrays))
    port = dict(zip(CASES, dist.launch(jobs, N, "cpu")))
    return jax_side, port


@pytest.mark.parametrize("label", list(CASES))
def test_port_ranks_on_jax_slabs(built, label):
    jax_side, port = built
    dp, mesh = jax_side[label]
    want = CASES[label][2](dp, mesh)
    xw = jdist.gather_global(want.x,
                             nz=dp.ncz_global * CASES[label][0].degree + 1)
    got = port[label]
    assert got["it"] == int(want.n_iterations)
    np.testing.assert_allclose(got["x"].numpy(), xw, rtol=0,
                               atol=TOL_X * max(1.0, np.abs(xw).max()))


def test_jax_slabs_and_own_build_agree(built):
    """The same solve on the port's own slabs and on the JAX ones: the
    iteration counts agree and x to 1e-11 max(1, |x|)."""
    _, port = built
    own = dist.launch([CASES[k][0] for k in ("fused", "merged-pieces")], N,
                      "cpu")
    for label, got in zip(("fused", "merged-pieces"), own):
        assert got["it"] == port[label]["it"]
        ref = port[label]["x"]
        assert (got["x"] - ref).abs().max() <= TOL_X * max(
            1.0, ref.abs().max())
        assert got["x"].dtype == torch.float64
