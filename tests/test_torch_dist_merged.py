"""PyTorch port: the distributed merged and baseline CG on gloo CPU ranks
against the JAX package's ``parallel.distributed.solve``.

The port's ranks are processes (``parallel/comm.py``) that run the plain
versions; the JAX side runs its ``shard_map`` on the 8 virtual CPU
devices of ``tests/conftest.py`` (Pallas in interpret mode), at the JAX
tests' sizes (``tests/test_distributed.py``).  f64: itCG identical and x
within 1e-11 max(1, |x|).  One spawn a rank count, its jobs shared by the
tests through a module fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.parallel import distributed as jdist
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.parallel import distributed as dist

F64 = torch.float64
TOL_X = 1e-11
# label -> (ranks, port job, JAX build_distributed keywords, JAX solver)
CASES = {
    "merged-reshape": (4, dist.Job("merged", 6, 2),
                       dict(backend="pallas"), "merged"),
    "merged-pieces": (4, dist.Job("merged", 6, 2, windowing="pieces"),
                      dict(backend="pallas", windowing="pieces"), "merged"),
    "merged-zslab": (4, dist.Job("merged", 6, 2, windowing="zslab"),
                     dict(backend="pallas", windowing="zslab"), "merged"),
    "baseline-reshape": (4, dist.Job("baseline", 6, 2),
                         dict(backend="pallas"), "baseline"),
    "merged-structured": (4, dist.Job("merged", 9, 2, backend="structured"),
                          dict(backend="structured"), "merged"),
    "baseline-structured": (4, dist.Job("baseline", 9, 2,
                                        backend="structured"),
                            dict(backend="structured"), "baseline"),
    "merged-reshape-3": (3, dist.Job("merged", 6, 2),
                         dict(backend="pallas"), "merged"),
    "merged-pieces-3": (3, dist.Job("merged", 6, 2, windowing="pieces"),
                        dict(backend="pallas", windowing="pieces"),
                        "merged"),
    "merged-structured-3": (3, dist.Job("merged", 9, 2,
                                        backend="structured", max_iter=25),
                            dict(backend="structured"), "merged"),
}
MATVEC = {"pallas": dist.Job("matvec", 6, 3),
          "structured": dist.Job("matvec", 6, 3, backend="structured")}


@pytest.fixture(scope="module")
def runs():
    """Every case's port result: one spawn of 4 ranks, one of 3."""
    out = {}
    for n in (4, 3):
        labels = [k for k, v in CASES.items() if v[0] == n]
        jobs = [CASES[k][1] for k in labels]
        if n == 4:
            labels += [f"matvec-{k}" for k in MATVEC]
            jobs += list(MATVEC.values())
        out.update(zip(labels, dist.launch(jobs, n, "cpu")))
    return out


def _jax_solve(label):
    n, job, kw, solver = CASES[label]
    dp, mesh = jdist.build_distributed(job.s, job.degree, n_devices=n,
                                       dtype=jnp.float64, **kw)
    r = jdist.solve(dp, mesh, solver=solver, max_iter=job.max_iter)
    nz = (dp.ncz_global * job.degree) + 1
    return r, jdist.gather_global(r.x, nz=nz)


@pytest.mark.parametrize("label", list(CASES))
def test_matches_jax_distributed(runs, label):
    """itCG identical, x within 1e-11 max(1, |x|), the residual history
    to 1e-10 of res0."""
    got = runs[label]
    want, xw = _jax_solve(label)
    assert got["it"] == int(want.n_iterations)
    assert got["converged"] == bool(want.converged)
    np.testing.assert_allclose(got["x"].numpy(), xw, rtol=0,
                               atol=TOL_X * max(1.0, np.abs(xw).max()))
    n = got["it"] + 1
    hist = np.asarray(want.res_history)[:n]
    np.testing.assert_allclose(got["history"][:n], hist, rtol=0,
                               atol=1e-10 * hist[0])


@pytest.mark.parametrize("label", ["merged-reshape", "baseline-reshape",
                                   "merged-structured", "merged-zslab",
                                   "merged-pieces-3"])
def test_matches_single_device(runs, label):
    """The port's distributed solve against its single-device one (the
    JAX tests' check): itCG identical, x within 1e-11 max(1, |x|)."""
    _, job, kw, solver = CASES[label]
    pb = bp4.build(job.s, job.degree, F64, device="cpu",
                   backend=kw["backend"],
                   **({"windowing": job.windowing}
                      if kw["backend"] == "pallas" else {}))
    ref = (bp4.solve_merged if solver == "merged"
           else bp4.solve_baseline)(pb, max_iter=job.max_iter)
    got = runs[label]
    assert got["it"] == ref.n_iterations
    x1 = ref.x.reshape(got["x"].shape)
    assert (got["x"] - x1).abs().max() <= TOL_X * max(1.0, x1.abs().max())


@pytest.mark.parametrize("label", list(CASES))
def test_collectives(runs, label):
    """Every rank: merged one all-reduce an iteration (its 7 sums) and one
    for res0; baseline one a dot, 3 an iteration and 2 to start; two halo
    shifts an operator apply."""
    got = runs[label]
    it = got["it"]
    want = (it + 1 if CASES[label][3] == "merged" else 2 + 3 * it, 2 * it)
    assert {(r["allreduces"], r["shifts"]) for r in got["ranks"]} == {want}


@pytest.mark.parametrize("backend", list(MATVEC))
def test_matvec_matches_jax(runs, backend):
    """One distributed operator apply of b (dist_vmult, the halo sum) vs
    the JAX ``dist_matvec_jit`` / ``dist_vmult`` on the same slabs."""
    import jax
    from jax.sharding import PartitionSpec as P

    job = MATVEC[backend]
    dp, mesh = jdist.build_distributed(job.s, job.degree, n_devices=4,
                                       dtype=jnp.float64, backend=backend)
    if backend == "pallas":
        vd = jdist.dist_matvec_jit(dp, mesh)(dp.op_stack, dp.b)
    else:
        def body(op_stack, b):
            op = jax.tree.map(lambda x: x[0], op_stack)
            return jdist.dist_vmult(op, b[0], n_dev=4,
                                    backend="structured")[None]

        vd = jax.jit(jax.shard_map(body, mesh=mesh,
                                   in_specs=(P(jdist.AXIS), P(jdist.AXIS)),
                                   out_specs=P(jdist.AXIS),
                                   check_vma=False))(dp.op_stack, dp.b)
    want = jdist.gather_global(vd)
    got = runs[f"matvec-{backend}"]
    assert got["shifts"] == 2
    np.testing.assert_allclose(got["x"].numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    # and the single-device vmult
    pb = bp4.build(job.s, job.degree, F64, device="cpu", backend=backend)
    v1 = pb.a_apply_full(pb.b).reshape(got["x"].shape)
    assert (got["x"] - v1).abs().max() <= 1e-12 * v1.abs().max()


def test_launches_counted_on_the_plain_path(runs):
    """CPU ranks run the plain versions: no kernel launch is counted."""
    for label in CASES:
        for r in runs[label]["ranks"]:
            assert not any(r["launches_solve"].values())
