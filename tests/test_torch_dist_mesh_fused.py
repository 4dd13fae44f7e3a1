"""PyTorch port: the distributed fused CG on (z, y) and (z, y, x) rank meshes
(B2's block form) on gloo CPU ranks against the JAX package's
``parallel.dist_fused.solve_fused_2d`` / ``solve_fused_3d``.

The port's ranks (``parallel/comm.py``) run the plain block-form iteration
(``cg_fused_kernel._fused_iteration_plain`` on block operators); the JAX
side runs its fused kernel (``y_split`` / ``x_split``) in interpret mode
under ``shard_map`` on the 8 virtual CPU devices of ``tests/conftest.py``,
at the cases of ``tests/test_dist_fused.py``: divisible and non-divisible
y and x cell counts, a pure-y, a pure-x and a (z, x) split.  f64: itCG
identical, x within 1e-11 max(1, |x|), the residual history to 1e-10 of
res0.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.parallel import dist_fused as jdist_fused
from mf_data_locality_tpu.parallel import distributed as jdist
from mf_data_locality_tpu_torch.parallel import distributed as dist

TOL_X = 1e-11
# (s, p, mesh): tests/test_dist_fused.py's 2D cases ((7, 2, 2, 3): ncy = 8
# over 3 leaves a short y block) and 3D cases ((7, 2, 1, 1, 3): ncx = 8
# over 3, a short x block)
CASES_2D = ((7, 2, (2, 2)), (6, 2, (2, 2)), (6, 3, (2, 2)), (7, 2, (2, 3)),
            (6, 2, (1, 4)))
CASES_3D = ((7, 2, (1, 1, 2)), (7, 2, (2, 2, 2)), (6, 3, (2, 2, 2)),
            (7, 2, (1, 1, 3)), (7, 2, (2, 1, 4)))
CASES = [(s, p, m, "precomputed") for s, p, m in CASES_2D + CASES_3D] + [
    (6, 2, (2, 2), "onthefly"), (6, 2, (2, 2, 2), "onthefly")]


def _ids(c):
    return f"{c[0]}-{c[1]}-{'x'.join(map(str, c[2]))}-{c[3]}"


@pytest.fixture(scope="module")
def runs():
    """The port's fused solves, one spawn a rank count."""
    out = {}
    for n in sorted({math.prod(c[2]) for c in CASES}):
        cases = [c for c in CASES if math.prod(c[2]) == n]
        jobs = [dist.Job("fused", s, p, metric=m, mesh_shape=mesh)
                for s, p, mesh, m in cases]
        out.update(zip(cases, dist.launch(jobs, n, "cpu")))
    return out


def _jax_solve(s, p, mesh, metric):
    if len(mesh) == 2:
        dp, jm = jdist_fused.build_dist_fused_2d(s, p, mesh,
                                                 dtype=jnp.float64,
                                                 metric=metric)
        r = jdist_fused.solve_fused_2d(dp, jm)
        x = jdist.gather_global_2d(r.x)
    else:
        dp, jm = jdist_fused.build_dist_fused_3d(s, p, mesh,
                                                 dtype=jnp.float64,
                                                 metric=metric)
        r = jdist_fused.solve_fused_3d(dp, jm)
        x = jdist.gather_global_3d(r.x)
    nz, ny, nx = (n * p + 1 for n in dp.nc_global)
    return r, x[:, :nz, :ny, :nx]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_fused_mesh_matches_jax(runs, case):
    """Against ``solve_fused_2d`` / ``_3d`` on the same mesh: itCG
    identical, x within 1e-11 max(1, |x|), the residual history to 1e-10
    of res0."""
    want, xw = _jax_solve(*case)
    got = runs[case]
    assert got["it"] == int(want.n_iterations)
    assert got["converged"] and bool(want.converged)
    np.testing.assert_allclose(got["x"].numpy(), xw, rtol=0,
                               atol=TOL_X * max(1.0, np.abs(xw).max()))
    k = got["it"] + 1
    hist = np.asarray(want.res_history)[:k]
    np.testing.assert_allclose(got["history"][:k], hist, rtol=0,
                               atol=1e-10 * hist[0])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_fused_mesh_collectives(runs, case):
    """Every rank, with k the mesh's split axes: one all-reduce an
    iteration (the 7 sums, over every rank) and one for res0; 2k shifts an
    iteration (the ghost faces down, the carry up, one an axis each) and k
    each for the preconditioner's ghost faces and x's at exit."""
    got = runs[case]
    it, k = got["it"], sum(n > 1 for n in case[2])
    assert {(r["allreduces"], r["shifts"]) for r in got["ranks"]} == {
        (it + 1, 2 * k * it + 2 * k)}


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_ghost_faces_restored(runs, case):
    """x's top face along each split axis is the upper neighbour's face 0
    (zero past the global top), as gather_global_3d and the merged path
    take it."""
    got = runs[case]
    mesh = case[2] + (1,) * (3 - len(case[2]))
    xs = np.empty(mesh, dtype=object)
    for r, rank in enumerate(got["ranks"]):
        xs[np.unravel_index(r, mesh)] = rank["x"]
    for ax in range(3):
        for idx in np.ndindex(*mesh):
            if idx[ax] + 1 < mesh[ax]:
                up = list(idx)
                up[ax] += 1
                a, b = xs[idx], xs[tuple(up)]
                assert torch.equal(a.select(1 + ax, -1), b.select(1 + ax, 0))
