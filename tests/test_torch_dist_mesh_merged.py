"""PyTorch port: the distributed merged and baseline CG on (z, y) and
(z, y, x) rank meshes on gloo CPU ranks against the JAX package's
``parallel.distributed.solve_2d`` / ``solve_3d``.

Each rank's block comes from the port's own build
(``distributed.build_block``) or from the JAX ``DistributedBP4_2D`` /
``_3D``'s arrays of the same device (``models/bp4.block_from_jax_arrays``);
the halo sums run axis by axis (``dist_vmult``).  The structured backend
at the JAX tests' meshes ((2, 2), (3, 2): non-divisible z; (2, 2, 2),
(1, 2, 4)), each also on the JAX blocks, and the pallas operator's plain
B3 (``reshape``), B5 (``pieces``) and B6 (``zslab``) on (2, 2) and (2, 2,
2), B5 on (2, 3) (non-divisible y: ncy = 4 over 3 leaves the last y block
all dummy cells).  f64: itCG identical, x within 1e-11 max(1, |x|).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.parallel import distributed as jdist
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.parallel import distributed as dist

TOL_X = 1e-11
# (solver, s, p, backend, windowing, mesh)
STRUCTURED = [("merged", 9, 2, "structured", "reshape", m)
              for m in ((2, 2), (3, 2))] + [
    ("merged", 6, 2, "structured", "reshape", m) for m in ((2, 2, 2),
                                                           (1, 2, 4))]
PALLAS = [("merged", 6, 2, "pallas", w, m)
          for m in ((2, 2), (2, 2, 2))
          for w in ("reshape", "pieces", "zslab")] + [
    ("merged", 6, 2, "pallas", "pieces", (2, 3)),
    ("baseline", 6, 2, "pallas", "reshape", (2, 2)),
    ("baseline", 6, 2, "structured", "reshape", (2, 2, 2))]
CASES = STRUCTURED + PALLAS


def _ids(c):
    return f"{c[0]}-{c[1]}-{c[2]}-{c[3]}-{c[4]}-{'x'.join(map(str, c[5]))}"


def _jax_build(s, p, backend, windowing, mesh):
    build = (jdist.build_distributed_2d if len(mesh) == 2
             else jdist.build_distributed_3d)
    return build(s, p, mesh, dtype=jnp.float64, backend=backend,
                 windowing=windowing)


def jax_block_arrays(dp, coords, backend: str) -> dict:
    """The arrays of the device at ``coords`` of a JAX
    ``DistributedBP4_2D`` / ``_3D`` as numpy, the keywords of
    ``bp4.block_from_jax_arrays``."""
    def leaf(a):
        return None if a is None else np.array(a[coords])

    op = dp.op_stack
    out = dict(coords=coords, mesh_shape=dp.mesh_shape,
               nc_global=dp.nc_global, n_dofs=dp.n_dofs,
               n_cells=dp.n_cells, b=leaf(dp.b), inv_diag=leaf(dp.inv_diag),
               weight=leaf(dp.weight), backend=backend)
    if backend == "structured":
        out.update({k: leaf(getattr(op, k)) for k in
                    ("values", "d_col", "q_pts", "w3", "coeffs", "mask")})
        out["degree"] = out["values"].shape[1] - 1
        return out
    out.update(pds=leaf(op.pds), w3=leaf(op.w3), coeffs=leaf(op.coeffs),
               mask=leaf(op.mask), mats=leaf(op.mats),
               mats2d=leaf(op.mats2d), precision=op.precision,
               windowing=op.windowing, gmetric=leaf(op.gmetric))
    out["degree"] = round(out["mats"].shape[1] ** (1 / 3)) - 1
    return out


@pytest.fixture(scope="module")
def runs():
    """{case: (the port's solve on its own blocks, on the JAX blocks (the
    structured cases) or None, the JAX problem)}, one spawn a rank
    count."""
    out = {}
    for n in sorted({math.prod(c[5]) for c in CASES}):
        cases = [c for c in CASES if math.prod(c[5]) == n]
        jobs, jax_side = [], []
        for solver, s, p, backend, windowing, mesh in cases:
            dp, jm = _jax_build(s, p, backend, windowing, mesh)
            jax_side.append((dp, jm))
            kw = dict(backend=backend, windowing=windowing, mesh_shape=mesh)
            jobs.append(dist.Job(solver, s, p, **kw))
            if backend == "structured":
                arrays = tuple(jax_block_arrays(dp, np.unravel_index(r, mesh),
                                                backend) for r in range(n))
                jobs.append(dist.Job(solver, s, p, arrays=arrays, **kw))
        res = iter(dist.launch(jobs, n, "cpu"))
        for c, problem in zip(cases, jax_side):
            out[c] = (next(res),
                      next(res) if c[3] == "structured" else None, problem)
    return out


def _jax_solve(case, dp, jm):
    solve = jdist.solve_2d if len(case[5]) == 2 else jdist.solve_3d
    r = solve(dp, jm, solver=case[0])
    gather = (jdist.gather_global_2d if len(case[5]) == 2
              else jdist.gather_global_3d)
    nz, ny, nx = (n * case[2] + 1 for n in dp.nc_global)
    return r, gather(r.x)[:, :nz, :ny, :nx]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_mesh_solve_matches_jax(runs, case):
    """The port's solve on its own blocks (and, structured, on the JAX
    blocks) against the JAX solve on the same mesh: itCG identical, x
    within 1e-11 max(1, |x|)."""
    own, on_jax, (dp, jm) = runs[case]
    want, xw = _jax_solve(case, dp, jm)
    for got in (own, on_jax) if on_jax else (own,):
        assert got["it"] == int(want.n_iterations)
        assert got["converged"] and bool(want.converged)
        np.testing.assert_allclose(got["x"].numpy(), xw, rtol=0,
                                   atol=TOL_X * max(1.0, np.abs(xw).max()))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_mesh_collectives(runs, case):
    """Every rank, with k the mesh's split axes: the merged solver one
    all-reduce an iteration (over every rank) and one for res0, the
    baseline 3 an iteration and 2; 2k shifts an operator apply (the halo
    sum, two an axis)."""
    got = runs[case][0]
    it, k = got["it"], sum(n > 1 for n in case[5])
    want = ((2 + 3 * it, 2 * k * it) if case[0] == "baseline"
            else (it + 1, 2 * k * it))
    assert {(r["allreduces"], r["shifts"]) for r in got["ranks"]} == {want}


@pytest.mark.parametrize("s,p,mesh", [(6, 2, (2, 2)), (6, 2, (2, 3)),
                                      (7, 2, (2, 2, 2)), (6, 3, (1, 2, 4)),
                                      (7, 2, (2, 1, 3))])
def test_block_arrays_match_jax(s, p, mesh):
    """Each rank's own build (block_arrays / build_block) equals the JAX
    blocks cut from the global arrays (``_pad_slice``, ``_pad_dummy_cells``):
    mask, b and weight exactly; the coefficients, the preconditioner and
    the streamed metric to 1e-14 (the packages map the vertices in their
    own vectorized sines)."""
    dp, _ = _jax_build(s, p, "pallas", "pieces", mesh)
    for coords in np.ndindex(*mesh):
        want = jax_block_arrays(dp, coords, "pallas")
        blk = dist.build_block(s, p, coords, mesh, torch.float64, "pallas",
                               "highest", "pieces", "precomputed", "cpu")
        op = blk.op
        np.testing.assert_array_equal(op.mask.numpy(), want["mask"])
        np.testing.assert_array_equal(blk.b.numpy(), want["b"])
        np.testing.assert_array_equal(
            np.broadcast_to(blk.weight.numpy(), want["mask"].shape),
            np.broadcast_to(want["weight"], want["mask"].shape))
        nc = op.n_cells
        np.testing.assert_allclose(op.coeffs.numpy(),
                                   want["coeffs"][:, :, :nc], rtol=0,
                                   atol=1e-14 * np.abs(want["coeffs"]).max())
        np.testing.assert_allclose(blk.inv_diag.numpy(), want["inv_diag"],
                                   rtol=1e-14, atol=0)
        np.testing.assert_allclose(op.gmetric.numpy(),
                                   want["gmetric"][:, :nc], rtol=0,
                                   atol=1e-14 * np.abs(want["gmetric"]).max())
        got = bp4.block_from_jax_arrays(**want, device="cpu")
        assert got.op.slab == op.slab and got.halo == blk.halo
        assert got.op.n_cells_axis == op.n_cells_axis


@pytest.mark.parametrize("mesh", [(2, 3), (3, 2, 2)])
def test_gather_global_matches_jax(mesh):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(mesh + (3, 5, 4, 6))
    if len(mesh) == 2:
        want = jdist.gather_global_2d(x, nz=11, ny=9)
        got = dist.gather_global_2d(
            [torch.as_tensor(x[i]) for i in np.ndindex(*mesh)], mesh, 11, 9)
    else:
        want = jdist.gather_global_3d(x, nz=11, ny=9, nx=14)
        got = dist.gather_global_3d(
            [torch.as_tensor(x[i]) for i in np.ndindex(*mesh)], mesh, 11, 9,
            14)
    np.testing.assert_array_equal(got.numpy(), want)
