"""PyTorch port: B2's block form on one rank's block, in-process, against
the JAX kernel with ``y_split`` / ``x_split``; the fused solver's 2-level
grid and ``x0`` start and ``dryrun_multichip``'s legs 5-8 on gloo CPU
ranks; the rank grid.

The JAX side builds its ``DistributedBP4_2D`` / ``_3D`` on the 8 virtual
CPU devices of ``tests/conftest.py`` and runs ``fused_cg_iteration`` on
one device's block (non-compact piece state, the z halo, ``z0``, ``y0``,
``x0``, the global cell counts, ``recurrence=False``,
``want_carry=True``) in interpret mode; the port runs its plain version
(``cg_fused_kernel._fused_iteration_plain`` on a block operator) on the
same numpy inputs, made from a seed, every ghost face filled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.ops import cg_fused_kernel as jfk
from mf_data_locality_tpu.parallel import dist_fused as jdist_fused
from mf_data_locality_tpu.parallel import distributed as jdist
from mf_data_locality_tpu.solvers import cg_fused as jcg_fused
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.parallel import comm as comm_mod
from mf_data_locality_tpu_torch.parallel import distributed as dist
from mf_data_locality_tpu_torch.parallel import dryrun


def _ids(c):
    return "-".join(str(v) if not isinstance(v, tuple)
                    else "x".join(map(str, v)) for v in c)


SCAL = np.array([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6])
# rung -> (JAX dtype, torch dtype, vector tolerance (of max |v|), scalar
# tolerance (relative)): f64 highest; f32 split2m against the JAX f32
# interpret run (ROADMAP.md C3), scalars sums of ~1e3 terms in another
# order
RUNGS = {"highest": (jnp.float64, torch.float64, 1e-12, 1e-12),
         "split2m": (jnp.float32, torch.float32, 1e-5, 1e-4)}
# (s, p, mesh, coords): interior and edge blocks of (z, y) and (z, y, x)
# meshes, the first and last blocks of each split axis, a short y block
# (7, 2, (2, 3): ncy = 8 over 3) and a short x block (7, 2, (2, 1, 3))
BLOCKS = ((6, 2, (2, 2), (1, 0)), (6, 2, (2, 2), (0, 1)),
          (7, 2, (2, 3), (1, 2)), (6, 3, (2, 2), (0, 0)),
          (7, 2, (2, 2, 2), (0, 1, 0)), (7, 2, (2, 2, 2), (1, 1, 1)),
          (7, 2, (2, 1, 3), (0, 0, 2)), (7, 2, (1, 2, 4), (0, 1, 1)))
# the fast set: both (z, y) edge blocks of the (2, 2) mesh, the short y
# block, the p=3 (z, y) corner block, the (z, y, x) top corner block and
# the short x block, the metric streamed or rebuilt in turn (each JAX
# interpret run takes ~15 s); every other pair is slow
FAST = {(BLOCKS[0], "precomputed"), (BLOCKS[1], "precomputed"),
        (BLOCKS[2], "onthefly"), (BLOCKS[3], "onthefly"),
        (BLOCKS[5], "precomputed"), (BLOCKS[6], "onthefly")}
CASES = [pytest.param(b, m, id=f"{_ids(b)}-{m}",
                      marks=() if (b, m) in FAST else pytest.mark.slow)
         for b in BLOCKS for m in ("precomputed", "onthefly")]


def _jax_block_iteration(s, p, mesh, coords, metric, rung):
    """One JAX block iteration and the port's plain one on the same random
    state: the port's (x', g', d', h', s) and the JAX lattice outputs."""
    jdt, tdt = RUNGS[rung][:2]
    build = (jdist_fused.build_dist_fused_2d if len(mesh) == 2
             else jdist_fused.build_dist_fused_3d)
    dp, _ = build(s, p, mesh, dtype=jdt, precision=rung, metric=metric)
    jop = jax.tree.map(lambda a: a[coords], dp.op_stack)
    op = dist.build_block(s, p, coords, mesh, tdt, "pallas", rung, "pieces",
                          metric, "cpu").op
    lat = op.n_nodes_axis
    mask = op.mask.numpy()
    rng = np.random.default_rng(sum(coords) + 10 * len(mesh) + s)
    x, g, d, h = (rng.standard_normal((3,) + lat) * mask for _ in range(4))
    prec = (np.abs(rng.standard_normal((1,) + lat)) + 0.5) * mask

    def pieces(v):
        return jfk.to_piece_state(jnp.asarray(v, jdt), p)

    def top(v):  # the z ghost plane as the upper rank's piece plane 0
        one = np.zeros(v.shape[:1] + (p + 1,) + v.shape[2:])
        one[:, 0] = v[:, -1]
        return pieces(one)[:, :1]

    state = [pieces(v) for v in (x, g, d, h)]
    m3 = tuple(mesh) + (1,) * (3 - len(mesh))
    c3 = tuple(coords) + (0,) * (3 - len(coords))
    cells = [(n - 1) // p for n in lat]
    kw = dict(z0=c3[0] * cells[0], ncz_global=dp.nc_global[0],
              y0=c3[1] * cells[1], ncy_global=dp.nc_global[1],
              y_split=m3[1] > 1)
    if len(mesh) == 3:
        kw.update(x0=c3[2] * cells[2], ncx_global=dp.nc_global[2],
                  x_split=m3[2] > 1)
    out = jfk.fused_cg_iteration(
        jop, lat, *state, *(jfk.zplanes_init(v, p) for v in state[1:]),
        jnp.asarray(SCAL, jdt), pieces(prec),
        halo=tuple(top(v) for v in (g, d, h, prec)), recurrence=False,
        want_carry=True, compact=False, **kw)
    got = fk._fused_iteration_plain(
        op, *(torch.as_tensor(v).to(tdt) for v in (x, g, d, h, SCAL, prec)))
    want = [np.asarray(jfk.from_piece_state(v, p, lat), np.float64)
            for v in out[:4]]
    carry = np.concatenate([np.asarray(out[8], np.float64),
                            np.zeros((3, p - 1) + out[8].shape[2:])], 1)
    want_carry = np.asarray(jfk.from_piece_state(
        jnp.asarray(carry), p, (p + 1,) + lat[1:]))[:, 0]
    return got, want, want_carry, np.asarray(out[7], np.float64)


@pytest.mark.parametrize("case,metric", CASES)
def test_block_iteration_matches_jax(case, metric):
    """One block-form iteration (f64) from a random state with every ghost
    face filled: x', g', d', h' on the z-owned planes, every y and x node
    of them (the owned nodes and h''s y and x ghost faces, the partial sums
    owed upward), the carry (h''s z ghost plane) and the 7 raw sums over
    the owned nodes agree with the JAX kernel's to 1e-12 — the Dirichlet
    faces by global position on all three axes, dummy cells at the short
    blocks."""
    _check(case, metric, "highest")


@pytest.mark.parametrize("case", [
    BLOCKS[0], pytest.param(BLOCKS[3], marks=pytest.mark.slow),
    pytest.param(BLOCKS[6], marks=pytest.mark.slow)], ids=_ids)
def test_block_iteration_split2m_matches_jax(case):
    """The same under f32 split2m (the dense tensor-core rung's rounding
    points in the plain version) against the JAX f32 interpret run: the
    vectors to 1e-5 of their largest value, the sums to 1e-4 relative."""
    _check(case, "onthefly", "split2m")


def _check(case, metric, rung):
    got, want, want_carry, sums = _jax_block_iteration(*case, metric, rung)
    tol, stol = RUNGS[rung][2:]
    pz = got[0].shape[1] - 1
    for g, w in zip(got[:4], want):
        np.testing.assert_allclose(g.double().numpy()[:, :pz], w[:, :pz],
                                   rtol=0, atol=tol * max(np.abs(w).max(),
                                                          1.0))
    np.testing.assert_allclose(got[3].double().numpy()[:, -1], want_carry,
                               rtol=0, atol=tol * max(np.abs(want_carry)
                                                      .max(), 1.0))
    np.testing.assert_allclose(got[4].double().numpy()[:7], sums[:7],
                               rtol=stol, atol=stol * np.abs(sums).max())


def test_block_faces():
    """The kernel's faces from a block's origin and the global cell
    counts: the bottom face only at the global bottom, the top face only
    at the global top, an all-dummy block empty."""
    op = dist.build_block(6, 2, (1, 2), (2, 3), torch.float64, "pallas",
                          "highest", "pieces", "precomputed", "cpu").op
    # (4, 4, 4) cells: z block 1 of 2 cells, y block 2 of 2: all dummy
    assert op.slab == ((2, 4, 0), (4, 4, 4))
    assert fk.block_faces(op) == (0, 4, 4, 0, 0, 4, 1, 8, 8)
    op = dist.build_block(6, 2, (0, 0, 1), (1, 2, 2), torch.float64,
                          "pallas", "highest", "pieces", "onthefly",
                          "cpu").op
    assert fk.block_faces(op) == (1, 8, 8, 1, 5, 4, 0, 4, 4)


@pytest.fixture(scope="module")
def runs4():
    """On 4 ranks: the fused z-slab solve, the same on a 2-level (2, 2)
    grid, the x0 start, and dryrun_multichip(4)'s legs 5-7."""
    f64 = torch.float64
    x0 = _x0()
    jobs = [dist.Job("fused", 6, 2, f64),
            dist.Job("fused", 6, 2, f64, mesh_shape=(2, 2), two_level=True),
            dist.Job("fused", 6, 2, f64, x0=x0.numpy())]
    jobs += dryrun.jobs(4, (5, 6, 7))
    return dict(zip(("1d", "2level", "x0", 5, 6, 7),
                    dist.launch(jobs, 4, "cpu")))


def _x0():
    """tests/test_dist_fused.py's x0 start (seed 5, masked)."""
    problem = jbp4.build(6, 2, dtype=jnp.float64, backend="pallas",
                         windowing="pieces")
    lat = problem.layout.n_nodes_axis
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((3,) + lat) * np.asarray(
        problem.op.mask).reshape((1,) + lat)
    return torch.as_tensor(x0)


def test_two_level_is_the_1d_solve(runs4):
    """The 2-level (2 slices x 2 chips) grid runs the same z-slabs: itCG,
    the history and x bit for bit equal to the 1D solve's, with the same
    collectives on every rank."""
    a, b = runs4["1d"], runs4["2level"]
    assert a["it"] == b["it"]
    assert np.array_equal(a["history"], b["history"], equal_nan=True)
    assert torch.equal(a["x"], b["x"])
    assert [(r["allreduces"], r["shifts"]) for r in a["ranks"]] == [
        (r["allreduces"], r["shifts"]) for r in b["ranks"]]


def test_x0_start_matches_jax(runs4):
    """The x0 start (tests/test_dist_fused.py:101-128): against the JAX
    distributed solve from the same x0 and the JAX single-device solve,
    itCG identical, x within 1e-11 max(1, |x|)."""
    x0 = _x0().numpy()
    dp, mesh = jdist_fused.build_dist_fused(6, 2, n_devices=4,
                                            dtype=jnp.float64)
    pp = dp.b.shape[2] - 1
    x0_sl = np.stack([x0[:, d * pp:d * pp + pp + 1] for d in range(4)])
    from jax.sharding import NamedSharding, PartitionSpec as P

    want = jdist_fused.solve_fused(dp, mesh, x0=jax.device_put(
        jnp.asarray(x0_sl), NamedSharding(mesh, P(jdist_fused.AXIS))))
    xw = jdist.gather_global(want.x, nz=x0.shape[1])
    problem = jbp4.build(6, 2, dtype=jnp.float64, backend="pallas",
                         windowing="pieces")
    lat = problem.layout.n_nodes_axis
    ref = jcg_fused.fused_merged_cg_solve(
        problem.op, lat, problem.b.reshape((3,) + lat),
        problem.inv_diag.reshape((1,) + lat), x0=jnp.asarray(x0))
    got = runs4["x0"]
    assert got["it"] == int(want.n_iterations) == int(ref.n_iterations)
    for w in (xw, np.asarray(ref.x).reshape(x0.shape)):
        np.testing.assert_allclose(got["x"].numpy(), w, rtol=0,
                                   atol=1e-11 * max(1.0, np.abs(w).max()))
    # one dist_vmult at entry: two more shifts than the solve's
    it = got["it"]
    assert {r["shifts"] for r in got["ranks"]} == {2 * it + 4}


def test_x0_refused_off_1level_slabs():
    slab = dist.build_slab(6, 2, 0, 1, torch.float64, "pallas", "highest",
                           "pieces", "precomputed", "cpu", axis=(0, 1))
    from mf_data_locality_tpu_torch.parallel import dist_fused

    with pytest.raises(ValueError, match="1-level"):
        dist_fused.solve_fused(slab, None, x0=slab.b)


def test_dryrun_legs_5_to_7_match_jax(runs4):
    """dryrun_multichip(4)'s legs 5-7 (s=6, p=2, f32, 5 iterations): the
    JAX legs' iteration counts and residuals (__graft_entry__.py:162-203)."""
    s, f32 = 6, jnp.float32
    dp, mesh = jdist.build_distributed_2d(s, 2, (2, 2), dtype=f32,
                                          backend="structured")
    want = {5: jdist.solve_2d(dp, mesh, max_iter=5, rel_tol=1e-3)}
    dp, mesh = jdist_fused.build_dist_fused_2d(s, 2, (2, 2), dtype=f32)
    want[6] = jdist_fused.solve_fused_2d(dp, mesh, max_iter=5, rel_tol=1e-3)
    dp, mesh = jdist_fused.build_dist_fused_2level(s, 2, (2, 2), dtype=f32)
    want[7] = jdist_fused.solve_fused(
        dp, mesh, max_iter=5, rel_tol=1e-3,
        axis=(jdist_fused.AXIS_DCN, jdist_fused.AXIS))
    for leg, w in want.items():
        got = runs4[leg]
        assert got["it"] == int(w.n_iterations) == 5
        assert got["res"] == pytest.approx(float(w.res_norm), rel=1e-5)


@pytest.mark.parametrize("n,legs", [(2, (1, 2, 3, 4)), (3, (1, 2, 3, 4)),
                                    (4, (1, 2, 3, 4, 5, 6, 7)),
                                    (6, (1, 2, 3, 4, 5, 6, 7)),
                                    (8, (1, 2, 3, 4, 5, 6, 7, 8)),
                                    (16, (1, 2, 3, 4, 5, 6, 7, 8))])
def test_dryrun_leg_gates(n, legs):
    """The JAX gates (__graft_entry__.py:162, 186, 205): legs 1-4 on every
    rank count, 5-7 on an even rank count >= 4, leg 8 on a multiple of 8;
    leg 4 the general backend's cell chunks; the meshes of
    the legs."""
    assert dryrun.legs_for(n) == legs
    jobs = dict(zip(legs, dryrun.jobs(n)))
    meshes = {leg: job.mesh(n) for leg, job in jobs.items()}
    assert jobs[4].backend == "general" and meshes[4] == (n,)
    if 5 in legs:
        assert meshes[5] == meshes[6] == (n // 2, 2)
        assert meshes[7] == (2, n // 2)
    if 8 in legs:
        assert meshes[8] == (n // 4, 2, 2)
    for leg in set(range(5, 9)) - set(legs):
        with pytest.raises(ValueError, match="does not run"):
            dryrun.jobs(n, (leg,))


@pytest.mark.parametrize("mesh", [(6,), (3, 2), (2, 1, 3), (2, 3)])
def test_rank_grid_neighbours(mesh):
    """Ranks row-major on the grid (the JAX ``Mesh(devs.reshape(...))``):
    the neighbour one step along an axis, None past its edge; along a tuple
    of axes the flattened row-major order (the 2-level z-slabs)."""
    n = int(np.prod(mesh))
    for r in range(n):
        c = comm_mod.Comm(r, n, "cpu")
        c.set_mesh(mesh)
        assert c.coords == np.unravel_index(r, mesh)
        for ax, d in enumerate(mesh):
            for step in (-1, 1):
                k = c.coords[ax] + step
                want = None
                if 0 <= k < d:
                    idx = list(c.coords)
                    idx[ax] = k
                    want = int(np.ravel_multi_index(idx, mesh))
                assert c.neighbour(ax, step) == want
        flat = tuple(range(len(mesh)))
        assert c.neighbour(flat, 1) == (r + 1 if r + 1 < n else None)
        assert c.neighbour(flat, -1) == (r - 1 if r > 0 else None)
    with pytest.raises(ValueError):
        comm_mod.Comm(0, n + 1, "cpu").set_mesh(mesh)
