"""PyTorch port: the distributed general backend (``parallel/
dist_general.py``) on gloo CPU ranks against the JAX package's
``parallel.dist_general``, at the points of ``tests/test_dist_general.py``.

f64: itCG identical, x within 1e-10 max(1, |x|) of the JAX package's
distributed solve and of the port's own single-device general solve; the
rank decomposition's halo index arrays and weights equal the JAX
package's exactly (the same renumbering), and the halo slices are
contiguous (one offset on a z-slab cut, two owners' sub-slices on
thinner chunks).  Dry-run leg 4 against the JAX leg's solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.parallel import dist_general as jdg
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.parallel import dist_general as dg
from mf_data_locality_tpu_torch.parallel import distributed as dist
from mf_data_locality_tpu_torch.parallel import dryrun

TOL_X = 1e-10
# (s, p, ranks, solver): tests/test_dist_general.py:24's points, and :42's
# non-divisible baseline (64 cells over 3 ranks: chunks 22/22/20)
POINTS = [(6, 2, 4, "merged"), (5, 3, 2, "merged"), (6, 1, 8, "merged"),
          (6, 2, 3, "baseline")]


def _jax_rank_arrays(dp, r: int) -> dict:
    op = jax.tree.map(lambda a: np.asarray(a[r]), dp.op_stack)
    return dict(
        degree=op.values.shape[1] - 1, values=op.values, d_col=op.d_col,
        q_uvw=op.q_uvw, q_w3=op.q_w3, coeffs=op.coeffs, gather=op.gather,
        unconstrained=op.unconstrained, scatter_pos=op.scatter_pos,
        scatter_valid=op.scatter_valid, inv_diag=np.asarray(dp.inv_diag[r]),
        b=np.asarray(dp.b[r]), weight=np.asarray(dp.weight[r]),
        export_idx=np.asarray(dp.export_idx[r]),
        import_idx=np.asarray(dp.import_idx[r]), offsets=dp.offsets,
        n_dofs=dp.n_dofs, n_cells=dp.n_cells)


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for s, p, n, solver in POINTS:
        dp, mesh = jdg.build_dist_general(s, p, n_devices=n,
                                          dtype=jnp.float64)
        res = jdg.solve_general(dp, mesh, solver=solver)
        out[s, p, n, solver] = dp, res, jdg.gather_global_general(
            dp, res.x, s, p)
    return out


@pytest.fixture(scope="module")
def runs(jax_runs):
    """The port's solves, one spawn a rank count: its own build, and on 4
    ranks also the JAX arrays carried across (``general_from_jax_arrays``)
    and dry-run leg 4."""
    out = {}
    for n in sorted({c[2] for c in POINTS}):
        cases = [c for c in POINTS if c[2] == n]
        jobs = [dist.Job(solver, s, p, torch.float64, backend="general")
                for s, p, _, solver in cases]
        if n == 4:
            dp = jax_runs[POINTS[0]][0]
            cases += ["from_jax", "dryrun"]
            jobs += [dist.Job("merged", 6, 2, torch.float64,
                              backend="general",
                              arrays=tuple(_jax_rank_arrays(dp, r)
                                           for r in range(n))),
                     *dryrun.jobs(4, (4,))]
        out.update(zip(cases, dist.launch(jobs, n, "cpu")))
    return out


@pytest.mark.parametrize("case", POINTS, ids=lambda c: "-".join(map(str, c)))
def test_general_matches_jax(runs, jax_runs, case):
    """Against ``solve_general`` on the same rank count: itCG identical, x
    within 1e-10 max(1, |x|), the history to 1e-10 of res0; and against
    the port's single-device general solve."""
    s, p, n, solver = case
    _, want, xw = jax_runs[case]
    got = runs[case]
    assert got["it"] == int(want.n_iterations)
    assert got["converged"] == bool(want.converged)
    x = got["x"].reshape(3, -1).numpy()
    np.testing.assert_allclose(x, xw, rtol=0,
                               atol=TOL_X * max(1.0, np.abs(xw).max()))
    k = got["it"] + 1
    hist = np.asarray(want.res_history)[:k]
    np.testing.assert_allclose(got["history"][:k], hist, rtol=0,
                               atol=1e-10 * hist[0])
    pb = bp4.build(s, p, torch.float64, backend="general", device="cpu")
    ref = (bp4.solve_merged if solver == "merged" else bp4.solve_baseline)(pb)
    assert got["it"] == ref.n_iterations
    xr = ref.x.reshape(3, -1).numpy()
    np.testing.assert_allclose(x, xr, rtol=0,
                               atol=TOL_X * max(1.0, np.abs(xr).max()))


def test_general_from_jax_arrays(runs):
    """The JAX package's rank arrays carried across give the port's own
    build's solve: the same itCG and x to 1e-12."""
    a, b = runs["from_jax"], runs[POINTS[0]]
    assert a["it"] == b["it"]
    np.testing.assert_allclose(a["x"].numpy(), b["x"].numpy(), rtol=0,
                               atol=1e-12 * b["x"].abs().max().item())


def test_dryrun_leg4_matches_jax(runs):
    """Leg 4 (f32, p=2 s=6, 5 iterations to 1e-3) against the JAX leg's
    ``solve_general``: the same iteration count, the residual to 1e-4."""
    got = runs["dryrun"]
    dp, mesh = jdg.build_dist_general(6, 2, n_devices=4, dtype=jnp.float32)
    want = jdg.solve_general(dp, mesh, max_iter=5, rel_tol=1e-3)
    assert got["it"] == int(want.n_iterations) >= 1
    assert got["offsets"] == dp.offsets == (1,)
    assert abs(got["res"] - float(want.res_norm)) <= 1e-4 * float(
        want.res_norm)


@pytest.mark.parametrize("s,p,n", [(6, 2, 4), (6, 1, 8), (5, 3, 3)])
def test_decomposition_matches_jax(jax_runs, s, p, n):
    """Each rank's halo index arrays, weights, gather map and scatter map
    equal the JAX package's (``build_dist_general``) exactly."""
    dp, _ = jdg.build_dist_general(s, p, n_devices=n, dtype=jnp.float64)
    arrays, offsets = dg.general_arrays(DofLayout(BoxMesh.from_s(s), p), n)
    assert offsets == dp.offsets
    for r, a in enumerate(arrays):
        np.testing.assert_array_equal(a["exp"], np.asarray(dp.export_idx[r]))
        np.testing.assert_array_equal(a["imp"], np.asarray(dp.import_idx[r]))
        np.testing.assert_array_equal(a["weight"], np.asarray(dp.weight[r]))
        np.testing.assert_array_equal(a["gather"],
                                      np.asarray(dp.op_stack.gather[r]))
        np.testing.assert_array_equal(a["pos"],
                                      np.asarray(dp.op_stack.scatter_pos[r]))
        np.testing.assert_allclose(a["inv"], np.asarray(dp.inv_diag[r]),
                                   rtol=1e-14, atol=0)


def _halo(s, p, n):
    arrays, offsets = dg.general_arrays(DofLayout(BoxMesh.from_s(s), p), n)
    exp = np.stack([a["exp"] for a in arrays])
    imp = np.stack([a["imp"] for a in arrays])
    wgt = np.stack([a["weight"][0] for a in arrays])
    return offsets, exp, imp, wgt, wgt.shape[1]


def test_halo_slices_are_contiguous_slab_case():
    """A z-slab cut (one rank offset): the import halo is the trailing
    slice, the export halo the end of the owned block
    (``tests/test_dist_general.py:63``)."""
    offsets, exp, imp, wgt, NL = _halo(6, 2, 4)
    assert offsets == (1,)
    for r in range(4):
        own = int(wgt[r].sum())
        real_imp = imp[r, 0][imp[r, 0] != NL - 1]
        real_exp = exp[r, 0][exp[r, 0] != NL - 1]
        assert (real_imp.size > 0) == (r > 0)
        if r > 0:
            assert np.array_equal(np.sort(real_imp),
                                  np.arange(own, own + real_imp.size))
        assert (real_exp.size > 0) == (r < 3)
        if r < 3:
            assert np.array_equal(np.sort(real_exp),
                                  np.arange(own - real_exp.size, own))


def test_halo_multi_offset_per_owner_slices():
    """Chunks thinner than a z-layer reach two owners (offsets {1, 2}):
    the ghost block splits into per-owner contiguous sub-slices in
    owner-offset order (``tests/test_dist_general.py:89``)."""
    offsets, _, imp, wgt, NL = _halo(6, 1, 8)
    assert len(offsets) > 1 and offsets[0] == 1
    for r in range(8):
        own = int(wgt[r].sum())
        groups = [imp[r, k][imp[r, k] != NL - 1] for k in range(len(offsets))]
        allg = np.concatenate(groups)
        if allg.size == 0:
            continue
        assert np.array_equal(np.sort(allg), np.arange(own, own + allg.size))
        start = own
        for g in groups:
            if g.size:
                assert np.array_equal(np.sort(g),
                                      np.arange(start, start + g.size))
                start += g.size


def test_general_refusals():
    with pytest.raises(ValueError, match="ranks >"):
        dg.decompose(DofLayout(BoxMesh.from_s(2), 1), 5)
    with pytest.raises(ValueError, match="--backend pallas"):
        dist.check_distributed("fused", "general", "pieces", "precomputed")
    with pytest.raises(ValueError, match="in-kernel rebuild"):
        dist.check_distributed("merged", "general", "reshape", "onthefly")
