"""PyTorch port: ``mesh/general.py`` (the irregular hex meshes), the
general backend's consumers on them, and ``mesh/manifold.pull_back``,
against the JAX package.

At the points of ``tests/test_general_mesh.py`` (its 5-cell L-shape with
its smooth warp, the full 2x2x2 box): ``macro_hex_layout``'s node
numbering, boundary mask, vertices and corner order exactly equal to the
JAX package's; ``ops/laplace.vmult`` in f64 within 1e-12 (relative to
the largest entry) of JAX ``laplace.vmult``; the inverse diagonal to
1e-13; the merged CG with itCG equal and x within 1e-10 max|x|; the
cell-chunk ranks (``parallel/dist_general``) on 2 gloo CPU ranks against
1 rank (itCG equal, x within 1e-11 max, history within 1e-10 res0) and
the 1-rank solve against JAX ``build_dist_general(n_devices=1)``.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.mesh import general as jgeneral
from mf_data_locality_tpu.mesh import manifold as jmanifold
from mf_data_locality_tpu.ops import diagonal as jdiagonal
from mf_data_locality_tpu.ops import laplace as jlaplace
from mf_data_locality_tpu.parallel import dist_general as jdg
from mf_data_locality_tpu.solvers import cg_merged as jcg_merged
from mf_data_locality_tpu_torch.mesh import manifold
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.mesh.general import macro_hex_layout
from mf_data_locality_tpu_torch.ops import diagonal, laplace
from mf_data_locality_tpu_torch.parallel import distributed as dist
from mf_data_locality_tpu_torch.solvers import cg_merged

TOL = 1e-12
# one compile a shape, not one an operation
jvmult = jax.jit(jlaplace.vmult, static_argnums=2)


def _warp(pts):
    """tests/test_general_mesh.py's smooth non-affine deformation."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return np.stack([
        x + 0.08 * np.sin(1.3 * y + 0.4) * np.cos(0.7 * z),
        y + 0.06 * np.sin(0.9 * x) * np.sin(1.1 * z + 0.2),
        z + 0.07 * np.cos(1.2 * x + 0.1) * np.sin(0.8 * y),
    ], axis=-1)


L_CELLS = np.array([(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0)])
BOX_CELLS = np.stack(np.meshgrid(*(np.arange(2),) * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3)
# a 3x3x2 block without its centre column, cells out of lexicographic
# order: a hole, and a numbering the constructor must keep
HOLE_CELLS = np.array([c for c in np.ndindex(2, 3, 3) if c[1:] != (1, 1)]
                      )[::-1]
CASES = {"L-p1": (L_CELLS, 1, _warp), "L-p2": (L_CELLS, 2, _warp),
         "box-p2": (BOX_CELLS, 2, None), "hole-p3": (HOLE_CELLS, 3, _warp)}


def _b(lay):
    """The merged CG's right-hand side of tests/test_general_mesh.py."""
    n = lay.n_nodes
    b = ((np.arange(n)[:, None] * 3 + np.arange(3)[None, :]) % 8).T
    b = b.astype(float)
    b[:, lay.boundary_node_mask] = 0.0
    return b


@pytest.mark.parametrize("case", CASES)
def test_macro_layout_matches_jax(case):
    cells, p, deform = CASES[case]
    lay = macro_hex_layout(cells, p, deform=deform)
    want = jgeneral.macro_hex_layout(cells, p, deform=deform)
    assert lay.gather_map.dtype == want.gather_map.dtype == np.int32
    np.testing.assert_array_equal(lay.gather_map, want.gather_map)
    np.testing.assert_array_equal(lay.boundary_node_mask,
                                  want.boundary_node_mask)
    np.testing.assert_array_equal(lay.mesh.vertices, want.mesh.vertices)
    np.testing.assert_array_equal(lay.mesh.cells, want.mesh.cells)
    np.testing.assert_array_equal(lay.mesh.cell_vertices,
                                  want.mesh.cell_vertices)
    assert (lay.n_nodes, lay.mesh.n_cells, lay.nodes_per_cell) == (
        want.n_nodes, want.mesh.n_cells, want.nodes_per_cell)


def test_full_box_matches_structured():
    """On the full box the node and boundary counts and the gather map's
    multiplicities are the structured layout's."""
    lay = macro_hex_layout(BOX_CELLS, 2)
    ref = DofLayout(BoxMesh(n_cells_axis=(2, 2, 2), spacing=1.0,
                            deformed=False), 2)
    assert lay.n_nodes == ref.n_nodes
    assert lay.boundary_node_mask.sum() == ref.boundary_node_mask.sum()
    np.testing.assert_array_equal(
        np.bincount(np.bincount(lay.gather_map.reshape(-1))),
        np.bincount(np.bincount(ref.gather_map.reshape(-1))))


def test_macro_layout_refusals():
    with pytest.raises(ValueError, match="duplicate"):
        macro_hex_layout(np.array([(0, 0, 0), (0, 0, 0)]), 1)
    with pytest.raises(ValueError, match=r"\(n_cells, 3\)"):
        macro_hex_layout(np.zeros((2, 2), int), 1)
    with pytest.raises(ValueError, match="non-negative"):
        macro_hex_layout(np.array([(0, -1, 0)]), 1)


@pytest.mark.parametrize("case", ["L-p1", "L-p2"])
def test_vmult_matches_jax(case):
    """The general operator on the irregular mesh: vmult against JAX's
    (the merged CG's form, without the constrained identity; with it, the
    input on the constrained rows), the dense matrices equal, and the
    port's vmult against its own dense matrix."""
    cells, p, deform = CASES[case]
    lay = macro_hex_layout(cells, p, deform=deform)
    jlay = jgeneral.macro_hex_layout(cells, p, deform=deform)
    op = laplace.make_operator(lay, dtype=torch.float64, device="cpu")
    jop = jlaplace.make_operator(jlay, dtype=jnp.float64)
    u = np.random.default_rng(3).standard_normal((3, lay.n_nodes))
    m = lay.boundary_node_mask
    want = np.asarray(jvmult(jop, jnp.asarray(u), False))
    for ci, expect in ((False, want), (True, np.where(m, u, want))):
        v = laplace.vmult(op, torch.as_tensor(u), ci).numpy()
        assert np.abs(v - expect).max() <= TOL * np.abs(expect).max()
    K = laplace.assemble_dense(lay)
    np.testing.assert_allclose(K, jlaplace.assemble_dense(jlay), rtol=0,
                               atol=TOL * np.abs(K).max())
    uc = np.where(m, 0.0, u)
    v = laplace.vmult(op, torch.as_tensor(uc), False).numpy()
    assert np.abs(v - uc @ K.T).max() <= 1e-11 * np.abs(v).max()


def test_inverse_diagonal_matches_jax():
    for cells, p, deform in CASES.values():
        got = diagonal.compute_inverse_diagonal(
            macro_hex_layout(cells, p, deform=deform))
        want = np.asarray(jdiagonal.compute_inverse_diagonal(
            jgeneral.macro_hex_layout(cells, p, deform=deform)))
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


def test_merged_cg_matches_jax():
    """The merged CG with the Jacobi preconditioner on the L-shape at p=2:
    itCG equal to the JAX solve's, x within 1e-10 max|x|."""
    lay = macro_hex_layout(L_CELLS, 2, deform=_warp)
    jlay = jgeneral.macro_hex_layout(L_CELLS, 2, deform=_warp)
    b = _b(lay)
    op = laplace.make_operator(lay, dtype=torch.float64, device="cpu")
    inv = torch.as_tensor(diagonal.compute_inverse_diagonal(lay))[None]
    res = cg_merged.merged_cg_solve(
        lambda u: laplace.vmult(op, u, constrained_identity=False),
        torch.as_tensor(b), inv)
    jop = jlaplace.make_operator(jlay, dtype=jnp.float64)
    want = jcg_merged.merged_cg_solve(
        lambda u: jvmult(jop, u, False),
        jnp.asarray(b),
        jnp.asarray(jdiagonal.compute_inverse_diagonal(jlay))[None])
    assert res.converged and bool(want.converged)
    assert res.n_iterations == int(want.n_iterations)
    xw = np.asarray(want.x)
    np.testing.assert_allclose(res.x.numpy(), xw, rtol=0,
                               atol=1e-10 * np.abs(xw).max())


@pytest.fixture(scope="module")
def rank_runs():
    """The L-shape's merged solve at p=2 on the cell-chunk ranks: 2 gloo
    CPU ranks and 1, one spawn each, the two spawns started together."""
    lay = macro_hex_layout(L_CELLS, 2, deform=_warp)
    job = dist.Job("merged", 0, 2, torch.float64, backend="general",
                   layout=lay)
    with ThreadPoolExecutor(2) as pool:
        runs = {n: pool.submit(dist.launch, [job], n, "cpu") for n in (1, 2)}
        return {n: run.result(timeout=300)[0] for n, run in runs.items()}


def test_dist_general_two_ranks_match_one(rank_runs):
    one, two = rank_runs[1], rank_runs[2]
    assert two["it"] == one["it"] and two["converged"] and one["converged"]
    assert two["offsets"] == (1,) and one["offsets"] == ()
    assert two["n_cells"] == 5 and two["n_dofs"] == 3 * two["x"].shape[1]
    x1 = one["x"].numpy()
    np.testing.assert_allclose(two["x"].numpy(), x1, rtol=0,
                               atol=1e-11 * max(1.0, np.abs(x1).max()))
    k = one["it"] + 1
    np.testing.assert_allclose(two["history"][:k], one["history"][:k],
                               rtol=0, atol=1e-10 * one["history"][0])


def test_dist_general_one_rank_matches_jax(rank_runs):
    """The port's 1-rank solve against JAX ``solve_general`` on one
    device: itCG equal, x within 1e-11 max, the history to 1e-10 res0."""
    jlay = jgeneral.macro_hex_layout(L_CELLS, 2, deform=_warp)
    dp, mesh = jdg.build_dist_general(0, 2, n_devices=1, dtype=jnp.float64,
                                      layout=jlay)
    want = jdg.solve_general(dp, mesh)
    xw = jdg.gather_global_general(dp, want.x, 0, 2, layout=jlay)
    got = rank_runs[1]
    assert got["it"] == int(want.n_iterations)
    np.testing.assert_allclose(got["x"].numpy(), xw, rtol=0,
                               atol=1e-11 * max(1.0, np.abs(xw).max()))
    hist = np.asarray(want.res_history)[:got["it"] + 1]
    np.testing.assert_allclose(got["history"][:hist.size], hist, rtol=0,
                               atol=1e-10 * hist[0])


def test_job_layout_needs_the_general_backend():
    with pytest.raises(ValueError, match="general backend"):
        dist.Job("merged", 0, 2, layout=macro_hex_layout(L_CELLS, 2))


def test_pull_back_matches_jax():
    """The Newton inverse of the chart: the round trip to 1e-10, and the
    JAX package's result to 1e-14, in 3D and in 2D."""
    rng = np.random.default_rng(0)
    for dim in (3, 2):
        pts = rng.uniform(0, 1, size=(200, dim))
        fwd = manifold.push_forward(pts)
        back = manifold.pull_back(fwd)
        assert np.allclose(back, pts, atol=1e-10)
        np.testing.assert_allclose(back, jmanifold.pull_back(fwd), rtol=0,
                                   atol=1e-14)
    with pytest.raises(RuntimeError, match="did not converge"):
        manifold.pull_back(fwd, max_iter=1)
