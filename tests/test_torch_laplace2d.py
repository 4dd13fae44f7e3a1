"""PyTorch port: ``ops/laplace2d.py``, the reference's dim == 2 operator,
against the JAX package's ``ops.laplace2d``.

At the four (cells, p) cases of ``tests/test_laplace2d.py``: the layout's
arrays and ``make_operator2d``'s equal to JAX's (bit for bit: the same
host arithmetic), ``vmult2d`` in f64 within 1e-12 of JAX's relative to
its largest entry and against JAX's ``assemble_dense2d``; the
operator's symmetry and the null space of ``local_apply2d``; the JAX
operator's arrays carried across (``from_jax_arrays``); and the (8, 8)
p=2 merged CG with the identity preconditioner through the port's
``cg_merged``: itCG equal to JAX's, x within 1e-10 max|x|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.ops import laplace2d as jl2
from mf_data_locality_tpu.solvers import cg_merged as jcg_merged
from mf_data_locality_tpu_torch.ops import laplace2d as l2
from mf_data_locality_tpu_torch.solvers import cg_merged

TOL = 1e-12
CASES = [((2, 2), 1), ((3, 2), 2), ((2, 3), 3), ((4, 4), 2)]
OP_FIELDS = ("values", "d_col", "q_uv", "q_w2", "coeffs", "gather",
             "unconstrained")
jvmult2d = jax.jit(jl2.vmult2d, static_argnums=2)


def _layouts(nc, p):
    spacing = 1.0 / max(nc)
    return (l2.DofLayout2D(l2.BoxMesh2D(n_cells_axis=nc, spacing=spacing), p),
            jl2.DofLayout2D(jl2.BoxMesh2D(n_cells_axis=nc, spacing=spacing),
                            p))


@pytest.mark.parametrize("nc,p", CASES)
def test_layout_and_operator_match_jax(nc, p):
    lay, jlay = _layouts(nc, p)
    assert lay.n_nodes_axis == jlay.n_nodes_axis
    np.testing.assert_array_equal(lay.gather_map, jlay.gather_map)
    np.testing.assert_array_equal(lay.boundary_node_mask,
                                  jlay.boundary_node_mask)
    np.testing.assert_array_equal(lay.mesh.cell_vertices,
                                  jlay.mesh.cell_vertices)
    np.testing.assert_array_equal(
        l2.bilinear_coefficients(lay.mesh.cell_vertices),
        jl2.bilinear_coefficients(jlay.mesh.cell_vertices))
    op, jop = l2.make_operator2d(lay, device="cpu"), jl2.make_operator2d(jlay)
    assert op.values.dtype == torch.float64
    for name in OP_FIELDS:
        np.testing.assert_array_equal(getattr(op, name).numpy(),
                                      np.asarray(getattr(jop, name)), name)


@pytest.mark.parametrize("nc,p", CASES)
def test_vmult2d_matches_jax(nc, p):
    """vmult2d against JAX's and against JAX's dense matrix; the port's
    dense matrix equal to JAX's; the JAX arrays carried across."""
    lay, jlay = _layouts(nc, p)
    op, jop = l2.make_operator2d(lay, device="cpu"), jl2.make_operator2d(jlay)
    u = np.random.default_rng(0).normal(size=(2, lay.n_nodes))
    got = l2.vmult2d(op, torch.as_tensor(u)).numpy()
    want = np.asarray(jvmult2d(jop, jnp.asarray(u), True))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    K = jl2.assemble_dense2d(jlay)
    np.testing.assert_array_equal(l2.assemble_dense2d(lay), K)
    dense = u @ K.T
    assert np.abs(got - dense).max() <= 1e-11 * np.abs(dense).max()
    carried = l2.from_jax_arrays(*(np.asarray(a) for a in jop), device="cpu")
    torch.testing.assert_close(l2.vmult2d(carried, torch.as_tensor(u)),
                               torch.as_tensor(got), rtol=0, atol=0)


def test_vmult2d_symmetry_and_nullspace():
    lay, _ = _layouts((3, 3), 2)
    op = l2.make_operator2d(lay, device="cpu")
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(2, lay.n_nodes)))
    y = torch.as_tensor(rng.normal(size=(2, lay.n_nodes)))
    a = torch.vdot(y.reshape(-1), l2.vmult2d(op, x).reshape(-1)).item()
    b = torch.vdot(x.reshape(-1), l2.vmult2d(op, y).reshape(-1)).item()
    assert np.isclose(a, b, rtol=1e-12)
    # constants are in the null space of the unmasked cell operator
    nc, p1 = op.gather.shape[0], lay.degree + 1
    ones = torch.ones((2, lay.n_nodes), dtype=torch.float64)
    v_loc = l2.local_apply2d(op, ones[:, op.gather].reshape(2, nc, p1, p1))
    assert v_loc.abs().max().item() < 1e-12


def test_2d_cg_matches_jax():
    """The (8, 8) p=2 solve of tests/test_laplace2d.py with the identity
    preconditioner: the port's merged CG against the JAX package's."""
    lay, jlay = _layouts((8, 8), 2)
    op, jop = l2.make_operator2d(lay, device="cpu"), jl2.make_operator2d(jlay)
    b = np.where(lay.boundary_node_mask, 0.0,
                 np.arange(lay.n_nodes) % 8.0)[None, :]
    res = cg_merged.merged_cg_solve(
        lambda u: l2.vmult2d(op, u, constrained_identity=False),
        torch.as_tensor(b), torch.ones((1, lay.n_nodes), dtype=torch.float64),
        max_iter=300)
    want = jcg_merged.merged_cg_solve(
        lambda u: jvmult2d(jop, u, False), jnp.asarray(b),
        jnp.ones((1, lay.n_nodes)), max_iter=300)
    assert res.converged and bool(want.converged)
    assert res.n_iterations == int(want.n_iterations)
    xw = np.asarray(want.x)
    np.testing.assert_allclose(res.x.numpy(), xw, rtol=0,
                               atol=1e-10 * np.abs(xw).max())
    true_res = (np.linalg.norm(b - l2.vmult2d(op, res.x).numpy())
                / np.linalg.norm(b))
    assert true_res < 2e-8
