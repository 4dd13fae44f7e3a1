"""PyTorch port: host setup (quadrature, bases, mesh, DoFs, diagonal,
operator arrays) against the JAX package, at small sizes."""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.mesh.box import BoxMesh as JBoxMesh
from mf_data_locality_tpu.mesh.dofs import DofLayout as JDofLayout
from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.ops import diagonal as jdiagonal
from mf_data_locality_tpu.ops import geometry as jgeometry
from mf_data_locality_tpu.ops import lagrange as jlagrange
from mf_data_locality_tpu.ops import laplace_pallas as jlp
from mf_data_locality_tpu.ops import quadrature as jquadrature
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import (diagonal, geometry, lagrange,
                                            laplace_cuda, quadrature)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 8])
def test_gauss_matches(n):
    for a, b in zip(quadrature.gauss(n), jquadrature.gauss(n)):
        np.testing.assert_array_equal(a, b)
    if n >= 2:
        for a, b in zip(quadrature.gauss_lobatto(n),
                        jquadrature.gauss_lobatto(n)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_shapes_match(degree):
    for mine, ref in ((lagrange.make_shape(degree, degree + 2),
                       jlagrange.make_shape(degree, degree + 2)),
                      (lagrange.make_shape_gll(degree),
                       jlagrange.make_shape_gll(degree))):
        for name in ("nodes", "q_points", "q_weights", "values", "grads",
                     "d_col", "d_nod"):
            np.testing.assert_array_equal(getattr(mine, name),
                                          getattr(ref, name), err_msg=name)


@pytest.mark.parametrize("s", [3, 4, 5])
def test_mesh_and_coefficients_match(s):
    """Cell vertices within 1e-15 (the JAX package may build them with its
    native library), trilinear coefficients within 1e-15."""
    mine, ref = BoxMesh.from_s(s), JBoxMesh.from_s(s)
    assert mine.n_cells_axis == ref.n_cells_axis
    assert mine.spacing == ref.spacing
    np.testing.assert_allclose(mine.cell_vertices, ref.cell_vertices,
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(
        geometry.trilinear_coefficients(mine.cell_vertices),
        jgeometry.trilinear_coefficients(ref.cell_vertices),
        rtol=0, atol=1e-15)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_dofs_match(degree):
    mine = DofLayout(BoxMesh.from_s(4), degree)
    ref = JDofLayout(JBoxMesh.from_s(4), degree)
    assert mine.n_nodes_axis == ref.n_nodes_axis
    assert mine.n_nodes == ref.n_nodes
    np.testing.assert_array_equal(mine.boundary_node_mask,
                                  np.asarray(ref.boundary_node_mask))
    np.testing.assert_array_equal(mine.gather_map, np.asarray(ref.gather_map))


@pytest.mark.parametrize("s,degree", [(3, 1), (3, 2), (4, 3), (4, 4)])
def test_inverse_diagonal_matches(s, degree):
    mine = diagonal.compute_inverse_diagonal(
        DofLayout(BoxMesh.from_s(s), degree))
    ref = jdiagonal.compute_inverse_diagonal(
        JDofLayout(JBoxMesh.from_s(s), degree))
    np.testing.assert_allclose(mine, ref, rtol=1e-15, atol=0)


@pytest.mark.parametrize("dtype,tdtype,precision", [
    (jnp.float64, torch.float64, "highest"),
    (jnp.float32, torch.float32, "split2m")])
def test_build_matches_jax_arrays(dtype, tdtype, precision):
    """The port's own build equals the converter applied to the JAX
    problem: operator arrays (mats2d with the piece permutation undone),
    mask, RHS and inverse diagonal."""
    s, p = 4, 4
    jp = jbp4.build(s, p, dtype=dtype, backend="pallas", precision=precision,
                    windowing="pieces", factor="twostage", metric="onthefly",
                    cofactor="adjj")
    jop = jp.op
    conv = bp4.from_jax_arrays(
        s, p, mats2d=np.asarray(jop.mats2d), pds=np.asarray(jop.pds),
        w3=np.asarray(jop.w3), coeffs=np.asarray(jop.coeffs),
        mask=np.asarray(jop.mask), b=np.asarray(jp.b),
        inv_diag=np.asarray(jp.inv_diag), precision=precision, dtype=tdtype,
        device="cpu")
    own = bp4.build(s, p, dtype=tdtype, precision=precision, device="cpu",
                    factor="twostage", metric="onthefly", windowing="pieces")
    for name in ("mats2d", "sz", "dz", "pds", "w3", "coeffs", "mask",
                 "kpds", "kcoeffs"):
        a, b = getattr(own.op, name), getattr(conv.op, name)
        assert a.dtype == tdtype, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-15, err_msg=name)
    np.testing.assert_array_equal(own.b.numpy(), conv.b.numpy())
    np.testing.assert_allclose(own.inv_diag.numpy(), conv.inv_diag.numpy(),
                               rtol=1e-15 if tdtype == torch.float64 else 0)
    assert own.n_dofs == jp.n_dofs


def test_operator_rejects_unported_configurations():
    """Configurations the JAX package has and the port does not yet
    (ROADMAP queue B) raise, each spelled out in full; split2m at f64 (6h's
    split2m half) builds, at f64 with the dense or the 2D stage's bf16
    tables, while split3 and bf16 at f64 still raise naming 6h; a bf16
    state under split3 (6d) builds, its tables f32; split2m's dense pass
    with the metric rebuilt by jtj (6c) builds, keeping the chain;
    split2m's dense pass past p=4 (the apply family, the fused dense)
    builds, with the dense M's tables, B5 on a twostage operator too."""
    layout = DofLayout(BoxMesh.from_s(3), 4)
    fused = {"factor": "twostage", "metric": "onthefly",
             "windowing": "pieces"}
    dense = {"factor": "dense", "metric": "onthefly", "windowing": "pieces"}
    for kw in ({**fused, "windowing": "reshape"},
               {"precision": "split2m", "dtype": torch.float64},
               {**fused, "precision": "split2m", "dtype": torch.float64}):
        if kw.get("precision") != "split2m":
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                laplace_cuda.make_operator(layout, device="cpu", **kw)
            continue
        op = laplace_cuda.make_operator(layout, device="cpu", **kw)
        assert (op.dtype, op.precision) == (torch.float64, "split2m")
        assert op.mma_mats.shape == (2, 3 * math.prod(laplace_cuda.mma_dims(
            4, op.factor)))
        for rung in ("split3", "bf16"):
            with pytest.raises(NotImplementedError, match="item 6h"):
                laplace_cuda.make_operator(layout, device="cpu",
                                           **{**kw, "precision": rung})
    op = laplace_cuda.make_operator(layout, device="cpu", **dense,
                                    precision="split2m", cofactor="jtj")
    assert (op.factor, op.metric, op.cofactor) == ("dense", "onthefly", "jtj")
    assert op.mma_mats.shape == (2, 3 * math.prod(laplace_cuda.mma_dims(4)))
    for kw in ({"precision": "split3", "dtype": torch.bfloat16},
               {**fused, "precision": "split3", "dtype": torch.bfloat16}):
        op = laplace_cuda.make_operator(layout, device="cpu", **kw)
        assert op.dtype == torch.float32 and op.precision == "split3"
    # split2m's dense pass past p=4 (the apply family, the fused dense)
    layout = DofLayout(BoxMesh.from_s(1), 5)
    rp, cp = laplace_cuda.mma_dims(5)
    for kw in ({"precision": "split2m"}, {**dense, "precision": "split2m"},
               {**fused, "precision": "split2m", "metric": "precomputed"}):
        op = laplace_cuda.make_operator(layout, device="cpu", **kw)
        tables = laplace_cuda.dense_mma_tables(op)
        assert tables.shape == (2, 3 * rp * cp)
        assert tables is laplace_cuda.dense_mma_tables(op)  # built once
        fwd, bwd = laplace_cuda.unpack_mma_tables(tables, 5)
        want = torch.zeros((3, rp, cp), dtype=torch.bfloat16)
        want[:, :7 ** 3, :6 ** 3] = op.mats.reshape(3, 7 ** 3, 6 ** 3).to(
            torch.bfloat16)
        assert torch.equal(bwd, want.reshape(3 * rp, cp))
        assert torch.equal(fwd, bwd)


def test_build_defaults_match_jax():
    """``bp4.build`` and ``make_operator`` default to the JAX ``bp4.build``'s
    and ``make_pallas_operator``'s configuration: highest, dense,
    precomputed, reshape, adjj."""
    names = ("precision", "factor", "metric", "windowing", "cofactor")

    def defaults(fn):
        params = inspect.signature(fn).parameters
        return {n: params[n].default for n in names}

    want = defaults(jbp4.build)
    assert want == {"precision": "highest", "factor": "dense",
                    "metric": "precomputed", "windowing": "reshape",
                    "cofactor": "adjj"}
    assert defaults(jlp.make_pallas_operator) == want
    for fn in (bp4.build, laplace_cuda.make_operator):
        assert defaults(fn) == want, fn.__name__


def test_builders_default_to_the_card():
    """The public builders put the operator on the card unless the caller
    asks for the CPU (the tests pass ``device="cpu"``)."""
    for fn in (bp4.build, bp4.from_jax_arrays, laplace_cuda.make_operator,
               laplace_cuda.operator_from_arrays):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__name__
