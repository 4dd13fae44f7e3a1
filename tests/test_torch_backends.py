"""PyTorch port: the structured and general backends, the locality
renumbering, ``n_q`` / ``n_components``, and the harness's refusals,
against the JAX package.

Both backends are plain PyTorch in the port (the JAX package computes
them in XLA contractions, no Pallas kernel).  Same inputs, made from a
seed with numpy; f64 on the CPU: ``vmult`` within 1e-12 of the JAX one
relative to its largest entry, and of the port's own ``assemble_dense``
(the summation orders differ), ``assemble_dense`` within 1e-12 of JAX's,
the permutation identical.  The kernels of ``pallas`` take 1 or 3
components and q = p + 1 or p + 2 and refuse the others (``ROADMAP.md``
queue B item 6g).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.mesh import renumber as jrn
from mf_data_locality_tpu.mesh.box import BoxMesh as JBoxMesh
from mf_data_locality_tpu.mesh.dofs import DofLayout as JDofLayout
from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.ops import laplace as jlaplace
from mf_data_locality_tpu.ops import laplace_structured as jstructured
from mf_data_locality_tpu.solvers import cg as jcg
from mf_data_locality_tpu.solvers import cg_merged as jcg_merged
from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.mesh import renumber
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import (laplace, laplace_cuda,
                                            laplace_structured)
from mf_data_locality_tpu_torch.solvers import cg, cg_merged

TOL = 1e-12


def _layouts(s, p, deformed=True):
    return (JDofLayout(JBoxMesh.from_s(s, deformed=deformed), p),
            DofLayout(BoxMesh.from_s(s, deformed=deformed), p))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _vector(layout, n_comp, seed=0):
    return np.random.default_rng(seed).standard_normal((n_comp,
                                                        layout.n_nodes))


def _ops(backend, jlay, lay, n_q):
    if backend == "structured":
        return (jstructured.make_structured_operator(jlay, n_q=n_q,
                                                     dtype=jnp.float64),
                laplace_structured.make_structured_operator(
                    lay, n_q=n_q, dtype=torch.float64, device="cpu"))
    return (jlaplace.make_operator(jlay, n_q=n_q, dtype=jnp.float64),
            laplace.make_operator(lay, n_q=n_q, dtype=torch.float64,
                                  device="cpu"))


def _apply(backend, op, u, lay, ci, mod):
    if backend == "structured":
        lat = (u.shape[0],) + lay.n_nodes_axis
        return mod.vmult(op, u.reshape(lat), constrained_identity=ci
                         ).reshape(u.shape)
    return mod.vmult(op, u, constrained_identity=ci)


@pytest.mark.parametrize("ci", [True, False])
@pytest.mark.parametrize("p,s,n_q,n_comp", [(1, 5, None, 3), (2, 4, None, 3),
                                            (3, 3, None, 3), (2, 3, 5, 3),
                                            (3, 2, None, 1), (2, 3, 5, 1)])
@pytest.mark.parametrize("backend", ["structured", "general"])
def test_vmult_matches_jax(backend, p, s, n_q, n_comp, ci):
    """Any q (p + 3 among them) and any component count (1: BP1/BP3)."""
    jlay, lay = _layouts(s, p)
    jop, op = _ops(backend, jlay, lay, n_q)
    u = _vector(lay, n_comp)
    jmod = jstructured if backend == "structured" else jlaplace
    tmod = laplace_structured if backend == "structured" else laplace
    want = _apply(backend, jop, jnp.asarray(u), lay, ci, jmod)
    got = _apply(backend, op, torch.tensor(u), lay, ci, tmod)
    _close(got.numpy(), want)


@pytest.mark.parametrize("p,s", [(1, 3), (2, 2), (3, 1)])
@pytest.mark.parametrize("backend", ["structured", "general"])
def test_vmult_matches_assembled_matrix(backend, p, s):
    """Each component's block is the port's ``assemble_dense``."""
    jlay, lay = _layouts(s, p)
    _, op = _ops(backend, jlay, lay, None)
    K = laplace.assemble_dense(lay)
    u = _vector(lay, 3, seed=1)
    tmod = laplace_structured if backend == "structured" else laplace
    got = _apply(backend, op, torch.tensor(u), lay, True, tmod)
    _close(got.numpy(), u @ K.T)


@pytest.mark.parametrize("rule,n_q", [("gauss", None), ("gauss", 5),
                                      ("gll", None)])
@pytest.mark.parametrize("p,s", [(1, 3), (2, 2)])
def test_assemble_dense_matches_jax(p, s, rule, n_q):
    jlay, lay = _layouts(s, p)
    _close(laplace.assemble_dense(lay, n_q=n_q, rule=rule),
           jlaplace.assemble_dense(jlay, n_q=n_q, rule=rule))


def test_tvmult_and_vmult_add():
    jlay, lay = _layouts(3, 2)
    jop, op = _ops("general", jlay, lay, None)
    u, v = _vector(lay, 3, 2), _vector(lay, 3, 3)
    _close(laplace.tvmult(op, torch.tensor(u)).numpy(),
           jlaplace.tvmult(jop, jnp.asarray(u)))
    _close(laplace.vmult_add(op, torch.tensor(v), torch.tensor(u)).numpy(),
           jlaplace.vmult_add(jop, jnp.asarray(v), jnp.asarray(u)))


@pytest.mark.parametrize("kwargs", [
    {}, {"touch_order": "last"}, {"grouping": "none"},
    {"grouping": "touch_count_cellbatch", "batch_cells": 4},
    {"batch_cells": 8}])
@pytest.mark.parametrize("p,s", [(1, 4), (2, 3)])
def test_locality_permutation_matches_jax(p, s, kwargs):
    jlay, lay = _layouts(s, p)
    ghosts = np.zeros(lay.n_nodes, bool)
    ghosts[::7] = True
    for gf in (None, ghosts):
        perm, n_int = renumber.locality_permutation_np(
            lay.gather_map, lay.n_nodes, gf, **kwargs)
        jperm, jn_int = jrn.locality_permutation_np(
            np.asarray(jlay.gather_map), jlay.n_nodes, gf, **kwargs)
        assert np.array_equal(perm, jperm) and n_int == jn_int
    perm, _ = renumber.locality_permutation(lay.gather_map, lay.n_nodes)
    assert np.array_equal(np.sort(perm), np.arange(lay.n_nodes))


@pytest.mark.parametrize("p,s", [(1, 4), (2, 3)])
def test_renumber_operator_matches_jax(p, s):
    """The renumbered operator (gather map, mask and transposed scatter
    map) applies the same operator in the new numbering, as JAX's."""
    jlay, lay = _layouts(s, p)
    jop, op = _ops("general", jlay, lay, None)
    perm, _ = renumber.locality_permutation(lay.gather_map, lay.n_nodes)
    op2 = laplace.renumber_operator(op, perm)
    jop2 = jlaplace.renumber_operator(jop, perm)
    assert np.array_equal(op2.gather.numpy(), np.asarray(jop2.gather))
    assert np.array_equal(op2.scatter_pos.numpy(),
                          np.asarray(jop2.scatter_pos))
    u = _vector(lay, 3, 4)
    u2 = renumber.permute_nodes(u, perm)
    got = laplace.vmult(op2, torch.tensor(u2)).numpy()
    _close(got, jlaplace.vmult(jop2, jnp.asarray(u2)))
    _close(got, renumber.permute_nodes(
        laplace.vmult(op, torch.tensor(u)).numpy(), perm))


@pytest.mark.parametrize("solver", ["merged", "baseline"])
@pytest.mark.parametrize("backend", ["structured", "general"])
def test_backend_solves_match_jax(backend, solver):
    """The slice end to end: ``bp4.build(backend=)`` and the merged or
    baseline CG on flat vectors, f64: the same count, histories within
    1e-10 of the initial residual."""
    jp = jbp4.build(4, 2, dtype=jnp.float64, backend=backend)
    tp = bp4.build(4, 2, torch.float64, device="cpu", backend=backend)
    assert tp.backend == backend and tp.n_q == 4
    _close(tp.b.numpy(), np.asarray(jp.b), 0.0)
    _close(tp.inv_diag.numpy(), np.asarray(jp.inv_diag))
    ci = solver == "baseline"
    jsolve = jcg.cg_solve if ci else jcg_merged.merged_cg_solve
    tsolve = cg.cg_solve if ci else cg_merged.merged_cg_solve
    ref = jsolve(jp.a_apply_full if ci else jp.a_apply, jp.b, jp.inv_diag)
    res = tsolve(tp.a_apply_full if ci else tp.a_apply, tp.b, tp.inv_diag)
    n = int(ref.n_iterations)
    assert res.n_iterations == n
    hr = np.asarray(ref.res_history)[:n + 1]
    np.testing.assert_allclose(res.res_history.numpy()[:n + 1], hr, rtol=0,
                               atol=1e-10 * hr[0])


@pytest.mark.parametrize("backend", ["structured", "general"])
def test_build_takes_n_q_and_n_components(backend):
    """n_components = 1 and q = p + 3 on the plain backends: the RHS
    pattern and the operator as the JAX ``bp4.build``'s."""
    jp = jbp4.build(3, 2, dtype=jnp.float64, n_components=1, n_q=5,
                    backend=backend)
    tp = bp4.build(3, 2, torch.float64, device="cpu", n_components=1,
                   n_q=5, backend=backend)
    assert tp.n_components == 1 and tp.n_dofs == tp.layout.n_nodes
    assert tp.n_q == 5
    _close(tp.b.numpy(), np.asarray(jp.b), 0.0)
    _close(tp.a_apply_full(tp.b).numpy(), jp.a_apply_full(jp.b))


def test_pallas_refuses_other_q_and_components():
    """Queue B item 6g, what stays of it: q = p + 3, two components and a
    bf16 state at q = p + 1 are refused by the builders and the kernels'
    checks; BP3 (one component) and q = p + 1 are taken, and at one
    component and q = p + 2 the bf16 state too."""
    with pytest.raises(NotImplementedError, match="6g"):
        bp4.build(3, 2, torch.float64, device="cpu", n_q=5)
    with pytest.raises(NotImplementedError, match="6g"):
        bp4.build(3, 2, torch.float64, device="cpu", n_components=2)
    with pytest.raises(NotImplementedError, match="6g"):
        bp4.build(3, 2, torch.bfloat16, "split2m", device="cpu",
                  n_components=1, n_q=3)
    pb = bp4.build(3, 2, torch.bfloat16, "split2m", device="cpu",
                   n_components=1)
    assert pb.b.dtype == torch.bfloat16 and pb.b.shape[0] == 1
    op = bp4.build(3, 2, torch.float64, device="cpu").op
    with pytest.raises(NotImplementedError, match="6g"):
        fk.check_kernel_shape(op, 2)
    assert fk.check_kernel_shape(pb.op, 1, torch.bfloat16) == \
        laplace_cuda.SHAPE_C1
    assert fk.check_kernel_shape(op, 3) == 0
    assert fk.check_kernel_shape(op, 1) == laplace_cuda.SHAPE_C1
    q1 = bp4.build(3, 2, torch.float64, device="cpu", n_q=3,
                   n_components=1).op
    assert fk.check_kernel_shape(q1, 1) == (laplace_cuda.SHAPE_C1
                                            | laplace_cuda.SHAPE_Q1)


def test_bf16_state_only_on_pallas():
    for backend in ("structured", "general"):
        with pytest.raises(ValueError, match="pallas"):
            bp4.build(3, 2, torch.bfloat16, "bf16", device="cpu",
                      backend=backend)


def test_run_one_refusals():
    """The JAX harness's refusals, before any device is needed: the fused
    solver off pallas + pieces, and a prebuilt problem of another
    configuration (``mf_data_locality_tpu/benchmark.py:230-251,270``)."""
    with pytest.raises(ValueError, match="--backend pallas"):
        benchmark.run_one(2, 3, solver="fused", backend="structured",
                          windowing="pieces", device="cpu")
    problem = bp4.build(3, 2, torch.float64, device="cpu")  # precomputed
    with pytest.raises(ValueError, match="geometry"):
        benchmark.run_one(2, 3, dtype=torch.float64, metric="onthefly",
                          problem=problem, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        benchmark.run_one(2, 3, precision="split2m", device="cpu",
                          problem=bp4.build(3, 2, device="cpu"))
    with pytest.raises(ValueError, match="backend"):
        benchmark.run_one(2, 3, dtype=torch.float64, backend="general",
                          problem=problem, device="cpu")
    fused = bp4.build(3, 2, torch.float64, "highest", factor="twostage",
                      metric="onthefly", windowing="pieces", device="cpu")
    with pytest.raises(ValueError, match="factor"):
        benchmark.run_one(2, 3, solver="fused", dtype=torch.float64,
                          windowing="pieces", factor="dense",
                          metric="onthefly", problem=fused, device="cpu")
    with pytest.raises(ValueError, match="cofactor"):
        benchmark.run_one(2, 3, solver="fused", dtype=torch.float64,
                          windowing="pieces", factor="twostage",
                          metric="onthefly", cofactor="jtj", problem=fused,
                          device="cpu")
    # the matching configuration passes the checks and then needs the card
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark.run_one(2, 3, dtype=torch.float64, problem=problem,
                          device="cpu")


def test_cli_takes_backend_and_storage_flags():
    """``--backend``, ``--prec-dtype`` and ``--x-dtype`` reach run_one; on
    the CPU the run stops at the device check, after the refusals."""
    with pytest.raises(ValueError, match="--backend pallas"):
        benchmark.main(["2", "3", "--solver", "fused", "--windowing",
                        "pieces", "--backend", "general", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark.main(["2", "3", "--solver", "fused", "--windowing",
                        "pieces", "--prec-dtype", "bf16", "--x-dtype",
                        "bf16", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark.main(["2", "3", "--backend", "structured", "--device",
                        "cpu"])
