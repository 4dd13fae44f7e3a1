"""PyTorch port at degrees 5..11 (the reference's table past p=4) under
``highest``: the apply family (plain versions of B3-B6 and the
sum-factorized kernel's arithmetic) against the JAX package's
``laplace_pallas``, the jtj chain, the configuration checks and whole f64
fused solves at the parity points.

The JAX side runs on the CPU as its own tests run it: its Pallas kernels in
interpret mode, f64 (x64 is on) or f32.  Inputs are made with numpy from a
seed.  Tolerances (max |diff| / max |ref|): 1e-12 in f64; 1e-5 in f32, for
another accumulation order (and the JAX f32 Jacobian's split3 products,
ROADMAP C3).  p = 9..11 are marked ``slow`` (their interpret-mode runs take
longest); the card compares every degree in ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu import benchmark as jbench
from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.ops import laplace_pallas as jlp
from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.ops import laplace_cuda
from mf_data_locality_tpu_torch.solvers import cg_fused

S = 3  # 8 cells (2 x 2 x 2)
RUNGS = {"f64": (np.float64, torch.float64, 1e-12),
         "f32": (np.float32, torch.float32, 1e-5)}
HIGH = [5, 6, 7, 8] + [pytest.param(p, marks=pytest.mark.slow)
                       for p in (9, 10, 11)]
# (windowing, metric): B3, B4, B5, B6
APPLY = [("reshape", "precomputed"), ("reshape", "onthefly"),
         ("pieces", "precomputed"), ("zslab", "precomputed")]


def _rel(got, ref):
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("rung", list(RUNGS))
@pytest.mark.parametrize("p", HIGH)
def test_apply_family_matches_jax(p, rung):
    """B3 (reshape, streamed), B4 (reshape, rebuilt), B5 (pieces) and B6
    (zslab): ``vmult`` without the constrained identity through the plain
    versions, and the sum-factorized kernel's arithmetic on the cell batch
    (B3, B4), against the JAX package's."""
    nd, td, tol = RUNGS[rung]
    rng = np.random.default_rng(50 + p)
    u = None
    for windowing, metric in APPLY:
        jp = jbp4.build(S, p, dtype=jnp.dtype(nd), backend="pallas",
                        precision="highest", windowing=windowing,
                        factor="dense", metric=metric)
        tp = bp4.build(S, p, td, "highest", factor="dense", metric=metric,
                       windowing=windowing, device="cpu")
        if u is None:
            u = rng.standard_normal((3,) + jp.layout.n_nodes_axis).astype(nd)
        ref = np.asarray(jlp.vmult(jp.op, jnp.asarray(u),
                                   constrained_identity=False))
        got = la.vmult(tp.op, torch.as_tensor(u), constrained_identity=False)
        assert _rel(got, ref) < tol, (windowing, metric)
        if windowing != "reshape":
            continue
        nc = tp.op.n_cells
        ub = rng.standard_normal((3 * (p + 1) ** 3, nc)).astype(nd)
        ub_pad = np.zeros((ub.shape[0], jp.op.coeffs.shape[2]), nd)
        ub_pad[:, :nc] = ub
        ref = np.asarray(jlp.apply_local_batched(jp.op, jnp.asarray(ub_pad)))
        got = la._batched_sumfac_emulated(tp.op, torch.as_tensor(ub),
                                          la._metric(tp.op))
        assert _rel(got, ref[:, :nc]) < tol, metric


@pytest.mark.parametrize("p", [2, 5, 8])
def test_jtj_equals_adjj_on_the_deformed_box(p):
    """The jtj chain (C = J^T J, G = w adj(C) / sqrt(det C)) and adjj give
    one metric on the sine-deformed box, where det J > 0, and one operator
    (B1's plain version, twostage + onthefly): 1e-12 in f64."""
    ops = {c: bp4.build(S, p, torch.float64, "highest", factor="twostage",
                        metric="onthefly", cofactor=c, windowing="pieces",
                        device="cpu").op for c in laplace_cuda.COFACTORS}
    assert ops["jtj"].cofactor == "jtj"
    ga, gj = (fk.metric_onthefly(ops[c]) for c in ("adjj", "jtj"))
    assert (ga - gj).abs().max() / ga.abs().max() < 1e-12
    assert torch.equal(fk.metric_onthefly(ops["jtj"], "adjj"), ga)
    rng = np.random.default_rng(p)
    u = torch.as_tensor(rng.standard_normal((3,) + ops["adjj"].n_nodes_axis))
    u = u * ops["adjj"].mask
    va, vj = (fk.matvec(ops[c], u) for c in ("adjj", "jtj"))
    assert (va - vj).abs().max() / va.abs().max() < 1e-12


def test_jtj_refuses_reflected_cells():
    """ROADMAP C1: jtj scales by |det J|, adjj by det J.  A coefficient set
    that reflects x (det J < 0 everywhere) is refused under jtj, by
    ``from_jax_arrays`` and ``operator_from_arrays`` alike, and taken under
    adjj; the box itself passes (a deliberate divergence: the JAX package
    does not check)."""
    p = 5
    jp = jbp4.build(S, p, dtype=jnp.float64, backend="pallas",
                    precision="highest", windowing="pieces",
                    factor="twostage", metric="onthefly", cofactor="jtj")
    jop = jp.op
    coeffs = np.asarray(jop.coeffs).copy()
    arrays = dict(pds=np.asarray(jop.pds), w3=np.asarray(jop.w3),
                  mask=np.asarray(jop.mask), b=np.asarray(jp.b),
                  inv_diag=np.asarray(jp.inv_diag), factor="twostage",
                  precision="highest", dtype=torch.float64, device="cpu")
    ok = bp4.from_jax_arrays(S, p, coeffs=coeffs, cofactor="jtj", **arrays)
    assert ok.op.cofactor == "jtj"
    det = laplace_cuda.jacobian_determinants(
        ok.op.pds.numpy(), ok.op.coeffs.numpy())
    assert det.min() > 0
    coeffs[0] *= -1.0  # x -> -x: det J < 0 at every q-point
    with pytest.raises(ValueError, match="det J"):
        bp4.from_jax_arrays(S, p, coeffs=coeffs, cofactor="jtj", **arrays)
    flipped = bp4.from_jax_arrays(S, p, coeffs=coeffs, cofactor="adjj",
                                  **arrays)
    assert flipped.op.cofactor == "adjj"
    with pytest.raises(ValueError, match="det J"):
        laplace_cuda.check_orientation(flipped.op.pds.numpy(),
                                       flipped.op.coeffs.numpy())


@pytest.mark.parametrize("p", list(range(1, 12)))
def test_configurations_at_every_degree(p):
    """``highest`` (f32, f64) takes every (factor, metric) and both
    cofactors at p = 1..11, and the merged and baseline solvers every
    windowing as the JAX resolvers give it (twostage on pieces from p=5,
    which B5 computes as the dense operator); under split2m the fused
    solver takes twostage at every degree (either metric, either chain;
    the auto path twostage + onthefly + jtj from p=5, as the JAX resolvers
    give) and the dense factorization with either chain, and the merged
    and baseline solvers every degree, as the JAX resolvers give them:
    twostage at p=1..3 (6f) and jtj in the dense pass (6c) pass
    ``check_config``, build on the CPU with their configuration and
    resolve as the JAX resolvers resolve them; ``fused_configs`` and the
    fused auto-dispatch agree."""
    for dtype in (torch.float32, torch.float64):
        for factor, metric in laplace_cuda.fused_configs("highest", p):
            for cofactor in laplace_cuda.COFACTORS:
                laplace_cuda.check_config("highest", factor, metric,
                                          cofactor, dtype, "pieces", "fused",
                                          p)
        config = benchmark.resolve_config(p, "fused", "pieces", "highest",
                                          dtype)
        assert config[:2] in laplace_cuda.fused_configs("highest", p)
        assert config[0] == ("twostage" if p >= 5 else "dense")
        for solver in ("merged", "baseline"):
            for windowing in ("reshape", "pieces", "zslab"):
                factor, metric, _ = benchmark.resolve_config(
                    p, solver, windowing, "highest", dtype)
                assert factor == jbench.resolve_factor(
                    "auto", p, windowing, precision="highest", solver=solver)
                assert metric == "precomputed"
    assert len(laplace_cuda.fused_configs("highest", p)) == 4
    split = laplace_cuda.fused_configs("split2m", p)
    assert ("dense", "onthefly") in split
    assert ("dense", "precomputed") in split
    assert ("twostage", "onthefly") in split
    assert ("twostage", "precomputed") in split
    for f, m, c in (("twostage", "onthefly", "jtj"),
                    ("twostage", "onthefly", "adjj"),
                    ("twostage", "precomputed", "adjj"),
                    ("dense", "onthefly", "jtj")):
        laplace_cuda.check_config("split2m", f, m, c, torch.float32,
                                  "pieces", "fused", p)
        kw = dict(factor=f, metric=m, cofactor=c)
        jf = jbench.resolve_factor(f, p, "pieces", precision="split2m",
                                   solver="fused")
        jm = jbench.resolve_metric(m, "fused", "pieces", jf, p,
                                   precision="split2m")
        assert benchmark.resolve_config(
            p, "fused", "pieces", "split2m", torch.float32, **kw) == (
            jf, jm, jbench.resolve_cofactor(c, p, jf, jm,
                                            precision="split2m"))
        op = bp4.build(1, p, torch.float32, "split2m", windowing="pieces",
                       device="cpu", **kw).op
        assert (op.factor, op.metric, op.cofactor) == (f, m, c)
    config = benchmark.resolve_config(p, "fused", "pieces", "split2m",
                                      torch.float32)
    jf = jbench.resolve_factor("auto", p, "pieces", precision="split2m",
                               solver="fused")
    jm = jbench.resolve_metric("auto", "fused", "pieces", jf, p,
                               precision="split2m")
    assert config == (jf, jm, jbench.resolve_cofactor("auto", p, jf, jm,
                                                      precision="split2m"))
    assert config[:2] in split
    if p >= 5:
        assert config == ("twostage", "onthefly", "jtj")
        for solver, windowing, kw in (
                ("fused", "pieces", {"factor": "dense"}),
                ("merged", "reshape", {}), ("merged", "pieces", {}),
                ("baseline", "zslab", {})):
            jf = jbench.resolve_factor(kw.get("factor", "auto"), p,
                                       windowing, precision="split2m",
                                       solver=solver)
            jm = jbench.resolve_metric("auto", solver, windowing, jf, p,
                                       precision="split2m")
            assert benchmark.resolve_config(
                p, solver, windowing, "split2m", torch.float32, **kw) == (
                jf, jm, "adjj")


def test_run_one_refuses_split2m_past_p4():
    """``run_one(p >= 5, ..., precision="split2m")`` on the dense
    tensor-core pass (merged, baseline, the fused solver's dense
    factorization) and on the fused solver's twostage path resolves and,
    on the CPU, raises for lack of a card: no fallback to ``highest`` or to
    the plain version; the builder gives the dense operator with its
    tables."""
    for p, kw in ((5, dict(solver="fused", windowing="pieces",
                           factor="dense")),
                  (8, dict(solver="merged")),
                  (11, dict(solver="baseline", windowing="zslab"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            benchmark.run_one(p, 6, precision="split2m", device="cpu", **kw)
    op = bp4.build(S, 6, torch.float32, "split2m", device="cpu").op
    assert (op.factor, op.metric, op.windowing) == ("dense", "precomputed",
                                                    "reshape")
    assert op.mma_mats.shape == (2, 3 * 512 * 352)
    for p, kw in ((5, {}), (11, dict(metric="precomputed"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            benchmark.run_one(p, 3, solver="fused", windowing="pieces",
                              precision="split2m", device="cpu", **kw)


@pytest.mark.parametrize("p,s,n", [(5, 6, 95), (6, 4, 75)])
def test_fused_solve_f64_matches_jax_merged(p, s, n):
    """The slice whole on the CPU: the fused f64 solve through the port's
    resolvers (the auto path, twostage + the streamed metric, and
    ``--geometry onthefly``, twostage + the rebuilt metric by jtj) takes
    PARITY.md's itCG, equal to the JAX merged CG's at the same point.  The
    residual histories agree to 1e-10 relative for the first 50 iterations;
    later, CG amplifies rounding (the JAX package's own structured and
    Pallas backends differ by 1e-2 relative at iteration 90 of p=5 s=6),
    so the whole history is held within 1e-8 of res0, the solve's
    tolerance."""
    jp = jbp4.build(s, p, dtype=jnp.float64, backend="pallas")
    ref = jbp4.solve_merged(jp)
    assert int(ref.n_iterations) == n and bool(ref.converged)
    hr = np.asarray(ref.res_history)[:n + 1]
    for kw in ({}, {"metric": "onthefly"}):
        config = benchmark.resolve_config(p, "fused", "pieces", "highest",
                                          torch.float64, **kw)
        assert config == ("twostage", kw.get("metric", "precomputed"),
                          "jtj" if kw else "adjj")
        tp = bp4.build(s, p, torch.float64, "highest", windowing="pieces",
                       device="cpu", **dict(zip(("factor", "metric",
                                                 "cofactor"), config)))
        lat = tp.layout.n_nodes_axis
        res = cg_fused.fused_merged_cg_solve(
            tp.op, lat, tp.b.reshape((3,) + lat),
            tp.inv_diag.reshape((1,) + lat))
        assert res.n_iterations == n and res.converged
        h = res.res_history.numpy()[:n + 1]
        np.testing.assert_allclose(h[:51], hr[:51], rtol=1e-10)
        np.testing.assert_allclose(h, hr, rtol=0, atol=1e-8 * hr[0])
