"""PyTorch port: the fused solver's side of the reduced rungs ``split3``
and ``bf16`` against the JAX package — B1/B2 in twostage at p=4..6, the
bf16 state (``dtype=torch.bfloat16``), the bf16 metric stream on B1, and
the fused solves at p=2 s=6.  The helpers, the JAX side and the
tolerances are ``test_torch_reduced_rungs.py``'s (its docstring states
them); this file is apart so that it runs on its own test worker.

The fused solves hold split3 to the JAX f32 run's itCG within 2 and the
bf16 state to the JAX package's own contract for it, the f32 run's count
within 6 (``tests/test_cg_fused.py``).  Twostage at p=5 and 6, and the
bf16 state at p=5, are marked ``slow``; the card compares every degree in
``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu import benchmark as jbench
from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.solvers import cg_fused as jcg
from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.solvers import cg_fused
from test_torch_reduced_rungs import (BF, CELL_APPLY, RUNGS, TOL, TOL_SCAL,
                                      _close_bf16, _inputs, _jax_reference,
                                      _port_op, _rel, assert_refuses_control,
                                      check_matvec_and_iteration)

# (factor, metric, cofactor, p) of B1/B2 in twostage, the metric rebuilt by
# either chain or streamed
TWOSTAGE = [("twostage", m, c, p) for p in (4, 5, 6)
            for m, c in (("onthefly", "jtj"), ("onthefly", "adjj"),
                         ("precomputed", "adjj"))]
CASES = [pytest.param(*cfg, rung, ca, marks=(
    [pytest.mark.slow] if cfg[3] > 4 else []))
    for cfg in TWOSTAGE for rung in RUNGS for ca in CELL_APPLY]


@pytest.mark.parametrize("factor,metric,cofactor,p,rung,cell_apply", CASES)
def test_twostage_matvec_and_iteration_match_jax(factor, metric, cofactor, p,
                                                 rung, cell_apply):
    """``check_matvec_and_iteration`` in twostage at p=4..6: p=4 is
    ``cell_mma.cuh``'s (rebuilt) and ``cell_mma_hd.cuh``'s (streamed)
    arithmetic, p=5 and 6 ``cell_mma_hd.cuh``'s."""
    check_matvec_and_iteration(factor, metric, cofactor, p, rung, cell_apply)


def _bf16_iteration(op, args, cell_apply, round_d):
    """B2's plain arithmetic with a bf16 state; ``round_d=False`` is the
    variant that feeds the unrounded f32 d' to the operator and the sums,
    against the TPU kernel's rounding point (``cg_fused_kernel.py:856``)."""
    if round_d:
        return fk._fused_iteration_plain(op, *args, cell_apply=cell_apply)
    x, g, d, h, scal, prec = args
    alpha, beta = scal[0], scal[1]
    g2 = g + alpha * h.float()
    d2 = beta * d.float() - prec * g2
    h2 = fk._matvec_plain(op, d2, cell_apply).to(BF)
    h2a, ph, pg = h2.float(), prec * h2.float(), prec * g2
    s = torch.stack([torch.sum(d2 * h2a), torch.sum(h2a * h2a),
                     torch.sum(g2 * h2a), torch.sum(g2 * g2),
                     torch.sum(g2 * ph), torch.sum(h2a * ph),
                     torch.sum(g2 * pg), torch.zeros(())])
    return None, g2, d2.to(BF), h2, fk.scalar_recurrence(s, alpha, beta,
                                                         scal[4])


@pytest.mark.parametrize("cell_apply", list(CELL_APPLY))
@pytest.mark.parametrize("p", [2, 4, pytest.param(5, marks=pytest.mark.slow)])
def test_bf16_state_iteration_matches_jax(p, cell_apply):
    """One B2 iteration with the bf16 state, in the auto path's
    configuration of each p (dense + the bf16 metric stream at p=2, dense +
    onthefly at p=4, twostage + onthefly + jtj at p=5), and B1 on a bf16 d,
    against JAX built ``dtype=bfloat16``: x' and g' (f32) within 1e-5, d'
    and h' (bf16) within the bf16 tolerance, the scalars within 1e-4
    relative.  The variant that keeps d' at f32 past its store (its
    rounding point, ``cg_fused_kernel.py:856``) gives the same h' — the
    bf16 rung rounds the operator's input anyway — but its sums, and so
    the scalars, miss the tolerance (by 6e-4 at p=4, 2e-2 at p=2, where
    the rounded sums stay within 5e-6): the rounding point is part of the
    result.  The bf16 tolerance refuses split2m's product set in B1's h and
    B2's h'."""
    config = benchmark.resolve_config(p, "fused", "pieces", "bf16", BF,
                                      metric_dtype=BF)
    op = _port_op(p, *config, "bf16", True, True)
    u, b1, args, b2, scal = _jax_reference(p, *config, "bf16", True, True)
    ca = CELL_APPLY[cell_apply]
    h = fk._matvec_plain(op, torch.as_tensor(u).to(BF), ca)
    assert h.dtype == BF and _close_bf16(h.float(), b1)
    inputs = _inputs(args, True)
    res = _bf16_iteration(op, inputs, ca, True)
    assert res[2].dtype == res[3].dtype == BF
    assert _rel(res[0], b2[0]) < TOL and _rel(res[1], b2[1]) < TOL
    assert _close_bf16(res[2].float(), b2[2])
    assert _close_bf16(res[3].float(), b2[3])
    np.testing.assert_allclose(res[4].numpy(), scal, rtol=TOL_SCAL)
    unrounded = _bf16_iteration(op, inputs, ca, False)
    assert not np.allclose(unrounded[4].numpy(), scal, rtol=TOL_SCAL)
    assert_refuses_control(op, [b1, b2[3]], lambda o: [
        fk._matvec_plain(o, torch.as_tensor(u).to(BF), ca).float(),
        _bf16_iteration(o, inputs, ca, True)[3].float()])


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("factor,p", [("dense", 2), ("twostage", 4)])
def test_matvec_bf16_metric_matches_jax(factor, p, rung):
    """B1 with the streamed metric stored in bf16 (plain and the kernels'
    arithmetic) against JAX ``piece_vmult`` built ``metric_dtype=bfloat16``,
    within 1e-5 (bf16: the bf16 tolerance, which refuses the control): the
    metric is rounded once on both sides and upcast at the load."""
    op = _port_op(p, factor, "precomputed", "adjj", rung, bf16_metric=True)
    assert op.gmetric.dtype == BF and op.metric_dtype == BF
    u, b1, *_ = _jax_reference(p, factor, "precomputed", "adjj", rung,
                               bf16_metric=True)
    for ca in CELL_APPLY.values():
        got = fk._matvec_plain(op, torch.as_tensor(u), ca)
        assert (_close_bf16(got, b1) if rung == "bf16"
                else _rel(got, b1) < TOL)
    if rung == "bf16":
        assert_refuses_control(op, [b1], lambda o: [
            fk._matvec_plain(o, torch.as_tensor(u))])


@functools.lru_cache(maxsize=None)
def _jax_solve(p, s, rung, bf16_state):
    eff = "bf16" if bf16_state else rung
    f = jbench.resolve_factor("auto", p, "pieces", precision=eff,
                              solver="fused", metric="auto")
    m = jbench.resolve_metric("auto", "fused", "pieces", f, p, precision=eff)
    jp = jbp4.build(s, p, dtype=jnp.bfloat16 if bf16_state else jnp.float32,
                    backend="pallas", precision=rung, windowing="pieces",
                    factor=f, metric=m,
                    metric_dtype=jnp.bfloat16 if bf16_state else None)
    lat = jp.layout.n_nodes_axis
    r = jcg.fused_merged_cg_solve(
        jp.op, lat, jnp.asarray(jp.b).reshape((3,) + lat),
        jnp.asarray(jp.inv_diag).reshape((1,) + lat))
    return int(r.n_iterations), bool(r.converged)


@pytest.mark.parametrize("rung,bf16_state", [("split3", False),
                                             ("bf16", True)])
def test_fused_solve_matches_jax(rung, bf16_state):
    """The slice whole on the CPU at p=2 s=6, through the port's
    resolvers: split3 (dense + onthefly) takes the JAX f32 run's itCG
    within 2 and converges; the bf16 state with the bf16 metric stream
    (dense + precomputed) converges within 6 of the JAX f32 split3 run's
    count, the JAX package's contract for it (``tests/test_cg_fused.py``),
    and within 2 of the JAX bf16 run."""
    p, s = 2, 6
    state = BF if bf16_state else torch.float32
    config = benchmark.resolve_config(p, "fused", "pieces", rung, state,
                                      metric_dtype=BF if bf16_state else None)
    pb = bp4.build(s, p, state, rung, windowing="pieces", device="cpu",
                   metric_dtype=BF if bf16_state else None,
                   **dict(zip(("factor", "metric", "cofactor"), config)))
    lat = pb.layout.n_nodes_axis
    res = cg_fused.fused_merged_cg_solve(pb.op, lat, pb.b.reshape((3,) + lat),
                                         pb.inv_diag.reshape((1,) + lat))
    n_jax, conv_jax = _jax_solve(p, s, rung, bf16_state)
    n_f32 = _jax_solve(p, s, "split3", False)[0]
    assert res.converged and conv_jax
    assert abs(res.n_iterations - n_jax) <= 2
    if bf16_state:
        assert abs(res.n_iterations - n_f32) <= 6
        assert pb.b.dtype == pb.inv_diag.dtype == BF
