"""PyTorch port: the tensor-core rungs' twostage pass at p=1..3 (B1, B2)
against the JAX package — the fused solver's ``--factor twostage`` under
split2m, split3 and bf16 at the degrees where the JAX resolvers pick the
dense factorization, with the metric streamed, rebuilt by adjj and rebuilt
by jtj.

The JAX side is ``bp4.build(..., backend="pallas", windowing="pieces",
factor="twostage")``, its Pallas kernels in interpret mode on the CPU,
compared at the lattice level through its own ``to_piece_state`` /
``from_piece_state``; the helpers and the tolerances are
``test_torch_reduced_rungs.py``'s (its docstring states them: split2m and
split3 1e-5 of the vectors' max, the scalars 1e-4 relative; bf16 relative
L2 5e-4 and max 1e-2, and the control, split2m's product set in place of
bf16's, refused).  The port runs its plain versions and the tensor-core
kernel's arithmetic (``_cell_apply_mma_emulated``: the packed bf16 tables,
(p+1)^2 = 4, 9, 16 columns and q^2 = 9, 16, 25 rows padded to 16, 16, 32,
the odd q-planes padded to pairs).  Inputs are made with numpy from a
seed.  Each JAX reference costs ~5 s, so the fast cases are seven (each
degree, rung and configuration at least once); the rest are marked
``slow``.  The card compares every
case in ``chip_smoke.py`` (section 10).  A file of its own so that it runs
on its own test worker.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.solvers import cg_fused as jcg
from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_cuda
from mf_data_locality_tpu_torch.solvers import cg_fused
from test_torch_reduced_rungs import (BF, CELL_APPLY, TOL_SCAL, _close_bf16,
                                      _inputs, _jax_reference, _port_op, _rel,
                                      check_matvec_and_iteration)

RUNGS = laplace_cuda.TENSOR_RUNGS
# (metric, cofactor) of the twostage configurations
CONFIGS = (("onthefly", "jtj"), ("onthefly", "adjj"), ("precomputed", "adjj"))
FAST = {("split2m", "onthefly", "jtj", 1), ("split2m", "onthefly", "jtj", 3),
        ("split2m", "onthefly", "adjj", 2),
        ("split2m", "precomputed", "adjj", 3),
        ("split3", "onthefly", "jtj", 1), ("split3", "precomputed", "adjj", 3),
        ("bf16", "onthefly", "jtj", 2)}
CASES = [pytest.param(m, c, p, rung, ca, marks=(
    [] if (rung, m, c, p) in FAST else [pytest.mark.slow]))
    for p in (1, 2, 3) for rung in RUNGS for m, c in CONFIGS
    for ca in CELL_APPLY]
# a fused solve's residual history against the JAX f32 run's, over the
# iterations both ran: max |diff| / res0
TOL_HIST = 1e-5


@pytest.mark.parametrize("metric,cofactor,p,rung,cell_apply", CASES)
def test_twostage_matvec_and_iteration_match_jax(metric, cofactor, p, rung,
                                                 cell_apply):
    """B1 against ``piece_vmult`` and B2 against ``fused_cg_iteration`` in
    twostage at p=1..3 (``check_matvec_and_iteration``): the configuration
    is one the port's fused solver runs, as the JAX package builds it."""
    assert ("twostage", metric) in laplace_cuda.fused_configs(rung, p)
    laplace_cuda.check_config(rung, "twostage", metric, cofactor,
                              torch.float32, "pieces", "fused", p)
    check_matvec_and_iteration("twostage", metric, cofactor, p, rung,
                               cell_apply)


@pytest.mark.parametrize("cell_apply", list(CELL_APPLY))
def test_bf16_state_iteration_matches_jax(cell_apply):
    """One B2 iteration with the bf16 state (d and h stored in bf16) in
    twostage + onthefly + jtj at p=2 under split2m, the storage
    instantiation's configuration (``csrc/cell_mma_sb.cu``): x' and g'
    (f32) within 1e-5, d' and h' (bf16) within the bf16 tolerance, the
    scalars within 1e-4 relative."""
    p, args = 2, ("twostage", "onthefly", "jtj", "split2m", True)
    op = _port_op(p, *args)
    assert op.precision == "split2m" and op.dtype == torch.float32
    _, _, inputs, b2, scal = _jax_reference(p, *args)
    res = fk._fused_iteration_plain(op, *_inputs(inputs, True),
                                    cell_apply=CELL_APPLY[cell_apply])
    assert res[2].dtype == res[3].dtype == BF
    assert _rel(res[0], b2[0]) < 1e-5 and _rel(res[1], b2[1]) < 1e-5
    assert _close_bf16(res[2].float(), b2[2])
    assert _close_bf16(res[3].float(), b2[3])
    np.testing.assert_allclose(res[4].numpy(), scal, rtol=TOL_SCAL)


def test_prec_bf16_iteration_matches_jax():
    """One B2 iteration with the preconditioner stored in bf16 (the fused
    solver's ``prec_dtype``) in twostage + onthefly + jtj at p=3 under
    split2m, the PX instantiation's configuration: the JAX kernel on the
    same bf16 P, within 1e-5 (the scalars 1e-4); with P unrounded, the
    control, d' misses it."""
    p = 3
    op = _port_op(p, "twostage", "onthefly", "jtj", "split2m")
    jp = jbp4.build(3, p, dtype=jnp.float32, backend="pallas",
                    precision="split2m", windowing="pieces",
                    factor="twostage", metric="onthefly", cofactor="jtj")
    from mf_data_locality_tpu.ops import cg_fused_kernel as jfk
    from test_torch_reduced_rungs import SCAL, _from_compact, _to_compact

    lat = jp.layout.n_nodes_axis
    mask = np.asarray(jp.op.mask, np.float32).reshape((1,) + lat)
    rng = np.random.default_rng(77)
    x, g, d, h = ((rng.standard_normal((3,) + lat) * mask).astype(np.float32)
                  for _ in range(4))
    prec = (np.asarray(jp.inv_diag).reshape((1,) + lat) * mask).astype(
        np.float32)
    pb = np.asarray(jnp.asarray(prec, jnp.bfloat16).astype(jnp.float32))
    comp = [_to_compact(v, p) for v in (x, g, d, h)]
    out = jfk.fused_cg_iteration(
        jp.op, lat, *comp, jfk.zplanes_init(comp[1], p),
        jfk.zplanes_init(comp[2], p), jfk.zplanes_init(comp[3], p),
        jnp.asarray(SCAL, jnp.float32),
        _to_compact(jnp.asarray(prec, jnp.bfloat16), p), compact=True)
    want = [np.asarray(_from_compact(v, p, lat), np.float32)
            for v in out[:4]]
    args = [torch.as_tensor(v) for v in (x, g, d, h)]
    scal = torch.tensor(SCAL)
    res = fk._fused_iteration_plain(op, *args, scal,
                                    torch.as_tensor(prec).to(BF),
                                    cell_apply=fk._cell_apply_mma_emulated)
    for got, w in zip(res[:4], want):
        assert _rel(got, w) < 1e-5
    np.testing.assert_allclose(res[4].numpy(), np.asarray(out[7]),
                               rtol=TOL_SCAL)
    ctl = fk._fused_iteration_plain(op, *args, scal, torch.as_tensor(prec))
    assert not np.array_equal(pb, prec)
    assert _rel(ctl[2], want[2]) > 1e-5


def test_fused_solve_matches_jax():
    """The slice whole on the CPU: the fused solve with ``--factor
    twostage`` under split2m at p=2 s=5, through the port's resolvers
    (twostage + onthefly, as the JAX resolvers give for an explicit
    factor), against the JAX f32 interpret run: the same itCG, converged,
    and the residual history within 1e-5 res0."""
    p, s = 2, 5
    config = benchmark.resolve_config(p, "fused", "pieces", "split2m",
                                      torch.float32, factor="twostage")
    assert config[0] == "twostage"
    jp = jbp4.build(s, p, dtype=jnp.float32, backend="pallas",
                    precision="split2m", windowing="pieces",
                    **dict(zip(("factor", "metric", "cofactor"), config)))
    lat = jp.layout.n_nodes_axis
    ref = jcg.fused_merged_cg_solve(
        jp.op, lat, jnp.asarray(jp.b).reshape((3,) + lat),
        jnp.asarray(jp.inv_diag).reshape((1,) + lat))
    pb = bp4.build(s, p, torch.float32, "split2m", windowing="pieces",
                   device="cpu", **dict(zip(("factor", "metric", "cofactor"),
                                            config)))
    res = cg_fused.fused_merged_cg_solve(
        pb.op, lat, pb.b.reshape((3,) + lat),
        pb.inv_diag.reshape((1,) + lat))
    n = int(ref.n_iterations)
    assert bool(ref.converged) and res.converged and res.n_iterations == n
    hr = np.asarray(ref.res_history, np.float64)[:n + 1]
    hp = res.res_history.numpy().astype(np.float64)[:n + 1]
    assert np.abs(hp - hr).max() / hr[0] <= TOL_HIST


@pytest.mark.parametrize("rung", RUNGS)
def test_check_config_accepts_what_jax_builds(rung):
    """Acceptance parity at p=1..5: every (windowing, factor, metric,
    cofactor) that the JAX ``bp4.build`` builds at s=2 under ``rung`` (f32;
    the port's windowings — conv and matmul are ROADMAP queue A item 10),
    with each solver that runs on it in the JAX package (the fused solver on
    ``pieces``; merged and baseline where its apply takes the operator,
    not ``pieces`` with the metric rebuilt, which
    ``laplace_pallas.apply_lattice_pieces`` refuses), passes the port's
    ``check_config``, or raises naming only ROADMAP items 6g or 6h; what
    the JAX package refuses the port refuses too."""
    from mf_data_locality_tpu.ops import laplace_pallas as jlp

    for p in range(1, 6):
        for windowing, factor, metric, cofactor in itertools.product(
                laplace_cuda.WINDOWINGS, ("dense", "twostage"),
                ("precomputed", "onthefly"), laplace_cuda.COFACTORS):
            config = (rung, factor, metric, cofactor, torch.float32,
                      windowing)
            try:
                jop = jbp4.build(2, p, dtype=jnp.float32, backend="pallas",
                                 precision=rung, windowing=windowing,
                                 factor=factor, metric=metric,
                                 cofactor=cofactor).op
            except ValueError:
                with pytest.raises((ValueError, NotImplementedError)):
                    laplace_cuda.check_config(*config, degree=p)
                continue
            for solver in ("fused", "merged", "baseline"):
                if solver == "fused":
                    runs = windowing == "pieces"
                else:
                    runs = not (windowing == "pieces" and jop.gmetric is None)
                    if not runs:
                        with pytest.raises(ValueError):
                            jlp.apply_lattice_pieces(jop, None)
                if not runs:
                    with pytest.raises((ValueError, NotImplementedError)):
                        laplace_cuda.check_config(*config, solver, p)
                    continue
                try:
                    laplace_cuda.check_config(*config, solver, p)
                except NotImplementedError as e:
                    assert "item 6g" in str(e) or "item 6h" in str(e), (
                        p, config, solver, str(e))
