"""PyTorch port: bf16 storage wherever the JAX package runs it — the bf16
state (d and h, the baseline's p and Ap) on every rung, solver and
windowing, and the bf16 metric under ``highest`` and ``split2m`` —
against the JAX package.

The JAX side is ``bp4.build(..., backend="pallas", dtype=jnp.bfloat16)``
and its solvers, its Pallas kernels in interpret mode on the CPU; the port
runs its plain versions (the kernels' rounding points: ``laplace_apply``'s
bf16 cell results and y/x sums, the f32 z sums of B5/B6, the stored d' and
h' of B2).  Inputs are made with numpy from a seed and handed to both, at
s <= 4 and p <= 2.

Tolerances:

* bf16 vectors: relative L2 5e-4 (the bf16 class of
  ``test_torch_reduced_rungs.py``); the applies read 0 here, bit for bit,
  B2's vectors up to 2e-4 (a t value summed in another order can round
  across a bf16 boundary).  Each case's control — the same arithmetic
  without the bf16 store, its f32 result — reads 1.0e-3 or more;
* f32 vectors beside a bf16 metric: 1e-5 of the largest value; the
  control, the operator with the f32 metric, misses by 2.6e-4 or more;
* B2's scalars 1e-4 relative;
* the solves: itCG within 2 of the JAX package's, the residual history
  within 5e-5 of res0 over the iterations both ran (read up to 3.5e-6;
  the same solve with an f32 state, the control, misses by 2.8e-4 or
  more), x within 2e-3 of its largest value (read up to 4.0e-4).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu import benchmark as jbench
from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.ops import cg_fused_kernel as jfk
from mf_data_locality_tpu.ops import laplace_pallas as jlp
from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.ops import laplace_cuda

BF = torch.bfloat16
S, P = 3, 2
TOL_L2, TOL_F32, TOL_SCAL = 5e-4, 1e-5, 1e-4
TOL_HIST, TOL_X = 5e-5, 2e-3
WINDOWINGS = ("reshape", "pieces", "zslab")
RUNGS = ("highest", "split2m", "split3", "bf16")
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]


def _l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@functools.lru_cache(maxsize=None)
def _jax_vmult(windowing, rung, state_bf16, metric_bf16):
    """A random u (bf16 values where the state is bf16) and JAX ``vmult``
    of it with the constrained identity, as float32 numpy."""
    jp = jbp4.build(S, P, dtype=jnp.bfloat16 if state_bf16 else jnp.float32,
                    backend="pallas", precision=rung, windowing=windowing,
                    metric_dtype=jnp.bfloat16 if metric_bf16 else None)
    lat = jp.layout.n_nodes_axis
    rng = np.random.default_rng(11)
    u = rng.standard_normal((3,) + lat) * np.asarray(
        jp.op.mask, np.float64).reshape((1,) + lat)
    u = jnp.asarray(u, jnp.bfloat16 if state_bf16 else jnp.float32)
    return _f32(u), _f32(jlp.vmult(jp.op, u, constrained_identity=True))


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("windowing", WINDOWINGS)
def test_vmult_bf16_state_matches_jax(windowing, rung):
    """``vmult`` on a bf16 u (B3 reshape, B5 pieces, B6 zslab) against the
    JAX ``vmult`` on the same u: a bf16 result within relative L2 5e-4
    (bit for bit here), and the control — the port's apply at f32, without
    the bf16 store — outside it."""
    u, ref = _jax_vmult(windowing, rung, True, False)
    op = bp4.build(S, P, BF, rung, windowing=windowing, device="cpu").op
    got = la.vmult(op, torch.as_tensor(u).to(BF))
    assert got.dtype == BF
    assert _l2(_np(got), ref) <= TOL_L2
    ctl = la.vmult(op, torch.as_tensor(u))
    assert ctl.dtype == torch.float32 and _l2(_np(ctl), ref) > TOL_L2


@pytest.mark.parametrize("rung", ("highest", "split2m"))
@pytest.mark.parametrize("windowing", WINDOWINGS)
def test_bf16_metric_matches_jax(windowing, rung):
    """The metric streamed in bf16 under ``highest`` and ``split2m`` (an
    f32 state): ``vmult`` within 1e-5 of the JAX one; the operator with
    the f32 metric, the control, misses."""
    u, ref = _jax_vmult(windowing, rung, False, True)
    ops = {mdt: bp4.build(S, P, torch.float32, rung, windowing=windowing,
                          device="cpu", metric_dtype=mdt).op
           for mdt in (BF, None)}
    assert ops[BF].metric_dtype == BF
    ut = torch.as_tensor(u)
    assert _rel(_np(la.vmult(ops[BF], ut)), ref) <= TOL_F32
    assert _rel(_np(la.vmult(ops[None], ut)), ref) > TOL_F32


def test_bf16_state_and_metric_match_jax():
    """Both in bf16, B3 under split2m: within the bf16 tolerance."""
    u, ref = _jax_vmult("reshape", "split2m", True, True)
    op = bp4.build(S, P, BF, "split2m", device="cpu", metric_dtype=BF).op
    assert _l2(_np(la.vmult(op, torch.as_tensor(u).to(BF))), ref) <= TOL_L2


SOLVES = ([("merged", w, "highest") for w in WINDOWINGS]
          + [("baseline", w, "highest") for w in WINDOWINGS]
          + [("merged", "reshape", r) for r in ("split2m", "split3", "bf16")])


@pytest.mark.parametrize("solver,windowing,rung", SOLVES)
def test_host_loop_bf16_solve_matches_jax(solver, windowing, rung):
    """The merged and baseline solvers with a bf16 state against the JAX
    package's (``bp4.solve_merged`` / ``solve_baseline``) at s=4, p=2:
    itCG within 2, the history within 5e-5 of res0 (the f32-state solve,
    the control, misses), x within 2e-3; d and h stay bf16, x f32."""
    s = 4
    jp = jbp4.build(s, P, dtype=jnp.bfloat16, backend="pallas",
                    precision=rung, windowing=windowing)
    jsolve = jbp4.solve_merged if solver == "merged" else jbp4.solve_baseline
    want = jsolve(jp)
    solve = bp4.solve_merged if solver == "merged" else bp4.solve_baseline
    got = solve(bp4.build(s, P, BF, rung, windowing=windowing,
                          device="cpu"))
    ctl = solve(bp4.build(s, P, torch.float32, rung, windowing=windowing,
                          device="cpu"))
    assert got.converged and bool(want.converged)
    assert abs(got.n_iterations - int(want.n_iterations)) <= 2
    assert got.x.dtype == torch.float32
    hist = np.asarray(want.res_history, np.float64)

    def hist_err(r):  # over the iterations both ran
        k = min(r.n_iterations, int(want.n_iterations)) + 1
        return np.abs(r.res_history.numpy()[:k] - hist[:k]).max() / hist[0]

    assert hist_err(got) <= TOL_HIST < hist_err(ctl)
    assert _rel(_np(got.x), _f32(want.x)) <= TOL_X


def test_run_one_bf16_matches_jax_cli_default():
    """``run_one(2, 4, solver="merged", dtype=bf16)`` at the JAX CLI's
    defaults (reshape, highest): the port resolves the same configuration
    and its solve takes the JAX ``run_one``'s iteration count within 2
    (the port's ``run_one`` times on a card, so here its build and
    solve)."""
    want = jbench.run_one(2, 4, solver="merged", dtype=jnp.bfloat16,
                          backend="pallas", solve_repeats=1,
                          matvec_repeats=1, matvec_inner=2)
    config = benchmark.resolve_config(2, "merged", "reshape", "highest", BF)
    assert config == ("dense", "precomputed", "adjj")
    pb = bp4.build(4, 2, BF, "highest", *config, device="cpu")
    assert pb.op.precision == "highest"  # the operator keeps its rung
    got = bp4.solve_merged(pb)
    assert want.converged and got.converged
    assert abs(got.n_iterations - want.n_iterations) <= 2


def _piece(u, p):
    return jfk.to_piece_state(jnp.asarray(u), p)[:, :, :p * p]


def _lattice(v, p, lat):
    ncx = (lat[2] - 1) // p
    return _f32(jfk.from_piece_state(jfk._expand_mm(v, p, ncx), p, lat))


@functools.lru_cache(maxsize=None)
def _jax_iteration(rung, metric, state_bf16, metric_bf16):
    """One JAX ``fused_cg_iteration`` (dense, pieces, p=2) on random inputs
    (d and h bf16 values for a bf16 state): the inputs and x', g', d', h'
    and the 8 scalars as float32 numpy."""
    store = jnp.bfloat16 if state_bf16 else jnp.float32
    jp = jbp4.build(S, P, dtype=store, backend="pallas", precision=rung,
                    windowing="pieces", factor="dense", metric=metric,
                    metric_dtype=jnp.bfloat16 if metric_bf16 else None)
    lat = jp.layout.n_nodes_axis
    mask = np.asarray(jp.op.mask, np.float32).reshape((1,) + lat)
    rng = np.random.default_rng(21)

    def vec(dtype=jnp.float32):
        return _f32(jnp.asarray(rng.standard_normal((3,) + lat) * mask,
                                dtype))

    x, g, d, h = vec(), vec(), vec(store), vec(store)
    prec = _f32(np.asarray(jp.inv_diag, np.float32).reshape((1,) + lat)
                * mask)
    xs, gs = _piece(x, P), _piece(g, P)
    ds, hs = (_piece(jnp.asarray(v, store), P) for v in (d, h))
    out = jfk.fused_cg_iteration(
        jp.op, lat, xs, gs, ds, hs, jfk.zplanes_init(gs, P),
        jfk.zplanes_init(ds, P), jfk.zplanes_init(hs, P),
        jnp.asarray(SCAL, jnp.float32), _piece(prec, P), compact=True)
    return ((x, g, d, h, prec), [_lattice(v, P, lat) for v in out[:4]],
            _f32(out[7]))


def _port_iteration(op, args, store):
    x, g, d, h, prec = (torch.as_tensor(v) for v in args)
    return fk._fused_iteration_plain(op, x, g, d.to(store), h.to(store),
                                     torch.tensor(SCAL), prec)


@pytest.mark.parametrize("metric", ("precomputed", "onthefly"))
@pytest.mark.parametrize("rung", ("highest", "split2m", "split3"))
def test_fused_iteration_bf16_state_matches_jax(rung, metric):
    """One B2 iteration with a bf16 state under a degraded rung (dense, the
    metric streamed or rebuilt, p=2) against the JAX kernel's: x', g',
    d', h' within relative L2 5e-4 (d' and h' bf16), the scalars within
    1e-4; the control, the iteration on the same values stored at f32
    (d' and h' unrounded), misses on h'."""
    args, want, scal = _jax_iteration(rung, metric, True, False)
    op = bp4.build(S, P, BF, rung, factor="dense", metric=metric,
                   windowing="pieces", device="cpu").op
    got = _port_iteration(op, args, BF)
    assert got[2].dtype == got[3].dtype == BF
    for a, b in zip(got[:4], want):
        assert _l2(_np(a), b) <= TOL_L2
    np.testing.assert_allclose(got[4].numpy(), scal, rtol=TOL_SCAL,
                               atol=1e-30)
    ctl = _port_iteration(op, args, torch.float32)
    assert _l2(_np(ctl[3]), want[3]) > TOL_L2


@pytest.mark.parametrize("rung", ("highest", "split2m"))
def test_fused_iteration_bf16_metric_matches_jax(rung):
    """B2 with the metric streamed in bf16 under highest and split2m (an
    f32 state): within 1e-5 of the JAX kernel's; with the f32 metric, the
    control, h' misses."""
    args, want, scal = _jax_iteration(rung, "precomputed", False, True)
    ops = {mdt: bp4.build(S, P, torch.float32, rung, factor="dense",
                          metric="precomputed", windowing="pieces",
                          device="cpu", metric_dtype=mdt).op
           for mdt in (BF, None)}
    got = _port_iteration(ops[BF], args, torch.float32)
    for a, b in zip(got[:4], want):
        assert _rel(_np(a), b) <= TOL_F32
    np.testing.assert_allclose(got[4].numpy(), scal, rtol=TOL_SCAL)
    ctl = _port_iteration(ops[None], args, torch.float32)
    assert _rel(_np(ctl[3]), want[3]) > TOL_F32


LABELS = ("item 6g", "item 6h")


@pytest.mark.parametrize("rung", RUNGS)
def test_bf16_storage_resolves_everywhere(rung):
    """Every bf16 state x solver x windowing x degree 1..11, and every bf16
    metric, under ``rung`` resolves as the JAX ``run_one`` does (the
    dispatch on the bf16 rung, ``eff_prec``; the operator keeps
    ``rung``) and passes ``check_config``; only a configuration left to
    a later ROADMAP item raises, naming it."""
    for p in range(1, 12):
        for solver, windowings in (("fused", ("pieces",)),
                                   ("merged", WINDOWINGS),
                                   ("baseline", WINDOWINGS)):
            for windowing in windowings:
                for dtype, mdt in ((BF, None), (BF, BF),
                                   (torch.float32, BF)):
                    try:
                        f, m, c = benchmark.resolve_config(
                            p, solver, windowing, rung, dtype,
                            metric_dtype=mdt)
                    except NotImplementedError as e:
                        assert any(k in str(e) for k in LABELS), str(e)
                        continue
                    eff = "bf16" if dtype == BF else rung
                    jf = jbench.resolve_factor("auto", p, windowing,
                                               precision=eff, solver=solver,
                                               metric="auto")
                    assert f == jf
                    laplace_cuda.check_config(rung, f, m, c, dtype,
                                              windowing, solver, p, mdt)


def test_storage_builds_keep_their_rung():
    """A bf16 state keeps the operator's tables f32 at the given rung (the
    JAX ``make_pallas_operator``'s ``vec_dtype``), with b and the
    preconditioner in bf16, on every windowing; the merged solver's
    vectors: d and h bf16, x and g f32."""
    for windowing in WINDOWINGS:
        pb = bp4.build(2, 2, BF, "split3", windowing=windowing, device="cpu")
        assert pb.op.dtype == torch.float32 and pb.op.precision == "split3"
        assert pb.b.dtype == pb.inv_diag.dtype == BF
        v = pb.a_apply(pb.b)
        assert v.dtype == BF and v.shape == pb.b.shape
    r = bp4.solve_merged(pb)
    assert r.x.dtype == torch.float32 and r.converged


def test_px_beside_storage_instantiations_is_refused():
    """B2 with P or x in bf16 beside a bf16 state under a rung other than
    bf16 (or a bf16 metric under highest or split2m) has no kernel: the
    card check raises before any launch; the bf16 rung's, which its own
    instantiations read, passes."""
    layout = DofLayout(BoxMesh.from_s(S), P)
    d = None
    for rung, ok in (("highest", False), ("split2m", False), ("bf16", True)):
        op = laplace_cuda.make_operator(layout, BF, rung, factor="dense",
                                        windowing="pieces", device="cpu")
        d = torch.zeros((3,) + op.n_nodes_axis, dtype=BF)
        prec = torch.zeros((1,) + op.n_nodes_axis, dtype=BF)
        if ok:
            fk._check_cuda(op, [], [d, d], prec)
        else:
            with pytest.raises(NotImplementedError, match="P/x"):
                fk._check_cuda(op, [], [d, d], prec)
        fk._check_cuda(op, [], [d, d])  # P at f32: the storage form
