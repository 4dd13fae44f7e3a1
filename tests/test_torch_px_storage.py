"""PyTorch port: B2 with the preconditioner P or the solution x stored in
bf16 (the fused solver's ``prec_dtype``, ``x_dtype``) beside a bf16 state
or a bf16 metric — the JAX CLI's ``--solver fused --dtype bf16
--prec-dtype bf16``, ``--x-dtype bf16`` and ``--metric-dtype bf16
--prec-dtype bf16`` — against the JAX package.

The JAX side is ``bp4.build(..., backend="pallas")``, its
``fused_cg_iteration`` and fused solver, its Pallas kernels in interpret
mode on the CPU; the port runs its plain iteration
(``cg_fused_kernel._fused_iteration_plain``: P and x upcast where they are
read, x' rounded where it is stored, d' and h' rounded where they are
stored).  Inputs are made with numpy from a seed and handed to both, at
s = 3 and p = 2 (dense, the metric streamed).

Tolerances (those of ``test_torch_bf16_state.py``):

* bf16 vectors (x' with x in bf16; d' and h' of a bf16 state): relative
  L2 5e-4 (read 0 here, bit for bit);
* f32 vectors: 1e-5 of the largest value (read <= 8.2e-7);
* B2's scalars 1e-4 relative (read <= 2.5e-6);
* each case's control — the same iteration with P, or x, unrounded —
  misses: d' with P (>= 1.5e-3), x' with x (>= 2.5e-3);
* the solves: itCG within 2 of the JAX ``run_one``'s (its timing chains
  stubbed: a CPU run's times are read nowhere; its one solve's history
  and x read back), the residual history within 5e-5 of res0 over the
  iterations both ran (read <= 4.9e-7); its control, the solve with P
  unrounded, misses (>= 1.9e-4); x feeds no recurrence, so with x in bf16
  the history is bitwise the f32-x solve's, and x is held instead:
  relative L2 5e-4 against the JAX solve's (read 6.1e-8), the f32-x
  solve, its control, outside (2.4e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu import benchmark as jbench
from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.ops import cg_fused_kernel as jfk
from mf_data_locality_tpu.solvers import cg_fused as jcg_fused
from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.solvers import cg_fused

BF = torch.bfloat16
JDT = {None: None, BF: jnp.bfloat16, torch.float32: jnp.float32}
S, P = 3, 2
TOL_L2, TOL_F32, TOL_SCAL, TOL_HIST = 5e-4, 1e-5, 1e-4, 5e-5
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
# (rung, what is bf16 beside P or x): the bf16 state on every rung whose
# own instantiations do not read it, the bf16 metric where it has its own
CONFIGS = ([(r, "state") for r in ("highest", "split2m", "split3")]
           + [(r, "metric") for r in ("highest", "split2m")])
# what is stored in bf16: (P, x)
STORAGE = {"P": (True, False), "x": (False, True), "both": (True, True)}


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


def _piece(u, p):
    return jfk.to_piece_state(jnp.asarray(u), p)[:, :, :p * p]


def _lattice(v, p, lat):
    ncx = (lat[2] - 1) // p
    return _f32(jfk.from_piece_state(jfk._expand_mm(v, p, ncx), p, lat))


def _inputs(lat, mask):
    """x, g, d, h (C, lattice) and a P (1, lattice) that bf16 rounds: a
    random positive diagonal, not the build's (a bf16 build's is rounded
    already), as float32 numpy, zero on the boundary."""
    rng = np.random.default_rng(23)
    x, g, d, h = (_f32(rng.standard_normal((3,) + lat) * mask)
                  for _ in range(4))
    prec = _f32(rng.uniform(0.5, 1.5, (1,) + lat) * mask)
    return x, g, d, h, prec


@functools.lru_cache(maxsize=None)
def _jax_iteration(rung, kind, prec_bf16, x_bf16):
    """One JAX ``fused_cg_iteration`` with a bf16 state or metric (``kind``)
    and P, x stored at bf16 where asked: the unrounded inputs and x', g',
    d', h' and the 8 scalars as float32 numpy."""
    store = jnp.bfloat16 if kind == "state" else jnp.float32
    jp = jbp4.build(S, P, dtype=store, backend="pallas", precision=rung,
                    windowing="pieces", factor="dense", metric="precomputed",
                    metric_dtype=jnp.bfloat16 if kind == "metric" else None)
    lat = jp.layout.n_nodes_axis
    mask = np.asarray(jp.op.mask, np.float32).reshape((1,) + lat)
    args = _inputs(lat, mask)
    x, g, d, h, prec = args
    xs = _piece(jnp.asarray(x, jnp.bfloat16 if x_bf16 else jnp.float32), P)
    ps = _piece(jnp.asarray(prec, jnp.bfloat16 if prec_bf16
                            else jnp.float32), P)
    gs = _piece(g, P)
    ds, hs = (_piece(jnp.asarray(v, store), P) for v in (d, h))
    iteration = jax.jit(functools.partial(jfk.fused_cg_iteration, jp.op,
                                          lat, compact=True))
    out = iteration(xs, gs, ds, hs, jfk.zplanes_init(gs, P),
                    jfk.zplanes_init(ds, P), jfk.zplanes_init(hs, P),
                    jnp.asarray(SCAL, jnp.float32), ps)
    assert (out[0].dtype == jnp.bfloat16) == x_bf16
    return args, [_lattice(v, P, lat) for v in out[:4]], _f32(out[7])


def _port_iteration(op, args, store, prec_bf16, x_bf16):
    x, g, d, h, prec = (torch.as_tensor(v) for v in args)
    return fk._fused_iteration_plain(
        op, x.to(BF) if x_bf16 else x, g, d.to(store), h.to(store),
        torch.tensor(SCAL), prec.to(BF) if prec_bf16 else prec)


@pytest.mark.parametrize("storage", STORAGE)
@pytest.mark.parametrize("rung,kind", CONFIGS)
def test_fused_iteration_px_beside_storage_matches_jax(rung, kind, storage):
    """One B2 iteration with P, x or both in bf16 beside a bf16 state
    (highest, split2m, split3) or a bf16 metric (highest, split2m) against
    the JAX kernel's on the same inputs: each vector within its class's
    tolerance, the scalars within 1e-4; the controls, P or x unrounded,
    miss (d' with P, x' with x)."""
    prec_bf16, x_bf16 = STORAGE[storage]
    args, want, scal = _jax_iteration(rung, kind, prec_bf16, x_bf16)
    store = BF if kind == "state" else torch.float32
    op = bp4.build(S, P, store, rung, factor="dense", metric="precomputed",
                   windowing="pieces", device="cpu",
                   metric_dtype=BF if kind == "metric" else None).op
    got = _port_iteration(op, args, store, prec_bf16, x_bf16)
    assert got[0].dtype == (BF if x_bf16 else torch.float32)
    assert got[2].dtype == got[3].dtype == store

    def err(t, ref):  # the vector's class: bf16 L2, f32 max relative
        return (_l2 if t.dtype == BF else _rel)(_np(t), ref)

    def tol(t):
        return TOL_L2 if t.dtype == BF else TOL_F32

    for a, b in zip(got[:4], want):
        assert err(a, b) <= tol(a)
    np.testing.assert_allclose(got[4].numpy(), scal, rtol=TOL_SCAL,
                               atol=1e-30)
    if prec_bf16:
        ctl = _port_iteration(op, args, store, False, x_bf16)
        assert err(ctl[2], want[2]) > tol(ctl[2])
    if x_bf16:
        ctl = _port_iteration(op, args, store, prec_bf16, False)
        assert _l2(_np(ctl[0]), want[0]) > TOL_L2


# the JAX CLI's rows: (rung, dtype, metric dtype, prec_dtype, x_dtype)
SOLVES = (("highest", BF, None, BF, None),
          ("split2m", BF, None, BF, None),
          ("highest", BF, None, None, BF),
          ("highest", torch.float32, BF, BF, None),
          ("split2m", torch.float32, BF, BF, None))


@pytest.mark.parametrize("rung,dtype,mdt,pdt,xdt", SOLVES)
def test_fused_solve_px_beside_storage_matches_jax_run_one(monkeypatch, rung,
                                                           dtype, mdt, pdt,
                                                           xdt):
    """``fused_merged_cg_solve(prec_dtype=, x_dtype=)`` (through
    ``benchmark.solver_call``, as ``run_one`` calls it) on the
    configuration ``resolve_config`` gives, against ``jbench.run_one(...,
    backend="pallas", solver="fused")`` with the same flags: itCG within
    2; the history within 5e-5 of res0 of the JAX solve's, and with P in
    bf16 the solve with P unrounded outside it; with x in bf16 the
    history bitwise the f32-x solve's and x within relative L2 5e-4 of
    the JAX solve's, the f32-x solve outside it.  The JAX ``run_one``'s
    timing chains are stubbed (a CPU run's times are read nowhere): its
    one solve gives the count, and its history and x are read back from
    inside it."""
    monkeypatch.setattr(jbench.timing, "time_pair_fetch",
                        lambda *a, **k: (1.0, 2.0))
    monkeypatch.setattr(jbench.timing, "time_scan_fetch",
                        lambda *a, **k: 1.0)
    seen = []
    solve = jcg_fused.fused_merged_cg_solve

    def read_back(*args, **kw):  # run_one's solve, traced under its jit
        res = solve(*args, **kw)
        jax.debug.callback(lambda *v: seen.append(v), res.res_history,
                           res.x, res.n_iterations)
        return res

    monkeypatch.setattr(jcg_fused, "fused_merged_cg_solve", read_back)
    f, m, c = benchmark.resolve_config(P, "fused", "pieces", rung, dtype,
                                       metric_dtype=mdt)
    jp = jbp4.build(S, P, dtype=JDT[dtype], backend="pallas",
                    precision=rung, windowing="pieces", factor=f, metric=m,
                    cofactor=c, metric_dtype=JDT[mdt])
    jr = jbench.run_one(P, S, solver="fused", dtype=JDT[dtype],
                        backend="pallas", precision=rung, windowing="pieces",
                        metric_dtype=JDT[mdt], prec_dtype=JDT[pdt],
                        x_dtype=JDT[xdt], solve_repeats=1, matvec_repeats=1,
                        matvec_inner=1, problem=jp)
    jax.effects_barrier()
    (hist, want_x, n), = seen
    assert jr.converged and jr.n_iterations == int(n)
    n = int(n)

    tp = bp4.build(S, P, dtype, rung, factor=f, metric=m, cofactor=c,
                   windowing="pieces", device="cpu", metric_dtype=mdt)
    got = benchmark.solver_call(tp, "fused", pdt, xdt)()
    assert got.converged and abs(got.n_iterations - jr.n_iterations) <= 2
    assert got.x.dtype == torch.float32
    hist = np.asarray(hist, np.float64)

    def hist_err(r):  # over the iterations both ran
        k = min(r.n_iterations, n) + 1
        return np.abs(r.res_history.numpy()[:k] - hist[:k]).max() / hist[0]

    assert hist_err(got) <= TOL_HIST
    if pdt is not None:
        # P unrounded: the f32 build's diagonal (a bf16 build rounds its
        # own, as the JAX one does), stored at f32
        diag = bp4.build(S, P, torch.float32, rung, factor=f, metric=m,
                         cofactor=c, windowing="pieces", device="cpu",
                         metric_dtype=mdt).inv_diag
        lt = tp.lattice_shape
        ctl = cg_fused.fused_merged_cg_solve(
            tp.op, lt[1:], tp.b.reshape(lt), diag.reshape((1,) + lt[1:]))
        assert hist_err(ctl) > TOL_HIST
    else:
        ctl = benchmark.solver_call(tp, "fused")()
        k = got.n_iterations + 1
        assert ctl.n_iterations == got.n_iterations
        assert torch.equal(got.res_history[:k], ctl.res_history[:k])
        xw = np.asarray(want_x, np.float64).reshape(-1)
        assert _l2(_np(got.x).reshape(-1), xw) <= TOL_L2
        assert _l2(_np(ctl.x).reshape(-1), xw) > TOL_L2


def test_cli_dispatches_bf16_state_and_prec_to_the_fused_solver(
        monkeypatch):
    """``--solver fused --windowing pieces --dtype bf16 --prec-dtype bf16``
    reaches ``run_one`` with the bf16 state and P, and ``run_one``'s solve
    (``solver_call``) runs the fused iteration on them: on the CPU its
    plain version, each iteration with d, h and P in bf16.  The real
    ``run_one`` then stops at the device check, past every refusal."""
    seen = {}

    def fake(degree, s, **kw):
        seen.update(kw, degree=degree, s=s)
        return benchmark.RunResult(degree, degree + 2, 8, 375, 1e-4, 1e9,
                                   10, 1e-4, True)

    argv = ["2", "3", "--solver", "fused", "--windowing", "pieces",
            "--dtype", "bf16", "--prec-dtype", "bf16"]
    monkeypatch.setattr(benchmark, "run_one", fake)
    benchmark.main(argv)
    assert (seen["solver"], seen["dtype"], seen["prec_dtype"],
            seen["x_dtype"]) == ("fused", BF, BF, None)
    config = benchmark.resolve_config(2, "fused", "pieces",
                                      seen["precision"], BF)
    problem = bp4.build(3, 2, BF, seen["precision"], *config,
                        windowing="pieces", device="cpu")
    calls = []
    real = fk.fused_cg_iteration

    def iteration(op, x, g, d, h, scal, prec, **kw):
        calls.append((d.dtype, h.dtype, prec.dtype, x.dtype))
        return real(op, x, g, d, h, scal, prec, **kw)

    monkeypatch.setattr(fk, "fused_cg_iteration", iteration)
    res = benchmark.solver_call(problem, "fused", seen["prec_dtype"],
                                seen["x_dtype"])()
    assert res.converged and len(calls) == res.n_iterations > 0
    assert set(calls) == {(BF, BF, BF, torch.float32)}
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark.main(argv + ["--device", "cpu"])
