"""PyTorch port: the fused solver's configurations at p=1..4 — the dense
factorization with the metric streamed or rebuilt, as the JAX auto-dispatch
gives them — against the JAX package, and the port's ``bench_torch.py``.

The JAX side is ``bp4.build(..., backend="pallas", windowing="pieces",
factor="dense", metric=...)``, its Pallas kernels in interpret mode on the
CPU: f64 for ``highest``, f32 for ``split2m``.  The port runs its plain
PyTorch versions and the emulations of its kernels' arithmetic (tensors on
the CPU).  Inputs are made with numpy from a seed and handed to both.
Tolerances: f64 ``highest`` 1e-12 of the vectors' max; f32 ``split2m``
1e-5 (scalars 1e-4 relative: sums of ~1e3-1e4 terms in another order),
the f32 class — the JAX f32 Jacobian is split3 bf16 products, the port's
exact f32.
"""

import functools
import itertools
import json
import subprocess
import sys
from pathlib import Path

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
from mf_data_locality_tpu_torch.ops import laplace_cuda
from mf_data_locality_tpu_torch.solvers import cg_fused

REPO = Path(__file__).resolve().parent.parent
S = 4  # 16 cells (2 x 2 x 4)
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
# rung -> (numpy dtype, torch dtype, vector tol, scalar tol)
RUNGS = {"highest": (np.float64, torch.float64, 1e-12, 1e-12),
         "split2m": (np.float32, torch.float32, 1e-5, 1e-4)}
CASES = list(itertools.product((1, 2, 3, 4), ("precomputed", "onthefly"),
                               RUNGS))
# the kernels' arithmetic on the CPU: the sum-factorized pass (highest) and
# the dense tensor-core pass (split2m)
EMULATION = {"highest": fk._cell_apply_sumfac_emulated,
             "split2m": fk._cell_apply_mma_emulated}


def _to_compact(u, p):
    return jfk.to_piece_state(jnp.asarray(u), p)[:, :, :p * p]


def _from_compact(v, p, lat):
    ncx = (lat[2] - 1) // p
    return np.asarray(jfk.from_piece_state(jfk._expand_mm(v, p, ncx), p, lat))


@functools.lru_cache(maxsize=None)
def _jax_problem(s, p, metric, rung):
    dtype = jnp.dtype(RUNGS[rung][0])
    return jbp4.build(s, p, dtype=dtype, backend="pallas", precision=rung,
                      windowing="pieces", factor="dense", metric=metric)


def _port_problem(s, p, metric, rung):
    return bp4.build(s, p, dtype=RUNGS[rung][1], precision=rung,
                     device="cpu", factor="dense", metric=metric,
                     windowing="pieces")


@functools.lru_cache(maxsize=None)
def _jax_matvec(p, metric, rung):
    """A random boundary-zero lattice vector and JAX ``piece_vmult`` of it."""
    jp = _jax_problem(S, p, metric, rung)
    lat = jp.layout.n_nodes_axis
    mask = np.asarray(jp.op.mask).reshape((1,) + lat)
    rng = np.random.default_rng(100 + p)
    u = (rng.standard_normal((3,) + lat) * mask).astype(RUNGS[rung][0])
    dpc = _to_compact(u, p)
    h, _ = jfk.piece_vmult(jp.op, lat, dpc, jfk.zplanes_init(dpc, p),
                           compact=True)
    return u, _from_compact(h, p, lat)


@functools.lru_cache(maxsize=None)
def _jax_iteration(p, metric, rung):
    """A random boundary-zero state and one JAX fused iteration from it:
    (inputs, the four vectors out, the 8 scalars out)."""
    jp = _jax_problem(S, p, metric, rung)
    dtype = RUNGS[rung][0]
    lat = jp.layout.n_nodes_axis
    mask = np.asarray(jp.op.mask).reshape((1,) + lat)
    rng = np.random.default_rng(200 + p)
    x, g, d, h = ((rng.standard_normal((3,) + lat) * mask).astype(dtype)
                  for _ in range(4))
    prec = (np.asarray(jp.inv_diag).reshape((1,) + lat) * mask).astype(dtype)
    scal = np.array(SCAL, dtype)
    xs, gs, ds, hs = (_to_compact(v, p) for v in (x, g, d, h))
    out = jfk.fused_cg_iteration(
        jp.op, lat, xs, gs, ds, hs, jfk.zplanes_init(gs, p),
        jfk.zplanes_init(ds, p), jfk.zplanes_init(hs, p), jnp.asarray(scal),
        _to_compact(prec, p), compact=True)
    ref = [_from_compact(v, p, lat) for v in out[:4]]
    return (x, g, d, h, scal, prec), ref, np.asarray(out[7])


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("p,metric,rung", CASES)
def test_matvec_plain_matches_piece_vmult(p, metric, rung):
    """B1's plain version (``_cell_apply``'s dense form) against JAX
    ``piece_vmult`` built dense, either metric source."""
    u, ref = _jax_matvec(p, metric, rung)
    op = _port_problem(S, p, metric, rung).op
    assert op.factor == "dense" and op.metric == metric
    got = fk.matvec(op, torch.as_tensor(u))
    assert _rel(got, ref) < RUNGS[rung][2]


@pytest.mark.parametrize("p,metric,rung", CASES)
def test_matvec_emulation_matches_piece_vmult(p, metric, rung):
    """B1's kernel arithmetic — under ``highest`` the sum-factorized pass
    (the dense operator summed in another order), under ``split2m`` the
    dense tensor-core pass (padded bf16 fragment tables, K-stacked hi/lo
    products, f32 accumulation) — with the streamed or rebuilt metric."""
    u, ref = _jax_matvec(p, metric, rung)
    op = _port_problem(S, p, metric, rung).op
    got = fk._matvec_plain(op, torch.as_tensor(u), EMULATION[rung])
    assert _rel(got, ref) < RUNGS[rung][2]


@pytest.mark.parametrize("p,metric,rung", CASES)
def test_fused_iteration_plain_matches_jax(p, metric, rung):
    """B2's plain version against JAX ``fused_cg_iteration`` built dense:
    the four vectors and the 8 scalars."""
    args, ref, ref_scal = _jax_iteration(p, metric, rung)
    op = _port_problem(S, p, metric, rung).op
    res = fk.fused_cg_iteration(op, *(torch.as_tensor(v) for v in args))
    for got, want in zip(res[:4], ref):
        assert _rel(got, want) < RUNGS[rung][2]
    np.testing.assert_allclose(res[4].numpy(), ref_scal, rtol=RUNGS[rung][3])


@pytest.mark.parametrize("p,metric,rung", CASES)
def test_fused_iteration_emulation_matches_jax(p, metric, rung):
    """B2's kernel arithmetic: update4b, the emulated cell pass, the sums
    and the recurrence (``_fused_iteration_plain(..., cell_apply=...)``)."""
    args, ref, ref_scal = _jax_iteration(p, metric, rung)
    op = _port_problem(S, p, metric, rung).op
    res = fk._fused_iteration_plain(op, *(torch.as_tensor(v) for v in args),
                                    cell_apply=EMULATION[rung])
    for got, want in zip(res[:4], ref):
        assert _rel(got, want) < RUNGS[rung][2]
    np.testing.assert_allclose(res[4].numpy(), ref_scal, rtol=RUNGS[rung][3])


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_dense_and_twostage_are_one_operator(p):
    """Under ``highest`` (f64) the dense and twostage plain cell passes, and
    the streamed and rebuilt metrics, give one operator within 1e-12:
    why one sum-factorized pass serves every ``highest`` configuration."""
    u = None
    outs = []
    for factor, metric in laplace_cuda.fused_configs("highest", p):
        op = bp4.build(3, p, torch.float64, "highest", device="cpu",
                       factor=factor, metric=metric, windowing="pieces").op
        if u is None:
            rng = np.random.default_rng(p)
            u = torch.as_tensor(rng.standard_normal(
                (3,) + op.n_nodes_axis)) * op.mask
        outs.append(fk.matvec(op, u))
    assert len(outs) == 4
    for o in outs[1:]:
        assert ((o - outs[0]).abs().max() / outs[0].abs().max()).item() < 1e-12


@pytest.mark.parametrize("s,p", [(5, 1), (6, 2), (6, 3), (6, 4)])
def test_solve_f64_matches_jax(s, p):
    """Whole fused f64 solves in the JAX fused tests' configuration (dense +
    precomputed, ``tests/test_cg_fused.py:19-21,39-56``): the same itCG,
    histories within 1e-6 relative, the solution within 1e-10."""
    jp = jbp4.build(s, p, dtype=jnp.float64, backend="pallas",
                    precision="highest", windowing="pieces")
    lat = jp.layout.n_nodes_axis
    ref = jcg_fused.fused_merged_cg_solve(
        jp.op, lat, jp.b.reshape((3,) + lat), jp.inv_diag.reshape((1,) + lat))
    tp = _port_problem(s, p, "precomputed", "highest")
    res = cg_fused.fused_merged_cg_solve(
        tp.op, lat, tp.b.reshape((3,) + lat),
        tp.inv_diag.reshape((1,) + lat))
    n = int(ref.n_iterations)
    assert res.n_iterations == n and res.converged == bool(ref.converged)
    hr = np.asarray(ref.res_history)[:n + 1]
    np.testing.assert_allclose(res.res_history.numpy()[:n + 1], hr,
                               rtol=1e-6, atol=1e-8 * hr[0])
    xr = np.asarray(ref.x)
    np.testing.assert_allclose(res.x.numpy(), xr,
                               atol=1e-10 * max(1.0, np.abs(xr).max()))


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_fused_dispatch_resolves_to_ported_configurations(p):
    """The fused solver's auto-dispatch (the JAX resolvers, verbatim) at
    p=1..4 on the port's rungs gives a configuration the port runs, the
    same as the JAX resolvers give; jtj runs under highest, and under
    split2m in twostage (p=4); a bf16 state under split3 resolves as the
    bf16 rung's (6d); split2m twostage at p=1..3 and jtj in split2m's
    dense pass (6f, 6c) resolve as the JAX resolvers give them, and what
    stays unported (split2m at f64, 6h) raises; the split2m auto path at
    p+4 >= 5 resolves to twostage + onthefly + jtj, and split2m dense
    there to the JAX resolvers' metric."""
    want = {"highest": ("dense", "precomputed"),
            "split2m": {1: ("dense", "precomputed"),
                        2: ("dense", "onthefly"),
                        3: ("dense", "precomputed"),
                        4: ("twostage", "onthefly")}[p]}
    for dtype, precision in ((torch.float32, "highest"),
                             (torch.float64, "highest"),
                             (torch.float32, "split2m")):
        f, m, c = benchmark.resolve_config(p, "fused", "pieces", precision,
                                           dtype)
        jf = jbench.resolve_factor("auto", p, "pieces", precision=precision,
                                   solver="fused", metric="auto")
        jm = jbench.resolve_metric("auto", "fused", "pieces", jf, p,
                                   precision=precision)
        assert (f, m, c) == (jf, jm, jbench.resolve_cofactor(
            "auto", p, jf, jm, precision=precision)) == want[precision] + (
            "adjj",)
        for factor, metric in (("dense", "precomputed"),
                               ("dense", "onthefly")):
            benchmark.resolve_config(p, "fused", "pieces", precision, dtype,
                                     factor, metric)
    refused = [dict(precision="split2m", dtype=torch.float64)]
    # ported since (ROADMAP 6c: jtj in split2m's dense pass; 6f: split2m
    # twostage at p=1..3): they resolve as the JAX resolvers give them
    ported = [dict(factor="dense", metric="onthefly", cofactor="jtj")]
    # a bf16 state under a degraded rung runs since 6d: the dispatch on the
    # bf16 rung (eff_prec), the operator at its own
    assert benchmark.resolve_config(p, "fused", "pieces", "split3",
                                    torch.bfloat16) == \
        benchmark.resolve_config(p, "fused", "pieces", "bf16",
                                 torch.bfloat16)
    if p != 4:
        ported += [dict(factor="twostage", metric="onthefly"),
                   dict(factor="twostage", metric="precomputed"),
                   dict(metric="onthefly", cofactor="jtj")]
    else:
        for kw in (dict(factor="twostage", metric="precomputed"),
                   dict(metric="onthefly", cofactor="jtj")):
            benchmark.resolve_config(p, "fused", "pieces", "split2m",
                                     torch.float32, **kw)
    for kw in ported:
        jf = jbench.resolve_factor(kw.get("factor", "auto"), p, "pieces",
                                   precision="split2m", solver="fused",
                                   metric=kw["metric"])
        jm = jbench.resolve_metric(kw["metric"], "fused", "pieces", jf, p,
                                   precision="split2m")
        assert benchmark.resolve_config(
            p, "fused", "pieces", "split2m", torch.float32, **kw) == (
            jf, jm, jbench.resolve_cofactor(kw.get("cofactor", "auto"), p,
                                            jf, jm, precision="split2m"))
    for kw in refused:
        args = dict(precision="highest", dtype=torch.float32) | kw
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            benchmark.resolve_config(p, "fused", "pieces", **args)
    benchmark.resolve_config(p, "fused", "pieces", "highest", torch.float32,
                             "twostage", "onthefly", "jtj")
    assert benchmark.resolve_config(p + 4, "fused", "pieces", "split2m",
                                    torch.float32) == ("twostage",
                                                       "onthefly", "jtj")
    assert benchmark.resolve_config(p + 4, "fused", "pieces", "split2m",
                                    torch.float32, "dense") == (
        "dense", "precomputed" if p % 2 else "onthefly", "adjj")


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_kernel_wrappers_take_the_fused_configurations(p):
    """The kernels' argument check takes an operator exactly when its
    (factor, metric) is one of ``laplace_cuda.fused_configs`` at its degree
    (split2m twostage at every degree since ROADMAP 6f); the others raise,
    naming ROADMAP."""
    for precision, factor, metric in itertools.product(
            ("highest", "split2m"), ("dense", "twostage"),
            ("precomputed", "onthefly")):
        if (factor, metric) not in laplace_cuda.fused_configs(precision):
            continue  # the builders refuse it at every degree
        op = bp4.build(2, p, torch.float32, precision, factor=factor,
                       metric=metric, windowing="pieces", device="cpu").op
        d = torch.zeros((3,) + op.n_nodes_axis)
        if (factor, metric) in laplace_cuda.fused_configs(precision, p):
            fk._check_cuda(op, [d])
        else:
            assert (precision, factor, p) != ("split2m", "twostage", 4)
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                fk._check_cuda(op, [d])


@pytest.mark.parametrize("metric,rung", list(itertools.product(
    ("precomputed", "onthefly"), RUNGS)))
def test_from_jax_arrays_dense_fused(metric, rung):
    """A JAX pieces operator built dense, with or without ``gmetric``,
    carried across: the same arrays as the port's own ``bp4.build``."""
    s, p = 3, 2
    jp = _jax_problem(s, p, metric, rung)
    jop = jp.op
    conv = bp4.from_jax_arrays(
        s, p, mats=np.asarray(jop.mats), pds=np.asarray(jop.pds),
        w3=np.asarray(jop.w3), coeffs=np.asarray(jop.coeffs),
        mask=np.asarray(jop.mask), b=np.asarray(jp.b),
        inv_diag=np.asarray(jp.inv_diag),
        gmetric=None if jop.gmetric is None else np.asarray(jop.gmetric),
        factor="dense", precision=rung, dtype=RUNGS[rung][1], device="cpu")
    own = _port_problem(s, p, metric, rung)
    assert conv.op.factor == own.op.factor == "dense"
    assert conv.op.metric == own.op.metric == metric
    names = ["mats", "sz", "dz", "pds", "w3", "coeffs", "mask", "kpds",
             "kcoeffs"] + (["gmetric"] if metric == "precomputed" else [])
    for name in names:
        a, b = getattr(own.op, name), getattr(conv.op, name)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-15,
                                   err_msg=name)
    if rung == "split2m":
        assert torch.equal(own.op.mma_mats, conv.op.mma_mats)
    np.testing.assert_array_equal(own.b.numpy(), conv.b.numpy())


def _bench_json(main, capsys):
    main()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    return json.loads(lines[0])


def test_bench_torch_prints_bench_py_schema(monkeypatch, capsys):
    """``bench_torch.py`` with ``run_one``, the bandwidth and the card
    monkeypatched: one JSON line with ``bench.py``'s keys and metric name
    (``bench.py`` run the same way), value and the 9-word roofline share."""
    import bench
    import bench_torch
    from mf_data_locality_tpu.utils import timing as jtiming
    from mf_data_locality_tpu_torch.utils import timing

    seen = {}

    def fake(mod, key):
        def run_one(degree, s, **kw):
            seen.setdefault(key, (degree, s, kw))
            return mod.RunResult(degree, degree + 2, 8192, 1_635_075,
                                 2.0e-4, 8.0e9, 92, 1.0e-4, False)
        return run_one

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench_torch, "card", lambda: "H100, 700.00 W")
    monkeypatch.setattr(benchmark, "run_one", fake(benchmark, "port"))
    monkeypatch.setattr(timing, "measure_hbm_bandwidth", lambda dev: 3.0e12)
    got = _bench_json(bench_torch.main, capsys)
    monkeypatch.setattr(jbench, "run_one", fake(jbench, "jax"))
    monkeypatch.setattr(jtiming, "measure_hbm_bandwidth", lambda: 3.0e12)
    monkeypatch.setattr(jtiming, "latency_recheck",
                        lambda: (True, 1e-3, 1e-3))
    monkeypatch.setattr(jtiming, "round_trip_latency", lambda: 1e-3)
    want = _bench_json(bench.main, capsys)
    assert set(got) == set(want) == {"metric", "value", "unit",
                                     "vs_baseline"}
    assert got == want
    assert got["metric"] == "bp4_merged_cg_dofs_per_s_per_it_p4"
    assert got["vs_baseline"] == pytest.approx(8.0e9 / (3.0e12 / 36))
    degree, s, kw = seen["port"]
    assert (degree, s) == seen["jax"][:2] == (4, 13)
    assert {k: kw[k] for k in ("solver", "precision", "windowing", "metric",
                               "solve_repeats", "matvec_repeats",
                               "matvec_inner")} == {
        k: seen["jax"][2][k] for k in ("solver", "precision", "windowing",
                                       "metric", "solve_repeats",
                                       "matvec_repeats", "matvec_inner")}


def test_bench_torch_fails_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                          capture_output=True, text=True)
    assert proc.returncode != 0
    assert proc.stdout == ""
