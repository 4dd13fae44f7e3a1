"""PyTorch port: the benchmark harness (resolvers, result row, CLI
guards) against the JAX package, and the port's import hygiene."""

import itertools
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mf_data_locality_tpu import benchmark as jbench
from mf_data_locality_tpu_torch import benchmark

REPO = Path(__file__).resolve().parent.parent

DEGREES = range(1, 12)
PRECISIONS = ("highest", "split3", "split2m", "bf16", "bf16sr")
SOLVERS = ("fused", "merged", "baseline")
METRICS = ("auto", "precomputed", "onthefly")


@pytest.mark.parametrize("windowing", ["pieces", "reshape"])
def test_resolvers_match_jax(windowing):
    for p, prec, solver, metric, factor in itertools.product(
            DEGREES, PRECISIONS, SOLVERS, METRICS, ("auto", "dense")):
        f = benchmark.resolve_factor(factor, p, windowing, precision=prec,
                                     solver=solver, metric=metric)
        assert f == jbench.resolve_factor(factor, p, windowing,
                                          precision=prec, solver=solver,
                                          metric=metric)
        m = benchmark.resolve_metric(metric, solver, windowing, f, p,
                                     precision=prec)
        assert m == jbench.resolve_metric(metric, solver, windowing, f, p,
                                          precision=prec)
        for cof in ("auto", "adjj"):
            assert (benchmark.resolve_cofactor(cof, p, f, m, precision=prec)
                    == jbench.resolve_cofactor(cof, p, f, m, precision=prec))


def test_headline_resolves_to_the_ported_configuration():
    f = benchmark.resolve_factor("auto", 4, "pieces", precision="split2m",
                                 solver="fused", metric="auto")
    m = benchmark.resolve_metric("auto", "fused", "pieces", f, 4,
                                 precision="split2m")
    c = benchmark.resolve_cofactor("auto", 4, f, m, precision="split2m")
    assert (f, m, c) == ("twostage", "onthefly", "adjj")


def test_row_and_ladder_match_jax():
    fields = dict(degree=4, n_q=6, n_cells=8192, n_dofs=1635075,
                  time_per_it=1.25e-4, dofs_per_s_per_it=1.3e10,
                  n_iterations=100, time_per_matvec=1.1e-4, converged=False)
    assert benchmark.RunResult(**fields).row() == jbench.RunResult(
        **fields).row()
    assert benchmark.HEADER == jbench.HEADER
    for p in (1, 4, 7):
        assert benchmark.ladder_sizes(p) == jbench.ladder_sizes(p,
                                                                n_devices=1)


def test_run_one_refuses_without_card_and_unported_paths():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        benchmark.run_one(4, 3, solver="merged", windowing="matmul",
                          device="cpu")
    for p, kw in ((5, {}),  # p >= 5 (twostage + onthefly + jtj)
                  (4, {"factor": "twostage", "metric": "precomputed"}),
                  (3, {"factor": "twostage", "metric": "onthefly"})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            benchmark.run_one(p, 3, solver="fused", precision="split2m",
                              windowing="pieces", device="cpu", **kw)
    with pytest.raises(ValueError, match="pieces"):
        benchmark.run_one(4, 3, solver="fused", precision="split2m",
                          device="cpu")  # the JAX CLI's refusal too
    for kw in ({"solver": "fused", "precision": "split2m",
                "windowing": "pieces"},
               {"solver": "fused", "precision": "highest",
                "windowing": "pieces"},  # resolves to dense + precomputed
               {"solver": "merged"}, {"solver": "baseline",
                                      "windowing": "zslab"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            benchmark.run_one(4, 3, device="cpu", **kw)


def test_cli_defaults_match_jax(monkeypatch):
    """Called with no flags, both CLIs run the same configuration: solver,
    precision, windowing and the metric the resolvers pick."""
    seen = {}

    def fake(mod, key):
        def run_one(degree, s, **kw):
            seen[key] = kw
            return mod.RunResult(degree, degree + 2, 8, 375, 1e-4, 1e9, 10,
                                 1e-4, True)
        return run_one

    monkeypatch.setattr(jbench, "run_one", fake(jbench, "jax"))
    monkeypatch.setattr(benchmark, "run_one", fake(benchmark, "port"))
    jbench.main(["4", "3"])
    benchmark.main(["4", "3"])
    resolved = {}
    for key, mod in (("jax", jbench), ("port", benchmark)):
        kw = seen[key]
        factor = mod.resolve_factor(kw["factor"], 4, kw["windowing"],
                                    precision=kw["precision"],
                                    solver=kw["solver"], metric=kw["metric"])
        resolved[key] = (kw["solver"], kw["precision"], kw["windowing"],
                         mod.resolve_metric(kw["metric"], kw["solver"],
                                            kw["windowing"], factor, 4,
                                            precision=kw["precision"]))
    assert resolved["port"] == resolved["jax"] == (
        "merged", "highest", "reshape", "precomputed")


def test_imports_no_jax():
    code = ("import sys\n"
            "import bench_torch, mf_data_locality_tpu_torch, "
            "mf_data_locality_tpu_torch.benchmark, "
            "mf_data_locality_tpu_torch.solvers.cg_fused, "
            "mf_data_locality_tpu_torch.solvers.cg_merged, "
            "mf_data_locality_tpu_torch.ops.laplace_apply, "
            "mf_data_locality_tpu_torch.utils.profiling\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mf_data_locality_tpu.'))"
            " or m == 'mf_data_locality_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_chip_smoke_fails_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True)
    assert proc.returncode != 0
    assert proc.stdout == ""
