"""PyTorch port: the baseline and merged CG solvers and the slice end to end
(``bp4.build`` + ``solve_merged`` on the cell-batched operator) against the
JAX package.

The JAX side runs on the CPU with x64 on, its Pallas kernels in interpret
mode; the port runs its plain versions.  Both solve the same problem (the
same mesh, operator, preconditioner and right-hand side).  In f64 the
iteration counts are identical and the residual histories agree within
1e-10 relative to the initial residual.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.solvers import cg as jcg
from mf_data_locality_tpu.solvers import cg_merged as jcg_merged
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.solvers import cg, cg_merged

SOLVERS = {"merged": (jcg_merged.merged_cg_solve, cg_merged.merged_cg_solve,
                      False),
           "baseline": (jcg.cg_solve, cg.cg_solve, True)}


def _pair(s, p, windowing="reshape", jd=jnp.float64, td=torch.float64):
    jp = jbp4.build(s, p, dtype=jd, backend="pallas", windowing=windowing)
    tp = bp4.build(s, p, td, "highest", factor="dense", metric="precomputed",
                   windowing=windowing, device="cpu")
    return jp, tp


def _apply(problem, constrained_identity):
    return problem.a_apply_full if constrained_identity else problem.a_apply


def _assert_same_solve(ref, res, x_tol=1e-10):
    n = int(ref.n_iterations)
    assert res.n_iterations == n
    assert res.converged == bool(ref.converged)
    hr = np.asarray(ref.res_history)[:n + 1]
    hg = res.res_history.numpy()[:n + 1]
    np.testing.assert_allclose(hg, hr, rtol=0, atol=1e-10 * hr[0])
    xr = np.asarray(ref.x)
    np.testing.assert_allclose(res.x.numpy(), xr, rtol=0,
                               atol=x_tol * np.abs(xr).max())


@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("p,s,windowing", [(2, 4, "reshape"),
                                           (4, 3, "zslab")])
def test_solver_matches_jax_f64(solver, p, s, windowing):
    jsolve, tsolve, ci = SOLVERS[solver]
    jp, tp = _pair(s, p, windowing)
    ref = jsolve(_apply(jp, ci), jp.b, jp.inv_diag)
    res = tsolve(_apply(tp, ci), tp.b, tp.inv_diag)
    _assert_same_solve(ref, res)


def test_baseline_count_equals_merged():
    """The reference's own invariant: in f64 the textbook and the merged
    CG take the same iterations, with histories equal to roundoff."""
    tp = bp4.build(4, 4, torch.float64, "highest", factor="dense",
                   metric="precomputed", windowing="reshape", device="cpu")
    rm, rb = bp4.solve_merged(tp), bp4.solve_baseline(tp)
    assert rm.converged and rm.n_iterations == rb.n_iterations
    n = rm.n_iterations
    np.testing.assert_allclose(rm.res_history.numpy()[:n + 1],
                               rb.res_history.numpy()[:n + 1], rtol=1e-8)
    np.testing.assert_allclose(rm.x.numpy(), rb.x.numpy(), rtol=0,
                               atol=1e-8 * rb.x.abs().max().item())


@pytest.mark.parametrize("max_iter", [5, 6])
def test_delayed_x_fixup_at_truncation(max_iter):
    """Stopped at an odd or an even iteration, the merged solve applies the
    pending x update of that parity, as the JAX solver does."""
    jp, tp = _pair(4, 2)
    ref = jcg_merged.merged_cg_solve(jp.a_apply, jp.b, jp.inv_diag,
                                     max_iter=max_iter)
    res = cg_merged.merged_cg_solve(tp.a_apply, tp.b, tp.inv_diag,
                                    max_iter=max_iter)
    assert res.n_iterations == max_iter and not res.converged
    _assert_same_solve(ref, res)
    base = cg.cg_solve(tp.a_apply, tp.b, tp.inv_diag, max_iter=max_iter)
    np.testing.assert_allclose(res.x.numpy(), base.x.numpy(), rtol=0,
                               atol=1e-10 * base.x.abs().max().item())


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_x0_given_matches_jax(solver):
    jsolve, tsolve, ci = SOLVERS[solver]
    jp, tp = _pair(4, 2)
    rng = np.random.default_rng(2)
    x0 = rng.standard_normal(tuple(tp.b.shape)) * (1 - tp.layout
                                                   .boundary_node_mask)
    ref = jsolve(_apply(jp, ci), jp.b, jp.inv_diag, x0=jnp.asarray(x0))
    res = tsolve(_apply(tp, ci), tp.b, tp.inv_diag, x0=torch.as_tensor(x0))
    _assert_same_solve(ref, res)


@pytest.mark.parametrize("rung", ["f64", "f32"])
def test_slice_end_to_end_matches_jax(rung):
    """The slice's path at a small size: ``bp4.build`` + ``solve_merged`` on
    the cell-batched operator (p=2, s=4) against the JAX ``solve_merged``
    with ``windowing="reshape"``.  f64: identical itCG and history; f32
    highest against the JAX f32 run: itCG within 1 and the same solution
    to 1e-5."""
    jd, td = ((jnp.float64, torch.float64) if rung == "f64"
              else (jnp.float32, torch.float32))
    jp, tp = _pair(4, 2, jd=jd, td=td)
    ref, res = jbp4.solve_merged(jp), bp4.solve_merged(tp)
    if rung == "f64":
        _assert_same_solve(ref, res)
        return
    assert abs(res.n_iterations - int(ref.n_iterations)) <= 1
    assert res.converged and bool(ref.converged)
    xr = np.asarray(ref.x)
    np.testing.assert_allclose(res.x.numpy(), xr, rtol=0,
                               atol=1e-5 * np.abs(xr).max())


def test_breakdown_ends_the_solve():
    """A zero operator makes d.h = 0: alpha and the residual estimate are
    NaN, and the solve ends unconverged after one iteration."""
    tp = bp4.build(3, 2, torch.float64, "highest", factor="dense",
                   metric="precomputed", windowing="reshape", device="cpu")
    res = cg_merged.merged_cg_solve(lambda u: torch.zeros_like(u), tp.b,
                                    tp.inv_diag)
    assert res.n_iterations == 1 and np.isnan(res.res_norm)
    assert not res.converged
