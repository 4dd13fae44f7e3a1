"""PyTorch port: fused CG iteration, scalar recurrence and whole solves
against the JAX package.

The JAX side runs as ``tests/test_cg_fused.py`` runs it: on the CPU, its
Pallas kernels in interpret mode, f64 (x64 is on) or f32 for split2m.  The
port runs its plain PyTorch versions (tensors on the CPU).  Inputs are
made with numpy from a seed and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.ops import cg_fused_kernel as jfk
from mf_data_locality_tpu.solvers import cg_fused as jcg_fused
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.solvers import cg_fused

P = 4  # the slice's degree


def _jax_problem(s, dtype=jnp.float64, precision="highest"):
    return jbp4.build(s, P, dtype=dtype, backend="pallas",
                      precision=precision, windowing="pieces",
                      factor="twostage", metric="onthefly", cofactor="adjj")


def _port_problem(s, dtype=torch.float64, precision="highest"):
    return bp4.build(s, P, dtype=dtype, precision=precision)


def _to_compact(u, p):
    return jfk.to_piece_state(jnp.asarray(u), p)[:, :, :p * p]


def _from_compact(v, p, lataxis):
    ncx = (lataxis[2] - 1) // p
    return np.asarray(jfk.from_piece_state(jfk._expand_mm(v, p, ncx), p,
                                           lataxis))


def test_fused_iteration_matches_jax_f64():
    """One fused iteration from a random boundary-zero state: the four
    vectors and the 8 scalars agree with the JAX kernel to 1e-12."""
    s = 4
    jp = _jax_problem(s)
    lat = jp.layout.n_nodes_axis
    mask = np.asarray(jp.op.mask)
    rng = np.random.default_rng(11)
    x, g, d, h = (rng.standard_normal((3,) + lat) * mask for _ in range(4))
    prec = np.asarray(jp.inv_diag).reshape((1,) + lat) * mask
    scal = np.array([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6])

    # JAX side: compact piece inputs as cg_fused.py:118-142 builds them
    xs, gs, ds, hs = (_to_compact(v, P) for v in (x, g, d, h))
    out = jfk.fused_cg_iteration(
        jp.op, lat, xs, gs, ds, hs, jfk.zplanes_init(gs, P),
        jfk.zplanes_init(ds, P), jfk.zplanes_init(hs, P), jnp.asarray(scal),
        _to_compact(prec, P), compact=True)
    ref = [_from_compact(v, P, lat) for v in (out[0], out[1], out[2], out[3])]
    ref_scal = np.asarray(out[7])

    op = _port_problem(s).op
    t = [torch.as_tensor(v) for v in (x, g, d, h)]
    res = fk.fused_cg_iteration(op, *t, torch.as_tensor(scal),
                                torch.as_tensor(prec))
    for got, want in zip(res[:4], ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(res[4].numpy(), ref_scal, rtol=1e-12)


def test_scalar_recurrence_matches_jax():
    rng = np.random.default_rng(5)
    for parity in (0.0, 1.0):
        s = rng.standard_normal(8)
        s[7] = 0.0
        a, b = 0.4, 0.9
        want = np.asarray(jfk.scalar_recurrence(
            jnp.asarray(s), jnp.asarray(a), jnp.asarray(b),
            jnp.asarray(parity)))
        got = fk.scalar_recurrence(*(torch.as_tensor(v, dtype=torch.float64)
                                     for v in (s, a, b, parity)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)


def test_scalar_recurrence_breakdown_is_nan():
    """d.h = 0 with g.Pg = 0 (a zero direction) gives NaN alpha and res2 on
    both sides, which ends the solve as non-converged."""
    s = np.zeros(8)
    want = np.asarray(jfk.scalar_recurrence(
        jnp.asarray(s), jnp.asarray(0.5), jnp.asarray(0.5), jnp.asarray(1.0)))
    got = fk.scalar_recurrence(*(torch.as_tensor(v, dtype=torch.float64)
                                 for v in (s, 0.5, 0.5, 1.0))).numpy()
    assert np.isnan(want[0]) and np.isnan(want[5])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)])


@pytest.mark.parametrize("it", [0, 1, 2, 7])
def test_delayed_x_fixup_matches_jax(it):
    rng = np.random.default_rng(it)
    x, g, d = (rng.standard_normal((3, 5, 5, 9)) for _ in range(3))
    prec = rng.standard_normal((1, 5, 5, 9))
    scal = rng.standard_normal(8)
    want = np.asarray(jfk.delayed_x_fixup(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(d), jnp.asarray(prec),
        jnp.asarray(scal), jnp.asarray(it)))
    got = fk.delayed_x_fixup(*(torch.as_tensor(v) for v in (x, g, d, prec)),
                             torch.as_tensor(scal), it)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)


def test_solve_f64_matches_jax():
    """Whole f64 solve at p=4, s=4: identical itCG, history and x
    (the tolerances of test_cg_fused.py:45-56)."""
    s = 4
    jp = _jax_problem(s)
    lat = jp.layout.n_nodes_axis
    ref = jcg_fused.fused_merged_cg_solve(
        jp.op, lat, jp.b.reshape((3,) + lat), jp.inv_diag.reshape((1,) + lat))
    tp = _port_problem(s)
    res = cg_fused.fused_merged_cg_solve(
        tp.op, lat, tp.b.reshape((3,) + lat),
        tp.inv_diag.reshape((1,) + lat))
    n = int(ref.n_iterations)
    assert res.n_iterations == n
    assert res.converged == bool(ref.converged)
    hr = np.asarray(ref.res_history)[:n + 1]
    hf = res.res_history.numpy()[:n + 1]
    np.testing.assert_allclose(hf, hr, rtol=1e-6, atol=1e-8 * hr[0])
    xr = np.asarray(ref.x)
    np.testing.assert_allclose(res.x.numpy(), xr,
                               atol=1e-10 * max(1.0, np.abs(xr).max()))


def test_solve_split2m_itcg_matches_jax_f32():
    """f32 split2m solve at p=4, s=4: itCG within 1 of the JAX f32 run
    (the Jacobian is exact f32 here, split3 there; sums run in another
    order)."""
    s = 4
    jp = _jax_problem(s, jnp.float32, "split2m")
    lat = jp.layout.n_nodes_axis
    ref = jcg_fused.fused_merged_cg_solve(
        jp.op, lat, jp.b.reshape((3,) + lat), jp.inv_diag.reshape((1,) + lat))
    tp = _port_problem(s, torch.float32, "split2m")
    res = cg_fused.fused_merged_cg_solve(
        tp.op, lat, tp.b.reshape((3,) + lat),
        tp.inv_diag.reshape((1,) + lat))
    assert abs(res.n_iterations - int(ref.n_iterations)) <= 1
    assert res.converged == bool(ref.converged)


def test_x0_start_matches_zero_start():
    """The x0 shift solves A dx = b - A x0: starting from a partial
    solution reaches the same solution."""
    tp = _port_problem(3)
    lat = tp.layout.n_nodes_axis
    b = tp.b.reshape((3,) + lat)
    prec = tp.inv_diag.reshape((1,) + lat)
    ref = cg_fused.fused_merged_cg_solve(tp.op, lat, b, prec, rel_tol=1e-12)
    part = cg_fused.fused_merged_cg_solve(tp.op, lat, b, prec, max_iter=5)
    res = cg_fused.fused_merged_cg_solve(tp.op, lat, b, prec, x0=part.x,
                                         rel_tol=1e-12)
    assert res.converged
    xr = ref.x.numpy()
    np.testing.assert_allclose(res.x.numpy(), xr,
                               atol=1e-9 * np.abs(xr).max())
