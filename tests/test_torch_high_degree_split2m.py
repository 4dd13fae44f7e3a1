"""PyTorch port at degrees 5..11 under ``split2m``: B1 (``piece_vmult``)
and B2 (``fused_cg_iteration``) against the JAX package in the fused
solver's twostage configurations there — the metric rebuilt by the jtj
chain (the auto path), rebuilt by adjj, and streamed — and the fused solve
of the auto path at the parity points.

The JAX side is ``bp4.build(..., backend="pallas", windowing="pieces",
precision="split2m", factor="twostage")``, its Pallas kernels in interpret
mode on the CPU, compared at the lattice level through its own
``to_piece_state`` / ``from_piece_state``.  The port runs its plain
versions and the tensor-core kernel's arithmetic
(``_cell_apply_mma_emulated``: the packed bf16 tables, the q-planes padded
to pairs).  Inputs are made with numpy from a seed.  Tolerances, f32
split2m: 1e-5 of the vectors' max, the 7 update3b sums and the 8 scalars
1e-4 relative (sums of ~1e4 terms in another order; the port's Jacobian
is exact f32, the TPU's a split3 product: ROADMAP C3).  p = 9..11 are
marked ``slow``; the card compares every degree in ``chip_smoke.py``.  A
file of its own so that it runs on its own test worker.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.ops import cg_fused_kernel as jfk
from mf_data_locality_tpu.solvers import cg_fused as jcg
from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.solvers import cg_fused

S = 3  # 8 cells (2 x 2 x 2)
TOL, TOL_SUMS = 1e-5, 1e-4
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
# (metric, cofactor) of the twostage configurations
CONFIGS = {"onthefly_jtj": ("onthefly", "jtj"),
           "onthefly_adjj": ("onthefly", "adjj"),
           "precomputed": ("precomputed", "adjj")}
CELL_APPLY = {"plain": fk._cell_apply, "mma": fk._cell_apply_mma_emulated}
CASES = [(p, c, a) for p in (5, 6, 7, 8) for c in CONFIGS for a in CELL_APPLY]
CASES += [pytest.param(p, c, a, marks=pytest.mark.slow)
          for p in (9, 10, 11) for c in CONFIGS for a in CELL_APPLY]


def _to_compact(u, p):
    return jfk.to_piece_state(jnp.asarray(u), p)[:, :, :p * p]


def _from_compact(v, p, lat):
    ncx = (lat[2] - 1) // p
    return np.asarray(jfk.from_piece_state(jfk._expand_mm(v, p, ncx), p, lat))


def _jax_problem(p, config, s=S):
    metric, cofactor = CONFIGS[config]
    return jbp4.build(s, p, dtype=jnp.float32, backend="pallas",
                      precision="split2m", windowing="pieces",
                      factor="twostage", metric=metric, cofactor=cofactor)


def _sums(d2, g2, h2, prec):
    """The 7 update3b sums (d.h, h.h, g.h, g.g, g.Ph, h.Ph, g.Pg) in f64."""
    d2, g2, h2, prec = (np.asarray(v, np.float64) for v in (d2, g2, h2, prec))
    ph, pg = prec * h2, prec * g2
    return np.array([np.sum(d2 * h2), np.sum(h2 * h2), np.sum(g2 * h2),
                     np.sum(g2 * g2), np.sum(g2 * ph), np.sum(h2 * ph),
                     np.sum(g2 * pg)])


@functools.lru_cache(maxsize=None)
def _jax_reference(p, config):
    """Inputs made with numpy from a seed and the JAX kernels' results on
    them: (mask, u, B1's h, (x, g, d, h, scal, prec), B2's four vectors,
    their 7 sums, B2's scalars)."""
    jp = _jax_problem(p, config)
    lat = jp.layout.n_nodes_axis
    mask = np.asarray(jp.op.mask).reshape((1,) + lat)
    rng = np.random.default_rng(900 + p)
    u = (rng.standard_normal((3,) + lat) * mask).astype(np.float32)
    dpc = _to_compact(u, p)
    h, _ = jfk.piece_vmult(jp.op, lat, dpc, jfk.zplanes_init(dpc, p),
                           compact=True)
    b1 = _from_compact(h, p, lat)
    x, g, d, hh = ((rng.standard_normal((3,) + lat) * mask)
                   .astype(np.float32) for _ in range(4))
    prec = (np.asarray(jp.inv_diag).reshape((1,) + lat)
            * mask).astype(np.float32)
    scal = np.array(SCAL, np.float32)
    xs, gs, ds, hs = (_to_compact(v, p) for v in (x, g, d, hh))
    out = jfk.fused_cg_iteration(
        jp.op, lat, xs, gs, ds, hs, jfk.zplanes_init(gs, p),
        jfk.zplanes_init(ds, p), jfk.zplanes_init(hs, p), jnp.asarray(scal),
        _to_compact(prec, p), compact=True)
    b2 = [_from_compact(v, p, lat) for v in out[:4]]
    return (mask, u, b1, (x, g, d, hh, scal, prec), b2,
            _sums(b2[2], b2[1], b2[3], prec), np.asarray(out[7]))


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("p,config,cell_apply", CASES)
def test_matvec_and_iteration_match_jax(p, config, cell_apply):
    """B1 (``_matvec_plain`` with the plain cell pass or the tensor-core
    kernel's arithmetic) against ``piece_vmult``; B2
    (``_fused_iteration_plain`` with the same cell pass) against
    ``fused_cg_iteration``: the four vectors, the 7 sums over them and the
    8 scalars."""
    metric, cofactor = CONFIGS[config]
    op = bp4.build(S, p, torch.float32, "split2m", factor="twostage",
                   metric=metric, cofactor=cofactor, windowing="pieces",
                   device="cpu").op
    assert (op.factor, op.metric, op.cofactor) == ("twostage", metric,
                                                   cofactor)
    assert (op.factor, op.metric) in fk.laplace_cuda.fused_configs(
        "split2m", p)
    mask, u, b1, inputs, b2, sums, scal = _jax_reference(p, config)
    ca = CELL_APPLY[cell_apply]
    assert _rel(fk._matvec_plain(op, torch.as_tensor(u), ca), b1) < TOL
    x, g, d, hh, sc, prec = (torch.as_tensor(v) for v in inputs)
    res = fk._fused_iteration_plain(op, x, g, d, hh, sc, prec, cell_apply=ca)
    for got, want in zip(res[:4], b2):
        assert _rel(got, want) < TOL
    np.testing.assert_allclose(_sums(res[2], res[1], res[3], inputs[5]),
                               sums, rtol=TOL_SUMS)
    np.testing.assert_allclose(res[4].numpy(), scal, rtol=TOL_SUMS)


@pytest.mark.parametrize("p", [5, 8])
def test_from_jax_arrays_split2m_twostage(p):
    """The JAX twostage split2m operator (``mats2d``, the coefficients or
    the streamed metric) carried across by ``from_jax_arrays`` is the
    port's own build: the same arrays, the same fragment tables."""
    for config, (metric, cofactor) in CONFIGS.items():
        jp = _jax_problem(p, config, s=1)
        jop = jp.op
        conv = bp4.from_jax_arrays(
            1, p, mats2d=np.asarray(jop.mats2d), pds=np.asarray(jop.pds),
            w3=np.asarray(jop.w3), coeffs=np.asarray(jop.coeffs),
            mask=np.asarray(jop.mask), b=np.asarray(jp.b),
            inv_diag=np.asarray(jp.inv_diag),
            gmetric=(None if jop.gmetric is None
                     else np.asarray(jop.gmetric)),
            factor="twostage", cofactor=cofactor, precision="split2m",
            dtype=torch.float32, device="cpu").op
        own = bp4.build(1, p, torch.float32, "split2m", factor="twostage",
                        metric=metric, cofactor=cofactor, windowing="pieces",
                        device="cpu").op
        assert (conv.metric, conv.cofactor) == (metric, cofactor)
        for name in ("mats2d", "sz", "dz", "kpds", "w3", "kcoeffs",
                     "mma_mats") + (("gmetric",) if metric ==
                                    "precomputed" else ()):
            a, b = getattr(own, name), getattr(conv, name)
            if a.dtype == torch.bfloat16:
                assert torch.equal(a.view(torch.int16), b.view(torch.int16))
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                           atol=1e-7, err_msg=name)


def _solve_f64_scalars(op, b, prec, n_max=100):
    """The fused solve's loop (``cg_fused.fused_merged_cg_solve``) stepped
    with the 7 update3b sums recomputed in f64 from each iteration's
    vectors and the scalars from them carried in place of the f32 ones:
    (iterations to 1e-8 res0 or ``n_max``, the residual estimate / res0 at
    the end, the largest relative error of the f32 iteration's alpha, beta
    and res2 against the f64 sums')."""
    g0 = -(b * op.mask)
    res0 = torch.linalg.norm(g0.double()).item()
    scal = torch.zeros((8,), dtype=op.dtype)
    scal[4] = 1.0
    state = (torch.zeros_like(g0), g0, torch.zeros_like(g0),
             torch.zeros_like(g0), scal)
    err = 0.0
    for it in range(1, n_max + 1):
        x, g, d, h, new = fk.fused_cg_iteration(op, *state, prec)
        g64, d64, h64, p64 = (t.double() for t in (g, d, h, prec))
        sums = torch.stack([
            torch.sum(d64 * h64), torch.sum(h64 * h64), torch.sum(g64 * h64),
            torch.sum(g64 * g64), torch.sum(g64 * p64 * h64),
            torch.sum(h64 * p64 * h64), torch.sum(g64 * p64 * g64),
            torch.zeros((), dtype=torch.float64)])
        old = state[4].double()
        ref = fk.scalar_recurrence(sums, old[0], old[1], old[4])
        pick = [0, 1, 5]
        err = max(err, ((new.double() - ref)[pick].abs()
                        / ref[pick].abs()).max().item())
        state = (x, g, d, h, ref.to(op.dtype))
        res = max(ref[5].item(), 0.0) ** 0.5 / res0
        if res <= 1e-8:
            break
    return it, res, err


@pytest.mark.parametrize("p,s", [(5, 6), (6, 4)])
def test_fused_solve_matches_jax_split2m(p, s):
    """The slice whole on the CPU: the fused solve under split2m through the
    port's resolvers (twostage + onthefly + jtj, as the JAX resolvers give)
    takes the JAX f32 interpret run's itCG within 1, in PARITY.md's class
    (f64 95 at p=5 s=6 and 75 at p=6 s=4, +0..3; the JAX split2m run 96-97
    and 76).  p=5 s=6 sits on the tolerance's edge, where the f32 merged
    recurrence levels off at about 1e-8 res0 (the JAX run at 97, the plain
    version's residual estimate at 1.3e-8 res0 there, ROADMAP C3: its
    Jacobian is exact f32): a solve at the cap passes only with the floor
    shown to be the f32 recurrence's — its alpha, beta and res2 within 1e-5
    of the scalars from f64 sums of its own vectors, and, with those f64
    scalars carried, converged in the JAX run's count within 1 — and a
    residual within 2x the tolerance by then."""
    config = benchmark.resolve_config(p, "fused", "pieces", "split2m",
                                      torch.float32)
    assert config == ("twostage", "onthefly", "jtj")
    jp = _jax_problem(p, "onthefly_jtj", s=s)
    lat = jp.layout.n_nodes_axis
    ref = jcg.fused_merged_cg_solve(
        jp.op, lat, jnp.asarray(jp.b).reshape((3,) + lat),
        jnp.asarray(jp.inv_diag).reshape((1,) + lat))
    assert bool(ref.converged)
    pb = bp4.build(s, p, torch.float32, "split2m", device="cpu",
                   windowing="pieces", **dict(zip(("factor", "metric",
                                                   "cofactor"), config)))
    res = cg_fused.fused_merged_cg_solve(
        pb.op, lat, pb.b.reshape((3,) + lat),
        pb.inv_diag.reshape((1,) + lat))
    n_jax, n64 = int(ref.n_iterations), {5: 95, 6: 75}[p]
    assert n_jax - n64 in range(0, 4)
    if res.converged or p != 5:
        assert res.converged
        assert abs(res.n_iterations - n_jax) <= 1
        assert res.n_iterations - n64 in range(0, 4)
        return
    hist = res.res_history.numpy()
    assert res.n_iterations == 100 and hist[n_jax] / hist[0] <= 2e-8
    it, res64, err = _solve_f64_scalars(
        pb.op, pb.b.reshape((3,) + lat), pb.inv_diag.reshape((1,) + lat))
    assert err <= 1e-5
    assert res64 <= 1e-8 and abs(it - n_jax) <= 1
