"""PyTorch port at degrees 5..11 under ``highest``: B1 (``piece_vmult``)
and B2 (``fused_cg_iteration``) against the JAX package, in the fused
solver's configurations there — twostage + the streamed metric (the auto
path), twostage + the metric rebuilt by the jtj chain (``--geometry
onthefly``), and the dense factorization with the streamed metric.

The JAX side is ``bp4.build(..., backend="pallas", windowing="pieces")``,
its Pallas kernels in interpret mode on the CPU, compared at the lattice
level through its own ``to_piece_state`` / ``from_piece_state``.  The port
runs its plain versions and the sum-factorized kernel's arithmetic
(``_cell_apply_sumfac_emulated``).  Inputs are made with numpy from a seed.
Tolerances: f64 1e-12 of the vectors' max, the 7 update3b sums and the 8
scalars 1e-12 relative; f32 1e-5, sums and scalars 1e-4 (sums of ~1e4
terms in another order).  p = 9..11 are marked ``slow``; the card compares
every degree in ``chip_smoke.py``.  A second file beside
``test_torch_high_degree.py`` so that the two run on two test workers.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.ops import cg_fused_kernel as jfk
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk

S = 3  # 8 cells (2 x 2 x 2)
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
RUNGS = {"f64": (np.float64, torch.float64, 1e-12, 1e-12),
         "f32": (np.float32, torch.float32, 1e-5, 1e-4)}
# (factor, metric, cofactor)
CONFIGS = {"auto": ("twostage", "precomputed", "adjj"),
           "onthefly_jtj": ("twostage", "onthefly", "jtj"),
           "dense": ("dense", "precomputed", "adjj")}
CASES = [(p, c, "f64") for p in (5, 6, 7, 8) for c in CONFIGS]
CASES += [(p, "auto", "f32") for p in (5, 8)]
CASES += [pytest.param(p, c, "f64", marks=pytest.mark.slow)
          for p in (9, 10, 11) for c in CONFIGS]


def _to_compact(u, p):
    return jfk.to_piece_state(jnp.asarray(u), p)[:, :, :p * p]


def _from_compact(v, p, lat):
    ncx = (lat[2] - 1) // p
    return np.asarray(jfk.from_piece_state(jfk._expand_mm(v, p, ncx), p, lat))


@functools.lru_cache(maxsize=None)
def _jax_problem(p, config, rung):
    factor, metric, cofactor = CONFIGS[config]
    return jbp4.build(S, p, dtype=jnp.dtype(RUNGS[rung][0]), backend="pallas",
                      precision="highest", windowing="pieces", factor=factor,
                      metric=metric, cofactor=cofactor)


def _port_op(p, config, rung):
    factor, metric, cofactor = CONFIGS[config]
    op = bp4.build(S, p, RUNGS[rung][1], "highest", factor=factor,
                   metric=metric, cofactor=cofactor, windowing="pieces",
                   device="cpu").op
    assert (op.factor, op.metric, op.cofactor) == CONFIGS[config]
    return op


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _sums(d2, g2, h2, prec):
    """The 7 update3b sums (d.h, h.h, g.h, g.g, g.Ph, h.Ph, g.Pg) in f64."""
    d2, g2, h2, prec = (np.asarray(v, np.float64) for v in (d2, g2, h2, prec))
    ph, pg = prec * h2, prec * g2
    return np.array([np.sum(d2 * h2), np.sum(h2 * h2), np.sum(g2 * h2),
                     np.sum(g2 * g2), np.sum(g2 * ph), np.sum(h2 * ph),
                     np.sum(g2 * pg)])


@pytest.mark.parametrize("p,config,rung", CASES)
def test_matvec_and_iteration_match_jax(p, config, rung):
    """B1 (the plain version and the sum-factorized kernel's arithmetic)
    against ``piece_vmult``; B2 (both) against ``fused_cg_iteration``: the
    four vectors, the 7 sums over them and the 8 scalars."""
    nd, td, tol, tol_s = RUNGS[rung]
    jp = _jax_problem(p, config, rung)
    op = _port_op(p, config, rung)
    lat = jp.layout.n_nodes_axis
    mask = np.asarray(jp.op.mask).reshape((1,) + lat)
    rng = np.random.default_rng(300 + p)

    u = (rng.standard_normal((3,) + lat) * mask).astype(nd)
    dpc = _to_compact(u, p)
    h, _ = jfk.piece_vmult(jp.op, lat, dpc, jfk.zplanes_init(dpc, p),
                           compact=True)
    ref = _from_compact(h, p, lat)
    ut = torch.as_tensor(u)
    assert _rel(fk.matvec(op, ut), ref) < tol
    assert _rel(fk._matvec_plain(op, ut, fk._cell_apply_sumfac_emulated),
                ref) < tol

    x, g, d, hh = ((rng.standard_normal((3,) + lat) * mask).astype(nd)
                   for _ in range(4))
    prec = (np.asarray(jp.inv_diag).reshape((1,) + lat) * mask).astype(nd)
    scal = np.array(SCAL, nd)
    xs, gs, ds, hs = (_to_compact(v, p) for v in (x, g, d, hh))
    out = jfk.fused_cg_iteration(
        jp.op, lat, xs, gs, ds, hs, jfk.zplanes_init(gs, p),
        jfk.zplanes_init(ds, p), jfk.zplanes_init(hs, p), jnp.asarray(scal),
        _to_compact(prec, p), compact=True)
    want = [_from_compact(v, p, lat) for v in out[:4]]
    want_scal = np.asarray(out[7])
    want_sums = _sums(want[2], want[1], want[3], prec)
    args = [torch.as_tensor(v) for v in (x, g, d, hh, scal, prec)]
    for res in (fk.fused_cg_iteration(op, *args),
                fk._fused_iteration_plain(
                    op, *args, cell_apply=fk._cell_apply_sumfac_emulated)):
        for got, w in zip(res[:4], want):
            assert _rel(got, w) < tol
        np.testing.assert_allclose(
            _sums(res[2], res[1], res[3], prec), want_sums, rtol=tol_s)
        np.testing.assert_allclose(res[4].numpy(), want_scal, rtol=tol_s)
