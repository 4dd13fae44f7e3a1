"""PyTorch port at the shapes beyond BP4's: CEED BP3 (one component) and
the Gauss rule q = p + 1 (queue B item 6g) — B1 (``piece_vmult``) and
B2 (``fused_cg_iteration``) against the JAX package.

The JAX side is ``bp4.build(..., backend="pallas", windowing="pieces",
n_components=, n_q=)``, its Pallas kernels in interpret mode on the CPU,
compared at the lattice level through its own ``to_piece_state`` /
``from_piece_state``.  The port runs its plain versions and the kernels'
arithmetic (``_cell_apply_sumfac_emulated``, the highest pass;
``_cell_apply_mma_emulated``, the split2m tensor-core passes).  Inputs
are made with numpy from a seed.  Tolerances: f64 1e-12 of the vectors'
max, the 8 scalars 1e-11 relative; f32 split2m 1e-5, scalars 1e-4.  The
whole solves are ``tests/test_torch_shapes_solve.py``'s.
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

SHAPES = {"bp3": (1, 2), "q1": (3, 1), "bp3_q1": (1, 1)}
S = {1: 3, 2: 3, 4: 2, 5: 2}
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
# f64 highest: the JAX auto path's fused configuration (dense + streamed
# to p=4, twostage + streamed from p=5) and the metric rebuilt by adjj
CONFIGS = {"auto": None, "onthefly": ("dense", "onthefly", "adjj")}


def _config(p, config):
    if CONFIGS[config] is not None:
        return CONFIGS[config]
    return (("dense" if p <= 4 else "twostage"), "precomputed", "adjj")


@functools.lru_cache(maxsize=None)
def _problems(p, shape, config, precision="highest"):
    c, dq = SHAPES[shape]
    factor, metric, cofactor = config
    f64 = precision == "highest"
    kw = dict(n_components=c, n_q=p + dq, windowing="pieces", factor=factor,
              metric=metric, cofactor=cofactor)
    jp = jbp4.build(S[p], p, dtype=jnp.float64 if f64 else jnp.float32,
                    backend="pallas", precision=precision, **kw)
    tp = bp4.build(S[p], p, torch.float64 if f64 else torch.float32,
                   precision, device="cpu", **kw)
    return jp, tp


def _to_compact(u, p):
    return jfk.to_piece_state(jnp.asarray(u), p)[:, :, :p * p]


def _from_compact(v, p, lat):
    ncx = (lat[2] - 1) // p
    return np.asarray(jfk.from_piece_state(jfk._expand_mm(v, p, ncx), p, lat))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _check_b1_b2(jp, op, p, emulations, tol, tol_s, nd):
    """B1 against ``piece_vmult`` and B2 against ``fused_cg_iteration``:
    the plain versions and each cell pass of ``emulations``."""
    lat = jp.layout.n_nodes_axis
    c = jp.n_components
    mask = np.asarray(jp.op.mask).reshape((1,) + lat)
    rng = np.random.default_rng(500 + 10 * p + c)
    u = (rng.standard_normal((c,) + lat) * mask).astype(nd)
    dpc = _to_compact(u, p)
    h, _ = jfk.piece_vmult(jp.op, lat, dpc, jfk.zplanes_init(dpc, p),
                           compact=True)
    ref = _from_compact(h, p, lat)
    ut = torch.as_tensor(u)
    assert _rel(fk.matvec(op, ut), ref) < tol
    for cell_apply in emulations:
        assert _rel(fk._matvec_plain(op, ut, cell_apply), ref) < tol

    x, g, d, hh = ((rng.standard_normal((c,) + lat) * mask).astype(nd)
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
    args = [torch.as_tensor(v) for v in (x, g, d, hh, scal, prec)]
    results = [fk.fused_cg_iteration(op, *args)] + [
        fk._fused_iteration_plain(op, *args, cell_apply=ca)
        for ca in emulations]
    for res in results:
        for got, w in zip(res[:4], want):
            assert _rel(got, w) < tol
        np.testing.assert_allclose(res[4].numpy()[:6], want_scal[:6],
                                   rtol=tol_s)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("p", [1, 2, 4, 5])
def test_matvec_and_iteration_match_jax(p, shape, config):
    """B1 and B2 at each shape, f64: the plain versions and the
    sum-factorized pass's arithmetic against the JAX kernels."""
    jp, tp = _problems(p, shape, _config(p, config))
    assert tp.n_components == jp.n_components
    _check_b1_b2(jp, tp.op, p, (fk._cell_apply_sumfac_emulated,), 1e-12,
                 1e-11, np.float64)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_twostage_split2m_matches_jax(shape):
    """B1 and B2 in the production configuration at p=4 (f32 split2m,
    twostage + onthefly + adjj): the plain versions and the twostage
    tensor-core pass's arithmetic (its tables at q, the q-planes padded to
    pairs, the padded plane of an odd q zero)."""
    p = 4
    jp, tp = _problems(p, shape, ("twostage", "onthefly", "adjj"),
                       "split2m")
    _check_b1_b2(jp, tp.op, p, (fk._cell_apply_mma_emulated,), 1e-5, 1e-4,
                 np.float32)


@pytest.mark.parametrize("shape", ["bp3", "q1"])
def test_dense_split2m_matches_jax(shape):
    """B1 and B2 dense under f32 split2m at p=2 (the JAX auto path's there):
    the plain versions and the dense tensor-core pass's arithmetic."""
    p = 2
    jp, tp = _problems(p, shape, ("dense", "precomputed", "adjj"),
                       "split2m")
    _check_b1_b2(jp, tp.op, p, (fk._cell_apply_mma_emulated,), 1e-5, 1e-4,
                 np.float32)
