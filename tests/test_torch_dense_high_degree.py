"""PyTorch port at degrees 5..11 under the tensor-core rungs split2m,
split3 and bf16, in the dense factorization: the apply family of the
merged and baseline solvers (B3 on ``reshape``, B5 on ``pieces`` — the
operator twostage there, as the JAX resolvers give it, and B5 the dense M
all the same —, B6 on ``zslab``) and B1/B2 dense (the metric streamed and
rebuilt), against the JAX package; and a merged split2m solve against the
JAX solve.

The JAX side is ``bp4.build(..., backend="pallas", precision=rung)``, its
Pallas kernels in interpret mode on the CPU (f32).  The port runs its
plain versions and the tensor-core kernels' arithmetic
(``laplace_apply._batched_mma_emulated``,
``cg_fused_kernel._cell_apply_mma_emulated``: the packed bf16 tables of
the dense M, nodes and q-points zero-padded, the K-stacked products of the
rung, t split after the metric apply).  Inputs are made with numpy from a
seed.  Tolerances: split2m and split3 1e-5 of the vectors' max, B2's 8
scalars 1e-4 relative (sums in another order; the port's rebuilt Jacobian
is exact f32, the TPU's a split3 product: ROADMAP C3); bf16 a relative L2
of 5e-4 and a max of 1e-2 (a t value summed in another order can round
across a bf16 boundary), which split2m's product set in place of bf16's
(the control) must exceed.  p = 5, 6, 8 run by default, p = 7, 9, 10, 11
are marked ``slow``; the card compares every degree in ``chip_smoke.py``.
A file of its own so that it runs on its own test worker.
"""

import dataclasses
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
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.ops import laplace_cuda

S = 3  # 8 cells (2 x 2 x 2)
RUNGS = ("split2m", "split3", "bf16")
TOL, TOL_SCAL = 1e-5, 1e-4
TOL_L2_BF16, TOL_MAX_BF16 = 5e-4, 1e-2
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
ROUTES = ("plain", "mma")  # the plain versions, the kernels' arithmetic
CASES = [(p, r, a) for p in (5, 6, 8) for r in RUNGS for a in ROUTES]
CASES += [pytest.param(p, r, a, marks=pytest.mark.slow)
          for p in (7, 9, 10, 11) for r in RUNGS for a in ROUTES]


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(rung: str):
    if rung == "bf16":
        return lambda got, want: (_l2(got, want) <= TOL_L2_BF16
                                  and _rel(got, want) <= TOL_MAX_BF16)
    return lambda got, want: _rel(got, want) < TOL


def _refuses_control(op, refs, run) -> bool:
    """``run`` (op -> its vectors) on ``op`` with split2m's product set in
    place of bf16's lies further than TOL_L2_BF16 from a JAX result."""
    ctl = run(dataclasses.replace(op, precision="split2m"))
    return max(_l2(a, b) for a, b in zip(ctl, refs)) > TOL_L2_BF16


def _merged_config(p: int, windowing: str, rung: str):
    """The merged solver's (factor, metric, cofactor) on ``windowing``, as
    the JAX resolvers give it (twostage on pieces from p=5)."""
    factor = jbench.resolve_factor("auto", p, windowing, precision=rung,
                                   solver="merged")
    return factor, "precomputed", "adjj"


@functools.lru_cache(maxsize=None)
def _jax_apply(p: int, rung: str):
    """A numpy input and JAX ``vmult`` (no constrained identity) on it for
    each windowing, on the merged solver's operator."""
    out = {}
    rng = np.random.default_rng(700 + p)
    u = None
    for windowing in ("reshape", "pieces", "zslab"):
        factor, metric, _ = _merged_config(p, windowing, rung)
        jp = jbp4.build(S, p, dtype=jnp.float32, backend="pallas",
                        precision=rung, windowing=windowing, factor=factor,
                        metric=metric)
        if u is None:
            lat = jp.layout.n_nodes_axis
            u = rng.standard_normal((3,) + lat).astype(np.float32)
        out[windowing] = np.asarray(
            jlp.vmult(jp.op, jnp.asarray(u), constrained_identity=False),
            np.float64)
    return u, out


def _emulated_vmult(op, u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The lattice apply through the tensor-core kernels' arithmetic on the
    cell batches (the gather times the mask, the assemble, the mask)."""
    p = op.degree
    u_loc = la.to_cell_batches(u * mask, p).contiguous()
    v = la._batched_mma_emulated(op, u_loc, la._metric(op))
    return la.from_cell_batches(v, p, op.n_cells_axis) * mask


@pytest.mark.parametrize("p,rung,route", CASES)
def test_apply_family_matches_jax(p, rung, route):
    """B3 (reshape), B5 (pieces, on the twostage operator the resolvers
    give) and B6 (zslab) on the rung, the plain versions (``vmult``) or the
    tensor-core kernels' arithmetic on the dense tables, against JAX
    ``laplace_pallas.vmult``; under bf16 the tolerance refuses the
    control."""
    u, refs = _jax_apply(p, rung)
    ut = torch.as_tensor(u)
    close = _close(rung)
    for windowing, ref in refs.items():
        factor, metric, cofactor = _merged_config(p, windowing, rung)
        assert benchmark.resolve_config(p, "merged", windowing, rung,
                                        torch.float32) == (factor, metric,
                                                           cofactor)
        op = bp4.build(S, p, torch.float32, rung, factor=factor,
                       metric=metric, windowing=windowing, device="cpu").op
        mask = la._index_mask(op) if windowing == "pieces" else op.mask

        def run(o):
            if route == "plain":
                return [la.vmult(o, ut, constrained_identity=False)]
            return [_emulated_vmult(o, ut, mask)]

        (got,) = run(op)
        assert close(got, ref), (windowing, _rel(got, ref), _l2(got, ref))
        if rung == "bf16" and route == "plain":
            assert _refuses_control(op, [ref], run), windowing


@functools.lru_cache(maxsize=None)
def _jax_dense(p: int, rung: str, metric: str):
    """Inputs made with numpy from a seed and the JAX fused kernels'
    results in the dense factorization: (B1's input, B1's h, (x, g, d, h,
    scal, prec), B2's four vectors, B2's scalars), in f64."""
    jp = jbp4.build(S, p, dtype=jnp.float32, backend="pallas",
                    precision=rung, windowing="pieces", factor="dense",
                    metric=metric)
    lat = jp.layout.n_nodes_axis
    mask = np.asarray(jp.op.mask, np.float32).reshape((1,) + lat)
    rng = np.random.default_rng(800 + 3 * p)

    def vec():
        return (rng.standard_normal((3,) + lat) * mask).astype(np.float32)

    def compact(v):
        return jfk.to_piece_state(jnp.asarray(v), p)[:, :, :p * p]

    def lattice(v):
        ncx = (lat[2] - 1) // p
        return np.asarray(jfk.from_piece_state(jfk._expand_mm(v, p, ncx), p,
                                               lat), np.float64)

    u = vec()
    du = compact(u)
    h, _ = jfk.piece_vmult(jp.op, lat, du, jfk.zplanes_init(du, p),
                           compact=True)
    x, g, d, hh = vec(), vec(), vec(), vec()
    prec = (np.asarray(jp.inv_diag).reshape((1,) + lat) * mask).astype(
        np.float32)
    xs, gs, ds, hs = (compact(v) for v in (x, g, d, hh))
    out = jfk.fused_cg_iteration(
        jp.op, lat, xs, gs, ds, hs, jfk.zplanes_init(gs, p),
        jfk.zplanes_init(ds, p), jfk.zplanes_init(hs, p),
        jnp.asarray(SCAL, jnp.float32), compact(prec), compact=True)
    return (u, lattice(h), (x, g, d, hh, np.array(SCAL, np.float32), prec),
            [lattice(v) for v in out[:4]], np.asarray(out[7], np.float64))


@pytest.mark.parametrize("p,rung,route", CASES)
def test_dense_matvec_and_iteration_match_jax(p, rung, route):
    """B1 (``_matvec_plain`` with the plain cell pass or the tensor-core
    kernels' arithmetic) against ``piece_vmult``, B2
    (``_fused_iteration_plain`` with the same cell pass) against
    ``fused_cg_iteration``, in the dense factorization with the metric
    streamed and rebuilt: the four vectors, the 8 scalars; under bf16 the
    tolerance refuses the control."""
    cell_apply = fk._cell_apply if route == "plain" else (
        fk._cell_apply_mma_emulated)
    close = _close(rung)
    for metric in ("precomputed", "onthefly"):
        op = bp4.build(S, p, torch.float32, rung, factor="dense",
                       metric=metric, windowing="pieces", device="cpu").op
        assert (op.factor, op.metric) in laplace_cuda.fused_configs(rung, p)
        u, b1, args, b2, scal = _jax_dense(p, rung, metric)
        ut = torch.as_tensor(u)
        inputs = [torch.as_tensor(v) for v in args]
        got = fk._matvec_plain(op, ut, cell_apply)
        assert close(got, b1), (metric, _rel(got, b1), _l2(got, b1))
        res = fk._fused_iteration_plain(op, *inputs, cell_apply=cell_apply)
        for a, b in zip(res[:4], b2):
            assert close(a, b), (metric, _rel(a, b), _l2(a, b))
        np.testing.assert_allclose(res[4].numpy(), scal, rtol=TOL_SCAL)
        if rung == "bf16" and route == "plain":
            assert _refuses_control(
                op, [b1], lambda o: [fk._matvec_plain(o, ut)])
            assert _refuses_control(op, b2, lambda o: fk._fused_iteration_plain(
                o, *inputs)[:4])


@pytest.mark.parametrize("p", [5, 8])
def test_dense_tables_of_a_twostage_operator(p):
    """B5 on a twostage operator (the merged solver's ``pieces`` from p=5)
    reads the dense M: ``dense_mma_tables`` is the dense operator's
    ``mma_mats`` bit for bit, under each rung (split3 with its Ml part),
    built once an operator; the twostage operator's own tables stay the 2D
    stage's."""
    for rung in RUNGS:
        ops = {f: bp4.build(1, p, torch.float32, rung, factor=f,
                            metric="precomputed", windowing="pieces",
                            device="cpu").op for f in ("dense", "twostage")}
        tables = laplace_cuda.dense_mma_tables(ops["twostage"])
        assert tables is laplace_cuda.dense_mma_tables(ops["twostage"])
        assert torch.equal(tables.view(torch.int16),
                           ops["dense"].mma_mats.view(torch.int16))
        assert laplace_cuda.dense_mma_tables(ops["dense"]) is (
            ops["dense"].mma_mats)
        rp, cp = laplace_cuda.mma_dims(p, "twostage")
        assert ops["twostage"].mma_mats.shape[1] == 3 * rp * cp


@functools.lru_cache(maxsize=None)
def _jax_merged_solve(p: int, s: int):
    """(itCG, residual history) of the JAX ``solve_merged`` under f32
    split2m on the cell-batched operator."""
    jp = jbp4.build(s, p, dtype=jnp.float32, backend="pallas",
                    precision="split2m", windowing="reshape")
    res = jbp4.solve_merged(jp)
    return int(res.n_iterations), np.asarray(res.res_history, np.float64)


def test_merged_split2m_solve_matches_jax():
    """The merged solver under split2m at p=5 s=3 (B3 on the tensor-core
    rung, the plain version here) against the JAX ``solve_merged`` in
    interpret mode: the residual histories agree within 1e-5 of the
    initial residual over the common iterations (reading 1.0e-6: f32 sums
    in another order), both first fall below 1e-7 res0 at the same
    iteration, and both converge.  Their final counts may differ: the
    rung's residual levels off at 1-1.5e-8 res0 here, about the 1e-8
    tolerance (JAX 48, the port 46, f64 43)."""
    n_ref, hist_ref = _jax_merged_solve(5, 3)
    pb = bp4.build(3, 5, torch.float32, "split2m", device="cpu")
    assert (pb.op.factor, pb.op.precision) == ("dense", "split2m")
    res = bp4.solve_merged(pb)
    assert res.converged and n_ref < 100
    n = min(res.n_iterations, n_ref)
    hist = res.res_history.numpy().astype(np.float64)[:n + 1]
    np.testing.assert_allclose(hist, hist_ref[:n + 1], rtol=0,
                               atol=1e-5 * hist_ref[0])
    below = [int(np.argmax(h / h[0] < 1e-7)) for h in (hist, hist_ref)]
    assert below[0] == below[1] > 0
