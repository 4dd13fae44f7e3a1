"""PyTorch port: the reduced rungs ``split3`` and ``bf16``, the bf16 state
(``dtype=torch.bfloat16``: d and h stored in bf16) and the bf16 metric
stream (``metric_dtype=torch.bfloat16``), against the JAX package.

The JAX side is ``bp4.build(..., backend="pallas", windowing="pieces",
precision=...)``, its Pallas kernels in interpret mode on the CPU, compared
at the lattice level through its own ``to_piece_state`` /
``from_piece_state``.  The port runs its plain versions and its kernels'
arithmetic (``_cell_apply_mma_emulated``, ``_batched_mma_emulated``: the
packed bf16 tables, Mh and under split3 Ml).  Inputs are made with numpy
from a seed and handed to both.

Tolerances (max |diff| / max |ref| unless said otherwise):

* split3 at the f32 class, 1e-5 of the vectors' max, the 8 scalars 1e-4
  relative (``test_torch_high_degree_split2m.py``'s: sums of ~1e3-1e4
  terms in another order; the port's Jacobian is exact f32, the TPU's a
  split3 product);
* bf16 (its vectors, with an f32 or a bf16 state): relative L2 5e-4 and
  max 1e-2 of max |ref| — a stream value that the two sides sum in another
  order (or, with the metric rebuilt, from a Jacobian the JAX package
  evaluates as a split3 product and the port in exact f32) can land on the
  other side of a bf16 rounding boundary and move its products by 2^-8 of
  it; measured up to 1.24e-4 (L2) in the fast cases, 3.45e-4 in the slow
  ones (p=5, twostage + jtj, the bf16 state), and 9.7e-4 (max).  The L2
  limit refuses the control, split2m's product set in place of bf16's
  (what a kernel of the wrong rung computes: 7.2e-4 to 2.5e-3 here,
  checked by ``assert_refuses_control``); the max limit cannot (1.5e-3
  and more against 9.7e-4).  The scalars 1e-4 relative, measured up to 4.7e-6,
  where a port that sums the unrounded f32 d' misses by 6e-4 to 2e-2.

Here: the fragment tables, B1/B2 in the dense factorization at p=1..4,
B3/B5/B6, ``from_jax_arrays``, the dispatch and the refusals;
``test_torch_reduced_rungs_fused.py`` (a file of its own, so that it runs
on its own test worker) holds B1/B2 in twostage, the bf16 state, the bf16
metric on B1 and the fused solves, with this file's helpers and
tolerances.
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
from mf_data_locality_tpu.solvers import cg_fused as jcg
from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.ops import laplace_cuda
from mf_data_locality_tpu_torch.solvers import cg_fused

S = 3  # 8 cells (2 x 2 x 2)
TOL, TOL_SCAL = 1e-5, 1e-4
TOL_L2_BF16, TOL_MAX_BF16 = 5e-4, 1e-2
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
RUNGS = ("split3", "bf16")
BF = torch.bfloat16
CELL_APPLY = {"plain": fk._cell_apply, "mma": fk._cell_apply_mma_emulated}
# (factor, metric, cofactor, p) of B1/B2 in the dense factorization, at
# p=1..4 with either metric (twostage: test_torch_reduced_rungs_fused.py)
DENSE = [("dense", m, "adjj", p) for p in (1, 2, 3, 4)
         for m in ("precomputed", "onthefly")]
B12_CASES = [(*cfg, rung, ca) for cfg in DENSE for rung in RUNGS
             for ca in CELL_APPLY]


def _to_compact(u, p):
    return jfk.to_piece_state(jnp.asarray(u), p)[:, :, :p * p]


def _from_compact(v, p, lat):
    ncx = (lat[2] - 1) // p
    return np.asarray(jfk.from_piece_state(jfk._expand_mm(v, p, ncx), p, lat))


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _close_bf16(got, want) -> bool:
    """Within the bf16 values' tolerance: relative L2 and max."""
    return _l2(got, want) <= TOL_L2_BF16 and _rel(got, want) <= TOL_MAX_BF16


def assert_refuses_control(op, ref, run):
    """The bf16 tolerance refuses the control: ``run`` (the port's plain
    arithmetic, op -> its vectors) on ``op`` with split2m's product set in
    place of bf16's is further than TOL_L2_BF16 from the JAX results
    ``ref`` in one of its vectors."""
    ctl = run(dataclasses.replace(op, precision="split2m"))
    assert max(_l2(np.asarray(a, np.float32), b)
               for a, b in zip(ctl, ref)) > TOL_L2_BF16


@functools.lru_cache(maxsize=None)
def _jax_problem(s, p, factor, metric, cofactor, rung, bf16_state=False,
                 bf16_metric=False):
    return jbp4.build(s, p, dtype=jnp.bfloat16 if bf16_state else jnp.float32,
                      backend="pallas", precision=rung, windowing="pieces",
                      factor=factor, metric=metric, cofactor=cofactor,
                      metric_dtype=jnp.bfloat16 if bf16_metric else None)


def _port_op(p, factor, metric, cofactor, rung, bf16_state=False,
             bf16_metric=False):
    return bp4.build(S, p, BF if bf16_state else torch.float32, rung,
                     factor=factor, metric=metric, cofactor=cofactor,
                     windowing="pieces", device="cpu",
                     metric_dtype=BF if bf16_metric else None).op


@functools.lru_cache(maxsize=None)
def _jax_reference(p, factor, metric, cofactor, rung, bf16_state=False,
                   bf16_metric=False):
    """Inputs made with numpy from a seed and the JAX kernels' results on
    them: (B1's input, B1's h, (x, g, d, h, scal, prec), B2's four vectors,
    B2's scalars), as float32 arrays; d and h (in and out) hold bf16 values
    for a bf16 state."""
    jp = _jax_problem(S, p, factor, metric, cofactor, rung, bf16_state,
                      bf16_metric)
    lat = jp.layout.n_nodes_axis
    mask = np.asarray(jp.op.mask, np.float32).reshape((1,) + lat)
    store = jnp.bfloat16 if bf16_state else jnp.float32
    rng = np.random.default_rng(300 + 7 * p)

    def vec(dtype=jnp.float32):
        return _f32(jnp.asarray(rng.standard_normal((3,) + lat) * mask,
                                dtype))

    u = vec(store)
    dpc = _to_compact(jnp.asarray(u, store), p)
    h, _ = jfk.piece_vmult(jp.op, lat, dpc, jfk.zplanes_init(dpc, p),
                           compact=True)
    b1 = _f32(_from_compact(h, p, lat))
    x, g, d, hh = vec(), vec(), vec(store), vec(store)
    prec = _f32(np.asarray(jp.inv_diag).reshape((1,) + lat)) * mask
    xs, gs = _to_compact(x, p), _to_compact(g, p)
    ds, hs = (_to_compact(jnp.asarray(v, store), p) for v in (d, hh))
    out = jfk.fused_cg_iteration(
        jp.op, lat, xs, gs, ds, hs, jfk.zplanes_init(gs, p),
        jfk.zplanes_init(ds, p), jfk.zplanes_init(hs, p),
        jnp.asarray(SCAL, jnp.float32), _to_compact(prec, p), compact=True)
    b2 = [_f32(_from_compact(v, p, lat)) for v in out[:4]]
    return u, b1, (x, g, d, hh, np.array(SCAL, np.float32), prec), b2, \
        _f32(out[7])


def _inputs(args, bf16_state):
    x, g, d, h, scal, prec = (torch.as_tensor(v) for v in args)
    if bf16_state:
        d, h = d.to(BF), h.to(BF)  # exact: they hold bf16 values
    return x, g, d, h, scal, prec


@pytest.mark.parametrize("factor,p", [("dense", p) for p in (1, 2, 3, 4)]
                         + [("twostage", p) for p in (4, 5, 6)])
def test_mma_tables_split3_parts(factor, p):
    """Under split3 the tables hold Mh = bf16(M) (the split2m tables, bit
    for bit) and Ml = bf16(M - Mh) in the same fragment order, each
    direction's block zero-padded; under bf16 Mh only."""
    metric = "onthefly"
    ops = {rung: _port_op(p, factor, metric, "adjj", rung)
           for rung in ("split3", "split2m", "bf16")}
    assert ops["split3"].mma_mats.shape[0] == 4
    assert ops["bf16"].mma_mats.shape[0] == 2
    assert torch.equal(ops["split3"].mma_mats[:2].view(torch.int16),
                       ops["split2m"].mma_mats.view(torch.int16))
    assert torch.equal(ops["bf16"].mma_mats.view(torch.int16),
                       ops["split2m"].mma_mats.view(torch.int16))
    op = ops["split3"]
    m = op.mats if factor == "dense" else op.mats2d
    q3, p13 = laplace_cuda._mma_block(p, factor)
    mh = m.to(BF)
    want = (m - mh.float()).to(BF).reshape(3, q3, p13).view(torch.int16)
    for got in laplace_cuda.unpack_mma_tables(op.mma_mats, p, factor, 1):
        rp, cp = laplace_cuda.mma_dims(p, factor)
        got = got.reshape(3, rp, cp).view(torch.int16)
        assert torch.equal(got[:, :q3, :p13], want)
        assert not got[:, q3:].any() and not got[:, :, p13:].any()


def check_matvec_and_iteration(factor, metric, cofactor, p, rung,
                               cell_apply):
    """B1 (``_matvec_plain`` with the plain cell pass or the tensor-core
    kernels' arithmetic) against ``piece_vmult``, and B2
    (``_fused_iteration_plain`` with the same cell pass) against
    ``fused_cg_iteration``: the four vectors within 1e-5 (bf16: the bf16
    tolerance), the 8 scalars within 1e-4 relative; under bf16 the control
    is refused (:func:`assert_refuses_control`)."""
    op = _port_op(p, factor, metric, cofactor, rung)
    assert (op.factor, op.metric, op.cofactor) == (factor, metric, cofactor)
    assert (factor, metric) in laplace_cuda.fused_configs(rung, p)
    u, b1, args, b2, scal = _jax_reference(p, factor, metric, cofactor, rung)
    ca = CELL_APPLY[cell_apply]
    close = _close_bf16 if rung == "bf16" else (
        lambda got, want: _rel(got, want) < TOL)
    assert close(fk._matvec_plain(op, torch.as_tensor(u), ca), b1)
    res = fk._fused_iteration_plain(op, *_inputs(args, False), cell_apply=ca)
    for got, want in zip(res[:4], b2):
        assert close(got, want)
    np.testing.assert_allclose(res[4].numpy(), scal, rtol=TOL_SCAL)
    if rung == "bf16" and cell_apply == "plain":
        assert_refuses_control(
            op, [b1], lambda o: [fk._matvec_plain(o, torch.as_tensor(u))])
        assert_refuses_control(op, b2, lambda o: fk._fused_iteration_plain(
            o, *_inputs(args, False))[:4])


@pytest.mark.parametrize("factor,metric,cofactor,p,rung,cell_apply",
                         B12_CASES)
def test_matvec_and_iteration_match_jax(factor, metric, cofactor, p, rung,
                                        cell_apply):
    """:func:`check_matvec_and_iteration` in the dense factorization at
    p=1..4, the metric streamed or rebuilt."""
    check_matvec_and_iteration(factor, metric, cofactor, p, rung, cell_apply)


@functools.lru_cache(maxsize=None)
def _jax_apply(p, rung, windowing, bf16_metric):
    jp = jbp4.build(S, p, dtype=jnp.float32, backend="pallas",
                    precision=rung, windowing=windowing,
                    metric_dtype=jnp.bfloat16 if bf16_metric else None)
    lat = jp.layout.n_nodes_axis
    rng = np.random.default_rng(500 + p)
    u = (rng.standard_normal((3,) + lat)
         * np.asarray(jp.op.mask).reshape((1,) + lat)).astype(np.float32)
    v = jlp.vmult(jp.op, jnp.asarray(u), constrained_identity=False)
    return u, np.asarray(v)


@pytest.mark.parametrize("bf16_metric", [False, True])
@pytest.mark.parametrize("windowing", ["reshape", "pieces", "zslab"])
@pytest.mark.parametrize("rung", RUNGS)
def test_apply_family_matches_jax(rung, windowing, bf16_metric):
    """B3 (reshape), B5 (pieces) and B6 (zslab) at p=3 on the rung, the
    metric streamed in f32 or bf16, against JAX ``laplace_pallas.vmult``
    (interpret mode) within 1e-5 (bf16: the bf16 tolerance, which refuses
    the control); on B3 also the tensor-core kernel's arithmetic."""
    p = 3
    op = bp4.build(S, p, torch.float32, rung, windowing=windowing,
                   device="cpu", metric_dtype=BF if bf16_metric else None).op
    u, ref = _jax_apply(p, rung, windowing, bf16_metric)
    ut = torch.as_tensor(u)

    def close(got):
        return (_close_bf16(got, ref) if rung == "bf16"
                else _rel(got, ref) < TOL)

    assert close(la.vmult(op, ut, constrained_identity=False))
    if rung == "bf16":
        assert_refuses_control(op, [ref], lambda o: [
            la.vmult(o, ut, constrained_identity=False)])
    if windowing == "reshape":
        u_loc = la.to_cell_batches(ut * op.mask, p).contiguous()
        v = la._batched_mma_emulated(op, u_loc, la._metric(op))
        assert close(la.from_cell_batches(v, p, op.n_cells_axis) * op.mask)


def test_from_jax_arrays_carries_bf16_bit_for_bit():
    """``from_jax_arrays`` takes a JAX bf16 operator's and problem's
    arrays — the bf16 metric, b and the preconditioner of a bf16 state,
    numpy ``ml_dtypes.bfloat16`` — bit for bit, and builds the split3
    tables as the port's own build does."""
    p = 2
    jp = _jax_problem(1, p, "dense", "precomputed", "adjj", "bf16", True,
                      True)
    jop = jp.op
    conv = bp4.from_jax_arrays(
        1, p, mats=np.asarray(jop.mats), pds=np.asarray(jop.pds),
        w3=np.asarray(jop.w3), coeffs=np.asarray(jop.coeffs),
        mask=np.asarray(jop.mask), b=np.asarray(jp.b),
        inv_diag=np.asarray(jp.inv_diag), gmetric=np.asarray(jop.gmetric),
        factor="dense", precision="bf16", dtype=BF, device="cpu")
    nc = conv.op.n_cells
    for got, want in ((conv.op.gmetric, np.asarray(jop.gmetric)[:, :nc]),
                      (conv.b, np.asarray(jp.b)),
                      (conv.inv_diag, np.asarray(jp.inv_diag))):
        assert got.dtype == BF
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.ascontiguousarray(want).view(np.int16))
    assert conv.op.dtype == torch.float32 and conv.op.metric_dtype == BF
    own = bp4.build(1, p, torch.float32, "split3", factor="dense",
                    windowing="pieces", device="cpu").op
    conv3 = bp4.from_jax_arrays(
        1, p, mats=np.asarray(jop.mats), pds=np.asarray(jop.pds),
        w3=np.asarray(jop.w3), coeffs=np.asarray(jop.coeffs),
        mask=np.asarray(jop.mask), b=np.asarray(jp.b, np.float32),
        inv_diag=np.asarray(jp.inv_diag, np.float32), factor="dense",
        precision="split3", dtype=torch.float32, device="cpu").op
    assert torch.equal(conv3.mma_mats.view(torch.int16),
                       own.mma_mats.view(torch.int16))


@pytest.mark.parametrize("p", range(1, 12))
def test_dispatch_matches_jax_eff_prec(p):
    """At every degree the port resolves split3, bf16 and the bf16 state
    as the JAX ``run_one`` does — with ``dtype=bfloat16`` the dispatch sees
    the bf16 rung whatever the precision (``eff_prec``) — and the
    configuration it gives is one the port runs."""
    for rung, dtype in (("split3", torch.float32), ("bf16", torch.float32),
                        ("bf16", BF)):
        got = benchmark.resolve_config(p, "fused", "pieces", rung, dtype)
        eff = "bf16" if dtype == BF else rung
        f = jbench.resolve_factor("auto", p, "pieces", precision=eff,
                                  solver="fused", metric="auto")
        m = jbench.resolve_metric("auto", "fused", "pieces", f, p,
                                  precision=eff)
        assert got == (f, m, jbench.resolve_cofactor("auto", p, f, m,
                                                     precision=eff))
        laplace_cuda.check_config(rung, *got, dtype, "pieces", "fused", p)
    for rung in RUNGS:  # the merged solver on the apply family
        for windowing in ("reshape", "pieces", "zslab"):
            factor = jbench.resolve_factor("auto", p, windowing,
                                           precision=rung, solver="merged")
            assert benchmark.resolve_config(
                p, "merged", windowing, rung, torch.float32,
                metric_dtype=BF) == (factor, "precomputed", "adjj")
            assert factor == ("twostage" if p >= 5 and windowing == "pieces"
                              else "dense")
        # B4 (--geometry onthefly) is exact on every rung: let through
        assert benchmark.resolve_config(
            min(p, 4), "merged", "reshape", rung, torch.float32,
            metric="onthefly")[1] == "onthefly"


# each left-out combination: (resolve_config's arguments, the ROADMAP item
# its message names)
REFUSED = {
    # ported since (6d: the bf16 state on every rung, solver and
    # windowing, the bf16 metric under highest and split2m): None, they run
    "bf16 state, merged": (dict(solver="merged", windowing="reshape",
                                precision="bf16", dtype=BF), None),
    "bf16 state, baseline": (dict(solver="baseline", windowing="pieces",
                                  precision="bf16", dtype=BF), None),
    "bf16 state, split3": (dict(precision="split3", dtype=BF), None),
    "bf16 state, split2m": (dict(precision="split2m", dtype=BF), None),
    "bf16 state, highest": (dict(precision="highest", dtype=BF), None),
    "bf16 metric, highest": (dict(precision="highest",
                                  metric="precomputed",
                                  metric_dtype=BF), None),
    "bf16 metric, split2m": (dict(precision="split2m", metric="precomputed",
                                  metric_dtype=BF), None),
    # ported since (the dense tensor-core pass at p >= 5): None, they run
    "split3 merged at p=5": (dict(solver="merged", windowing="reshape",
                                  precision="split3", degree=5), None),
    "bf16 fused dense at p=6": (dict(precision="bf16", factor="dense",
                                     degree=6), None),
    # ported since (6f: twostage at p=1..3 on the tensor-core rungs; 6c:
    # jtj in their dense pass): None, they run
    "split3 twostage at p=3": (dict(precision="split3", factor="twostage",
                                    degree=3), None),
    "bf16 jtj dense": (dict(precision="bf16", factor="dense",
                            metric="onthefly", cofactor="jtj"), None),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_left_out_combinations_raise(case):
    """What this slice leaves out raises NotImplementedError naming its
    ROADMAP item, and no configuration runs on another rung in its
    place; a combination ported since (item None) resolves to its own
    rung's configuration (the factor and chain asked for, else dense and
    adjj), as the JAX resolvers give it (with a bf16 state the dispatch on
    the bf16 rung, ``eff_prec``), and builds at its own
    rung, the metric at its storage dtype; the merged solver with a bf16
    state (6d) solves."""
    kw, item = REFUSED[case]
    args = dict(degree=2, solver="fused", windowing="pieces",
                dtype=torch.float32) | kw
    call = (args.pop("degree"), args.pop("solver"), args.pop("windowing"),
            args.pop("precision"), args.pop("dtype"))
    if item is None:
        p, solver, windowing, rung, dtype = call
        eff = "bf16" if dtype == BF else rung
        config = benchmark.resolve_config(*call, **args)
        f = jbench.resolve_factor(args.get("factor", "auto"), p, windowing,
                                  precision=eff, solver=solver)
        m = args.get("metric") or jbench.resolve_metric(
            "auto", solver, windowing, f, p, precision=eff)
        c = jbench.resolve_cofactor(args.get("cofactor", "auto"), p, f, m,
                                    precision=eff)
        assert config == (f, m, c) and f == args.get("factor", "dense")
        assert c == args.get("cofactor", "adjj")
        op = bp4.build(1, p, dtype, rung, windowing=windowing, device="cpu",
                       metric_dtype=args.get("metric_dtype"),
                       **dict(zip(("factor", "metric", "cofactor"),
                                  config))).op
        assert op.precision == rung and (
            op.mma_mats is None if rung == "highest"
            else op.mma_mats.shape[0] == (4 if rung == "split3" else 2))
        assert op.metric_dtype == (args.get("metric_dtype") or op.dtype
                                   if m == "precomputed" else op.dtype)
        if case.startswith("bf16 state, merged"):
            pb = bp4.build(S, 2, BF, "bf16", factor="dense",
                           windowing="pieces", device="cpu")
            res = bp4.solve_merged(pb)
            assert res.converged and res.x.dtype == torch.float32
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        benchmark.resolve_config(*call, **args)


def test_layout_checks_of_the_bf16_state():
    """The wrappers take a bf16 d and h on every rung (6d): a bf16 state
    under split3 passes the card checks, a bf16 d and h of the wrong shape
    do not, and ``make_operator`` takes a bf16 state on the apply
    family's windowing too (f32 tables)."""
    layout = DofLayout(BoxMesh.from_s(S), 2)
    op = laplace_cuda.make_operator(layout, torch.float32, "split3",
                                    factor="dense", windowing="pieces",
                                    device="cpu")
    d = torch.zeros((3,) + op.n_nodes_axis, dtype=BF)
    fk._check_cuda(op, [], [d, d])
    with pytest.raises(ValueError, match="shape"):
        fk._check_cuda(op, [], [d[:, 1:].contiguous(), d])
    built = laplace_cuda.make_operator(layout, BF, "bf16", device="cpu")
    assert built.windowing == "reshape" and built.dtype == torch.float32


def test_bench_torch_prints_bench_py_variant_lines(monkeypatch, capsys):
    """``bench_torch.py``'s split3 and bf16 lines on stderr, with
    ``run_one``, the bandwidth and the card monkeypatched: the fields and
    format of ``bench.py``'s (run the same way), from runs in the same
    configurations (split3; bf16 with the bf16 state and metric)."""
    import bench
    import bench_torch
    from mf_data_locality_tpu.utils import timing as jtiming
    from mf_data_locality_tpu_torch.utils import timing

    calls = {"port": [], "jax": []}

    def fake(mod, key):
        def run_one(degree, s, **kw):
            calls[key].append(kw)
            return mod.RunResult(degree, degree + 2, 8192, 1_635_075,
                                 2.0e-4 * len(calls[key]), 8.0e9, 92,
                                 1.0e-4, False)
        return run_one

    def variant_lines(main):
        main()
        err = capsys.readouterr().err.splitlines()
        return [line for line in err if " variant: " in line]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench_torch, "card", lambda: "H100, 700.00 W")
    monkeypatch.setattr(benchmark, "run_one", fake(benchmark, "port"))
    monkeypatch.setattr(timing, "measure_hbm_bandwidth", lambda dev: 3.0e12)
    got = variant_lines(bench_torch.main)
    monkeypatch.setattr(jbench, "run_one", fake(jbench, "jax"))
    monkeypatch.setattr(jtiming, "measure_hbm_bandwidth", lambda: 3.0e12)
    monkeypatch.setattr(jtiming, "latency_recheck",
                        lambda: (True, 1e-3, 1e-3))
    monkeypatch.setattr(jtiming, "round_trip_latency", lambda: 1e-3)
    want = variant_lines(bench.main)
    assert [line.split(":")[0] for line in got] == ["# split3 variant",
                                                    "# bf16 variant"]
    assert got == want
    port, jax = calls["port"], calls["jax"]
    assert len(port) == len(jax) == 3
    assert port[1]["precision"] == jax[1]["precision"] == "split3"
    assert port[2]["precision"] == jax[2]["precision"] == "bf16"
    assert port[2]["dtype"] == port[2]["metric_dtype"] == BF
    assert jax[2]["dtype"] == jax[2]["metric_dtype"] == jnp.bfloat16
