"""PyTorch port: split2m at f64 (the JAX CLI's ``--dtype f64 --precision
split2m``) against the JAX package, on the CPU.

The JAX package runs split2m at f64 with bf16 parts of f64 values: M
rounded once to bf16, each stream split into hi = bf16(x) and lo = bf16(x
- hi), both rounded from f64 through f32 (XLA's f64 -> bf16 conversion,
as torch's).  The apply family (B3, B5, B6; ``laplace_pallas._mm``) sums
the products at the operand's dtype, f64; B1 and B2 (``cg_fused_kernel.
_mm_pre``) sum them in f32 whatever the state's dtype, and the f32 result
meets the f64 metric (and, in twostage, the z stage back runs at f32).
The port's plain versions compute the same: B3/B5/B6 within 1e-12
relative L2 of the JAX kernels in interpret mode, B1/B2 within 2e-6 (the
f32 sums' order), and f64 ``highest``, the control, misses both by at
least 1e-4.  The slice whole: the merged (reshape) and fused (pieces)
solves at p=2 s=3 against the JAX ``run_one``'s.  Inputs are made with
numpy from a seed; the JAX problems are built once a module.  The kernels
(``csrc/mma_f64.cu``) are held against these plain versions on the card
by ``chip_smoke.py``.
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
from mf_data_locality_tpu.ops import laplace_pallas as jlp
from mf_data_locality_tpu.solvers import cg_fused as jcg_fused
from mf_data_locality_tpu.solvers import cg_merged as jcg_merged
from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.ops import laplace_cuda
from test_torch_reduced_rungs import SCAL, _from_compact, _l2, _to_compact

F64 = torch.float64
S = 3  # 8 cells
TOL_APPLY = 1e-12    # B3/B5/B6 plain vs JAX, relative L2
TOL_B12 = 2e-6       # B1/B2 plain vs JAX, relative L2 (f32 sums)
CONTROL = 1e-4       # f64 highest misses by at least this
TOL_HIST = 1e-6      # a solve's history vs JAX's, of res0
# 1 + 2^-8 + 2^-30: to f32 it rounds to 1 + 2^-8, a bf16 tie, which rounds
# to even, 1.0; rounded once from f64 it is 1 + 2^-7
X_TIE = 1.0 + 2.0 ** -8 + 2.0 ** -30


@functools.lru_cache(maxsize=None)
def _jax_problem(s, p, windowing, factor="dense", metric="precomputed",
                 cofactor="adjj"):
    return jbp4.build(s, p, dtype=jnp.float64, backend="pallas",
                      precision="split2m", windowing=windowing,
                      factor=factor, metric=metric, cofactor=cofactor)


def _port_op(s, p, windowing, precision="split2m", **kw):
    return bp4.build(s, p, F64, precision, windowing=windowing,
                     device="cpu", **kw).op


def test_bf16_parts_round_through_f32():
    """The port's f64 -> bf16 rounding is the JAX package's (through f32):
    1 + 2^-8 + 2^-30 gives 1.0 in the stream parts, in M's rounding and in
    the kernels' fragment tables, where a single rounding gives 1 +
    2^-7."""
    x = torch.tensor([X_TIE], dtype=F64)
    assert float(jnp.asarray(X_TIE, jnp.float64).astype(jnp.bfloat16)) == 1.0
    assert float(np.float32(X_TIE)) == 1.0 + 2.0 ** -8  # the f32 tie
    (mh, xh), (_, xl) = fk._terms(x, x, "split2m")
    assert mh.item() == xh.item() == 1.0
    assert xl.item() == fk._bf16(x - 1.0).item() == 2.0 ** -8
    m = torch.full((3 * 27, 8), X_TIE, dtype=F64)  # p=1: (3 q^3, (p+1)^3)
    fwd, bwd = laplace_cuda.unpack_mma_tables(
        laplace_cuda.mma_tables(m, 1, "dense", "split2m"), 1)
    assert fwd[0, 0].item() == bwd[0, 0].item() == 1.0


@functools.lru_cache(maxsize=None)
def _jax_vmult(s, p, windowing):
    jp = _jax_problem(s, p, windowing)
    lat = jp.layout.n_nodes_axis
    rng = np.random.default_rng(900 + p)
    u = rng.standard_normal((3,) + lat) * np.asarray(jp.op.mask).reshape(
        (1,) + lat)
    return u, np.asarray(jlp.vmult(jp.op, jnp.asarray(u),
                                   constrained_identity=False))


@pytest.mark.parametrize("s,p,windowing", [(S, 2, "reshape"),
                                           (S, 2, "pieces"),
                                           (S, 2, "zslab"),
                                           (1, 5, "reshape")])
def test_apply_family_matches_jax(s, p, windowing):
    """B3 (reshape), B5 (pieces), B6 (zslab) under split2m at f64: the
    plain version within 1e-12 relative L2 of the JAX kernel in interpret
    mode (the products summed in f64 on both sides); f64 highest misses
    by more than 1e-4."""
    u, ref = _jax_vmult(s, p, windowing)
    ut = torch.as_tensor(u)
    op = _port_op(s, p, windowing)
    assert op.dtype == F64 and op.precision == "split2m"
    got = la.vmult(op, ut, constrained_identity=False)
    assert _l2(got.numpy(), ref) <= TOL_APPLY
    ctl = la.vmult(_port_op(s, p, windowing, "highest"), ut,
                   constrained_identity=False)
    assert _l2(ctl.numpy(), ref) >= CONTROL


# (factor, metric, cofactor, p) of B1/B2: the JAX auto path's at p=1
# (dense + precomputed) and p=2 (dense + onthefly), and twostage with the
# metric rebuilt by jtj (the auto chain from p=5)
B12 = [("dense", "onthefly", "adjj", 2), ("twostage", "onthefly", "jtj", 2),
       ("dense", "precomputed", "adjj", 1)]


@pytest.mark.parametrize("factor,metric,cofactor,p", B12)
def test_matvec_and_iteration_match_jax(factor, metric, cofactor, p):
    """B1 against ``piece_vmult`` and B2 against ``fused_cg_iteration`` at
    f64 split2m (interpret mode): h, x', g', d', h' and the scalars within
    2e-6 relative L2 (the products' sums in f32 on both sides, in another
    order); f64 highest misses h and h' by more than 1e-4."""
    jp = _jax_problem(S, p, "pieces", factor, metric, cofactor)
    lat = jp.layout.n_nodes_axis
    mask = np.asarray(jp.op.mask).reshape((1,) + lat)
    rng = np.random.default_rng(40 + p)
    x, g, d, h, u = (rng.standard_normal((3,) + lat) * mask
                     for _ in range(5))
    prec = np.asarray(jp.inv_diag).reshape((1,) + lat) * mask
    uc = _to_compact(u, p)
    hb1, _ = jfk.piece_vmult(jp.op, lat, uc, jfk.zplanes_init(uc, p),
                             compact=True)
    comp = [_to_compact(v, p) for v in (x, g, d, h)]
    out = jfk.fused_cg_iteration(
        jp.op, lat, *comp, jfk.zplanes_init(comp[1], p),
        jfk.zplanes_init(comp[2], p), jfk.zplanes_init(comp[3], p),
        jnp.asarray(SCAL, jnp.float64), _to_compact(prec, p), compact=True)
    want = [_from_compact(hb1, p, lat)] + [
        _from_compact(v, p, lat) for v in out[:4]] + [np.asarray(out[7])]

    def port(precision):
        op = _port_op(S, p, "pieces", precision, factor=factor,
                      metric=metric, cofactor=cofactor)
        t = [torch.as_tensor(v) for v in (x, g, d, h, SCAL, prec)]
        return [fk.matvec(op, torch.as_tensor(u))] + list(
            fk.fused_cg_iteration(op, *t))

    got = port("split2m")
    for a, b in zip(got, want):
        assert _l2(a.numpy(), b) <= TOL_B12
    ctl = port("highest")
    for k in (0, 4):  # h and h', the operator's outputs
        assert _l2(ctl[k].numpy(), want[k]) >= CONTROL


def test_from_jax_arrays_takes_the_f64_operator():
    """An f64 split2m JAX operator carried across by ``from_jax_arrays`` is
    the port's own build: the same f64 arrays, the bf16 fragment tables
    bit for bit (M rounded from f64 as ``_prestack`` rounds it)."""
    for factor, metric in (("dense", "precomputed"), ("twostage",
                                                      "onthefly")):
        jp = _jax_problem(S, 2, "pieces", factor, metric)
        jop = jp.op
        conv = bp4.from_jax_arrays(
            S, 2, mats2d=np.asarray(jop.mats2d), mats=np.asarray(jop.mats),
            pds=np.asarray(jop.pds), w3=np.asarray(jop.w3),
            coeffs=np.asarray(jop.coeffs), mask=np.asarray(jop.mask),
            b=np.asarray(jp.b), inv_diag=np.asarray(jp.inv_diag),
            gmetric=(None if jop.gmetric is None
                     else np.asarray(jop.gmetric)),
            factor=factor, precision="split2m", dtype=F64,
            device="cpu").op
        own = _port_op(S, 2, "pieces", factor=factor, metric=metric)
        assert conv.dtype == F64 and conv.metric == metric
        assert torch.equal(own.mma_mats.view(torch.int16),
                           conv.mma_mats.view(torch.int16))
        for name in ("mats2d", "sz", "dz", "kpds", "w3", "kcoeffs"):
            np.testing.assert_allclose(getattr(own, name).numpy(),
                                       getattr(conv, name).numpy(),
                                       rtol=1e-14, atol=1e-15, err_msg=name)


@pytest.mark.parametrize("solver,windowing", [("merged", "reshape"),
                                              ("fused", "pieces")])
def test_solve_matches_jax_run_one(monkeypatch, solver, windowing):
    """The slice whole: ``run_one(2, 3, solver, dtype=f64,
    precision="split2m")``'s solve (``benchmark.solver_call`` on the
    configuration ``resolve_config`` gives, as the JAX resolvers give it)
    against the JAX ``run_one`` with the same flags (its timing chains
    stubbed; its one solve read back): itCG equal (11), the history within
    1e-6 of res0."""
    monkeypatch.setattr(jbench.timing, "time_pair_fetch",
                        lambda *a, **k: (1.0, 2.0))
    monkeypatch.setattr(jbench.timing, "time_scan_fetch",
                        lambda *a, **k: 1.0)
    seen = []
    mod, name = ((jcg_fused, "fused_merged_cg_solve") if solver == "fused"
                 else (jcg_merged, "merged_cg_solve"))
    solve = getattr(mod, name)

    def read_back(*args, **kw):  # run_one's solve, traced under its jit
        res = solve(*args, **kw)
        jax.debug.callback(lambda *v: seen.append(v), res.res_history,
                           res.n_iterations)
        return res

    monkeypatch.setattr(mod, name, read_back)
    f, m, c = benchmark.resolve_config(2, solver, windowing, "split2m", F64)
    jr = jbench.run_one(2, S, solver=solver, dtype=jnp.float64,
                        backend="pallas", precision="split2m",
                        windowing=windowing, solve_repeats=1,
                        matvec_repeats=1, matvec_inner=1,
                        problem=_jax_problem(S, 2, windowing, f, m, c))
    jax.effects_barrier()
    hist, n = seen[0]
    assert jr.converged and jr.n_iterations == int(n) == 11

    tp = bp4.build(S, 2, F64, "split2m", factor=f, metric=m, cofactor=c,
                   windowing=windowing, device="cpu")
    got = benchmark.solver_call(tp, solver)()
    assert got.converged and got.n_iterations == jr.n_iterations
    k = got.n_iterations + 1
    hist = np.asarray(hist, np.float64)[:k]
    assert np.abs(got.res_history.numpy()[:k] - hist).max() <= (
        TOL_HIST * hist[0])


@pytest.mark.parametrize("kw,label", [
    (dict(precision="split3"), "item 6h"),
    (dict(precision="bf16"), "item 6h"),
    (dict(precision="split2m", metric_dtype=torch.bfloat16), "item 6h"),
    (dict(precision="split2m", n_q=4, n_components=1), "item 6g"),
    (dict(precision="split2m", n_q=3, n_components=3), "item 6g"),
    (dict(precision="split2m", n_q=4, n_components=3, block=True),
     "item 6h"),
    (dict(precision="split2m", n_q=4, n_components=1, block=True),
     "item 6g")], ids=["split3", "bf16", "bf16-metric", "bp3", "q=p+1",
                       "block", "bp3-block"])
def test_what_f64_still_refuses(kw, label):
    """At f64 split3 and bf16, the bf16 metric (``check_config``), and
    split2m at BP3 or q = p + 1 and on a block (``check_shape``) raise
    NotImplementedError naming their ROADMAP item, while split2m at BP4's
    shape on one device passes both."""
    laplace_cuda.check_config("split2m", "dense", "precomputed", "adjj",
                              F64, "reshape", "merged", 2)
    assert laplace_cuda.check_shape(2, 4, 3, "split2m", F64) == 0
    kw = dict(kw)
    shape = {k: kw.pop(k) for k in ("n_q", "n_components", "block")
             if k in kw}
    with pytest.raises(NotImplementedError, match=label):
        if shape:
            laplace_cuda.check_shape(2, **{"n_q": 4, "n_components": 3,
                                           **shape}, dtype=F64, **kw)
        else:
            laplace_cuda.check_config(kw.pop("precision"), "dense",
                                      "precomputed", "adjj", F64,
                                      "reshape", "merged", 2, **kw)


def test_rank_builders_refuse_f64_split2m():
    """The ranks' builders (``parallel/distributed.py``: B2's block form,
    B5/B6 on a block) refuse split2m at f64 at build time, naming 6h."""
    from mf_data_locality_tpu_torch.parallel import distributed

    with pytest.raises(NotImplementedError, match="item 6h"):
        distributed.build_slab(3, 2, 0, 2, F64, precision="split2m",
                               device="cpu")
    with pytest.raises(NotImplementedError, match="item 6h"):
        distributed.build_block(3, 2, (0, 0), (2, 2), F64,
                                precision="split2m", device="cpu")
