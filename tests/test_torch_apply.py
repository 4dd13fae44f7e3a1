"""PyTorch port: the apply family (plain versions of B3-B6, the windowing and
``vmult``) against the JAX package's ``laplace_pallas``.

The JAX side runs on the CPU as the package's own tests run it: its Pallas
kernels in interpret mode, f64 (x64 is on) for "highest" and f32 for the
f32 rungs (ROADMAP C3).  Inputs are made with numpy from a seed.
Tolerances (max |diff| / max |ref|): 1e-12 in f64; 1e-5 in f32 "highest"
and "split2m", for another accumulation order.  The windowing is compared
bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.ops import laplace_pallas as jlp
from mf_data_locality_tpu.ops import laplace_structured as jls
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.ops import laplace_cuda

RUNGS = {"f64": (jnp.float64, torch.float64, "highest", 1e-12),
         "f32": (jnp.float32, torch.float32, "highest", 1e-5),
         "split2m": (jnp.float32, torch.float32, "split2m", 1e-5)}
# (windowing, metric): B3, B4, B5, B6
CONFIGS = [("reshape", "precomputed"), ("reshape", "onthefly"),
           ("pieces", "precomputed"), ("zslab", "precomputed")]


def _problems(s, p, rung, windowing, metric):
    jd, td, precision, tol = RUNGS[rung]
    jp = jbp4.build(s, p, dtype=jd, backend="pallas", precision=precision,
                    windowing=windowing, factor="dense", metric=metric)
    tp = bp4.build(s, p, td, precision, factor="dense", metric=metric,
                   windowing=windowing, device="cpu")
    return jp, tp, np.dtype(jd), tol


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("p,s", [(2, 4), (4, 3)])
@pytest.mark.parametrize("windowing,metric", CONFIGS)
@pytest.mark.parametrize("rung", list(RUNGS))
def test_vmult_matches_jax(p, s, windowing, metric, rung):
    """``vmult`` with and without the constrained identity: B3 (reshape,
    precomputed), B4 (reshape, onthefly), B5 (pieces), B6 (zslab)."""
    jp, tp, nd, tol = _problems(s, p, rung, windowing, metric)
    rng = np.random.default_rng(p * 10 + s)
    u = rng.standard_normal((3,) + jp.layout.n_nodes_axis).astype(nd)
    for ci in (True, False):
        ref = np.asarray(jlp.vmult(jp.op, jnp.asarray(u),
                                   constrained_identity=ci))
        got = la.vmult(tp.op, torch.as_tensor(u),
                       constrained_identity=ci).numpy()
        assert _rel(got, ref) < tol


@pytest.mark.parametrize("p,s", [(2, 4), (4, 3)])
@pytest.mark.parametrize("metric", ["precomputed", "onthefly"])
def test_apply_local_batched_matches_jax(p, s, metric):
    """The cell-batch apply alone (B3, B4) on random cell batches, f64."""
    jp, tp, nd, tol = _problems(s, p, "f64", "reshape", metric)
    nc = tp.op.n_cells
    rng = np.random.default_rng(7)
    u = rng.standard_normal((3 * (p + 1) ** 3, nc))
    u_pad = np.zeros((u.shape[0], jp.op.coeffs.shape[2]))
    u_pad[:, :nc] = u
    ref = np.asarray(jlp.apply_local_batched(jp.op, jnp.asarray(u_pad)))
    got = la.apply_local_batched(tp.op, torch.as_tensor(u)).numpy()
    assert _rel(got, ref[:, :nc]) < tol


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_mma_tables_unpack_to_bf16_mats(p):
    """The split2m kernel's packed M: both fragment orders unpack to
    ``op.mats`` rounded to bf16, bit for bit, and every pad entry is 0."""
    op = bp4.build(1, p, torch.float32, "split2m", factor="dense",
                   metric="precomputed", windowing="reshape",
                   device="cpu").op
    q3, p13 = (p + 2) ** 3, (p + 1) ** 3
    q3p, p13p = laplace_cuda.mma_dims(p)
    assert q3p % 16 == 0 and p13p % 16 == 0
    assert op.mma_mats.dtype == torch.bfloat16
    assert tuple(op.mma_mats.shape) == (2, 3 * q3p * p13p)
    want = op.mats.to(torch.bfloat16).reshape(3, q3, p13).view(torch.int16)
    for m in laplace_cuda.unpack_mma_tables(op.mma_mats, p):
        m = m.reshape(3, q3p, p13p).view(torch.int16).clone()
        assert torch.equal(m[:, :q3, :p13], want)
        m[:, :q3, :p13] = 0
        assert not m.any()
    highest = bp4.build(1, p, torch.float32, "highest", factor="dense",
                        metric="precomputed", windowing="reshape",
                        device="cpu").op
    assert highest.mma_mats is None


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_mma_emulation_matches_jax_split2m(p):
    """The split2m kernel's arithmetic (padded, K-stacked bf16 products,
    f32 accumulation, t split after the metric apply) against JAX's
    ``apply_local_batched`` at ``precision="split2m"``, f32 interpret
    mode: 1e-5, the f32 class of sums of <= 1,296 exact products."""
    s = 3
    jp, tp, nd, tol = _problems(s, p, "split2m", "reshape", "precomputed")
    nc = tp.op.n_cells
    rng = np.random.default_rng(20 + p)
    u = rng.standard_normal((3 * (p + 1) ** 3, nc)).astype(nd)
    u_pad = np.zeros((u.shape[0], jp.op.coeffs.shape[2]), nd)
    u_pad[:, :nc] = u
    ref = np.asarray(jlp.apply_local_batched(jp.op, jnp.asarray(u_pad)))
    got = la._batched_mma_emulated(tp.op, torch.as_tensor(u),
                                   la._metric(tp.op)).numpy()
    assert _rel(got, ref[:, :nc]) < tol


@pytest.mark.parametrize("metric", ["precomputed", "onthefly"])
@pytest.mark.parametrize("rung", ["f64", "f32"])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_sumfac_emulation_matches_jax_highest(p, rung, metric):
    """The ``highest`` kernel's sum-factorized arithmetic (1D contractions
    with S and D in the kernel's order) against JAX's dense
    ``apply_local_batched`` at ``precision="highest"``, interpret mode, with
    the streamed metric (B3, ``_kernel_g``) or the metric rebuilt from the
    coefficients (B4, ``_kernel``): 1e-12 in f64, 1e-5 in f32 against the
    JAX f32 run (another order of the sums, and S S D against the rounded
    dense entry)."""
    s = 3
    jp, tp, nd, tol = _problems(s, p, rung, "reshape", metric)
    nc = tp.op.n_cells
    rng = np.random.default_rng(30 + p)
    u = rng.standard_normal((3 * (p + 1) ** 3, nc)).astype(nd)
    u_pad = np.zeros((u.shape[0], jp.op.coeffs.shape[2]), nd)
    u_pad[:, :nc] = u
    ref = np.asarray(jlp.apply_local_batched(jp.op, jnp.asarray(u_pad)))
    got = la._batched_sumfac_emulated(tp.op, torch.as_tensor(u),
                                      la._metric(tp.op)).numpy()
    assert _rel(got, ref[:, :nc]) < tol


@pytest.mark.parametrize("factor", ["dense", "twostage"])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_sumfac_factors_reproduce_dense_mats(p, factor):
    """What the sum-factorized pass relies on: kron(S, S, D), kron(S, D, S)
    and kron(D, S, S) of ``op.sz`` (S) and ``op.dz`` (D) are ``op.mats``'
    M_x, M_y and M_z (``factor="dense"``, B3-B6), and kron(S, D), kron(D,
    S) and kron(S, S) are ``op.mats2d``'s Dx2d, Dy2d and S2d (twostage,
    B1/B2), within f32 rounding, for an operator from ``build`` and one
    converted from the JAX package's arrays (pieces windowing, so the
    converter undoes the piece column order)."""
    s = 3
    metric = "precomputed" if factor == "dense" else "onthefly"
    jp = jbp4.build(s, p, dtype=jnp.float32, backend="pallas",
                    precision="highest", windowing="pieces", factor=factor,
                    metric=metric)
    jop = jp.op
    name = "mats" if factor == "dense" else "mats2d"
    conv = bp4.from_jax_arrays(
        s, p, **{name: np.asarray(getattr(jop, name))},
        gmetric=None if jop.gmetric is None else np.asarray(jop.gmetric),
        pds=np.asarray(jop.pds), w3=np.asarray(jop.w3),
        coeffs=np.asarray(jop.coeffs), mask=np.asarray(jop.mask),
        b=np.asarray(jp.b), inv_diag=np.asarray(jp.inv_diag),
        factor=factor, windowing="pieces", precision="highest",
        dtype=torch.float32, device="cpu")
    own = bp4.build(s, p, torch.float32, "highest", factor=factor,
                    metric=metric, windowing="pieces", device="cpu")
    eps = torch.finfo(torch.float32).eps
    for op in (own.op, conv.op):
        S, D = op.sz.double(), op.dz.double()

        def kron(*m):
            out = m[0]
            for a in m[1:]:
                out = torch.kron(out, a)
            return out

        if factor == "dense":
            want = torch.cat([kron(S, S, D), kron(S, D, S), kron(D, S, S)])
            shape = (3 * (p + 2) ** 3, (p + 1) ** 3)
        else:
            want = torch.cat([kron(S, D), kron(D, S), kron(S, S)])
            shape = (3 * (p + 2) ** 2, (p + 1) ** 2)
        got = getattr(op, name).double()
        assert got.shape == want.shape == shape
        assert (got - want).abs().max() <= 4 * eps * got.abs().max()


def test_onthefly_apply_ignores_precision():
    """B4 is exact at the working dtype on every rung, as ``_kernel``."""
    s, p = 3, 2
    ops = [bp4.build(s, p, torch.float32, prec, factor="dense",
                     metric="onthefly", windowing="reshape",
                     device="cpu").op
           for prec in ("highest", "split2m")]
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (3 * (p + 1) ** 3, ops[0].n_cells)).astype(np.float32))
    np.testing.assert_array_equal(
        la.apply_local_batched(ops[0], u).numpy(),
        la.apply_local_batched(ops[1], u).numpy())


@pytest.mark.parametrize("p", [1, 2, 4])
def test_windowing_matches_jax_bitwise(p):
    rng = np.random.default_rng(p)
    shape = (3, 2 * p + 1, 3 * p + 1, 4 * p + 1)
    u = rng.standard_normal(shape)
    ref = np.asarray(jlp._to_cell_batches(jnp.asarray(u), p, 24))
    got = la.to_cell_batches(torch.as_tensor(u), p).numpy()
    np.testing.assert_array_equal(got, ref)
    v = rng.standard_normal(got.shape)
    ref = np.asarray(jlp._from_cell_batches(jnp.asarray(v), p, (2, 3, 4)))
    got = la.from_cell_batches(torch.as_tensor(v), p, (2, 3, 4)).numpy()
    np.testing.assert_array_equal(got, ref)
    for axis in (1, 2, 3):
        ref = np.asarray(jls.cellify_t(jnp.asarray(u), axis, p))
        got = la.cellify_t(torch.as_tensor(u), axis, p)
        np.testing.assert_array_equal(got.numpy(), ref)
        back = np.asarray(jls.overlap_add_t(jnp.asarray(ref), axis, p))
        np.testing.assert_array_equal(
            la.overlap_add_t(got, axis, p).numpy(), back)


@pytest.mark.parametrize("windowing", ["reshape", "pieces", "zslab"])
def test_operator_from_jax_arrays(windowing):
    """The converter undoes the cell padding and the piece permutation: the
    JAX operator's arrays give the port's own build."""
    s, p = 3, 4
    jp, tp, _, _ = _problems(s, p, "f64", windowing, "precomputed")
    jop = jp.op
    conv = bp4.from_jax_arrays(
        s, p, mats=np.asarray(jop.mats), gmetric=np.asarray(jop.gmetric),
        pds=np.asarray(jop.pds), w3=np.asarray(jop.w3),
        coeffs=np.asarray(jop.coeffs), mask=np.asarray(jop.mask),
        b=np.asarray(jp.b), inv_diag=np.asarray(jp.inv_diag),
        factor="dense", windowing=windowing, precision="highest",
        dtype=torch.float64, device="cpu")
    for name in ("mats", "gmetric", "pds", "w3", "coeffs", "mask",
                 "kcoeffs"):
        np.testing.assert_allclose(getattr(conv.op, name).numpy(),
                                   getattr(tp.op, name).numpy(), rtol=0,
                                   atol=1e-15, err_msg=name)
    assert conv.op.windowing == windowing
    np.testing.assert_array_equal(conv.b.numpy(), tp.b.numpy())


def test_lattice_applies_are_symmetric_and_masked():
    s, p = 3, 2
    op = bp4.build(s, p, torch.float64, "highest", factor="dense",
                   metric="precomputed", windowing="zslab", device="cpu").op
    rng = np.random.default_rng(3)
    u, v = (torch.as_tensor(rng.standard_normal((3,) + op.n_nodes_axis))
            for _ in range(2))
    for fn in (la.apply_lattice_pieces, la.apply_lattice_zslab):
        au, av = fn(op, u), fn(op, v)
        a, b = torch.sum(v * au).item(), torch.sum(u * av).item()
        assert abs(a - b) <= 1e-12 * abs(a)
        assert torch.all(au[:, 0] == 0) and torch.all(au[..., -1] == 0)


def test_wrappers_use_plain_versions_on_cpu():
    """CPU tensors run the plain versions and count no kernel launch."""
    op = bp4.build(3, 2, torch.float64, "highest", factor="dense",
                   metric="precomputed", windowing="reshape", device="cpu").op
    u = torch.zeros((3,) + op.n_nodes_axis, dtype=torch.float64)
    u_loc = la.to_cell_batches(u, 2)
    wrappers = (la.apply_local_batched_g, la.apply_local_batched_onthefly,
                la.apply_lattice_pieces, la.apply_lattice_zslab)
    before = [w.launches for w in wrappers]
    la.apply_local_batched_g(op, u_loc)
    la.apply_local_batched_onthefly(op, u_loc)
    la.apply_lattice_pieces(op, u)
    la.apply_lattice_zslab(op, u)
    assert [w.launches for w in wrappers] == before
    meta = torch.empty(u.shape, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="meta"):
        la.apply_lattice_zslab(op, meta)


def test_apply_configurations_checked():
    for kw, err in (({"windowing": "matmul"}, NotImplementedError),
                    ({"windowing": "zslab", "metric": "onthefly"},
                     ValueError),
                    ({"solver": "fused", "windowing": "reshape"}, ValueError),
                    ({"solver": "merged", "factor": "twostage",
                      "metric": "onthefly", "windowing": "pieces"},
                     NotImplementedError)):
        args = {"factor": "dense", "metric": "precomputed",
                "windowing": "reshape", **kw}
        with pytest.raises(err):
            laplace_cuda.check_config("highest", dtype=torch.float64,
                                      **args)
    laplace_cuda.check_config("highest", "dense", "onthefly", "adjj",
                              torch.float64, "reshape", "baseline")
