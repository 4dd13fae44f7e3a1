"""PyTorch port at the shapes beyond BP4's: CEED BP3 (one component) and
the Gauss rule q = p + 1 (queue B item 6g), the apply family B3-B6 against
the JAX package's Pallas kernels.

The JAX side is ``bp4.build(..., backend="pallas", n_components=,
n_q=)``, its kernels in interpret mode on the CPU, f64 (x64 on), or f32
for split2m; the port's pallas-backend operator runs its plain versions
and the kernels' arithmetic (``laplace_apply._batched_sumfac_emulated``,
the highest pass; ``_batched_mma_emulated``, the split2m tensor-core
pass).  Inputs are made with numpy from a seed.  Tolerances (max |diff| /
max |ref|): 1e-12 in f64, 1e-5 in f32 split2m (ROADMAP C3).  ``vmult``
at p=5 is ``slow`` (its JAX interpret runs, ~25 s).  The kernels
themselves run on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py`` section 11).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.ops import laplace_pallas as jlp
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.ops import laplace_cuda

DEGREES = (1, 2, 4, 5)
# (components, q - p): BP3, BP4 with q = p + 1, both
SHAPES = {"bp3": (1, 2), "q1": (3, 1), "bp3_q1": (1, 1)}
# (windowing, metric): B3, B4, B5, B6
CONFIGS = {"B3": ("reshape", "precomputed"), "B4": ("reshape", "onthefly"),
           "B5": ("pieces", "precomputed"), "B6": ("zslab", "precomputed")}
S = {1: 3, 2: 3, 4: 2, 5: 2}  # 2^s cells: 8 at p <= 2, 4 from p=4
TOL = {"highest": 1e-12, "split2m": 1e-5}


@functools.lru_cache(maxsize=None)
def _problems(p, shape, windowing, metric, precision="highest"):
    c, dq = SHAPES[shape]
    jd, td = ((jnp.float64, torch.float64) if precision == "highest"
              else (jnp.float32, torch.float32))
    kw = dict(n_components=c, n_q=p + dq)
    jp = jbp4.build(S[p], p, dtype=jd, backend="pallas", precision=precision,
                    windowing=windowing, factor="dense", metric=metric, **kw)
    tp = bp4.build(S[p], p, td, precision, factor="dense", metric=metric,
                   windowing=windowing, device="cpu", **kw)
    return jp, tp


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("kernel", list(CONFIGS))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize(
    "p", [1, 2, 4, pytest.param(5, marks=pytest.mark.slow)])
def test_vmult_matches_jax(p, shape, kernel):
    """``vmult`` (with and without the constrained identity) through B3,
    B4, B5 or B6 at each shape, f64."""
    jp, tp = _problems(p, shape, *CONFIGS[kernel])
    assert tp.n_components == jp.n_components
    assert tp.n_q == round(jp.op.w3.size ** (1 / 3))
    c = tp.n_components
    rng = np.random.default_rng(10 * p + c)
    u = rng.standard_normal((c,) + jp.layout.n_nodes_axis)
    for ci in (True, False):
        ref = jlp.vmult(jp.op, jnp.asarray(u), constrained_identity=ci)
        got = la.vmult(tp.op, torch.as_tensor(u), constrained_identity=ci)
        assert _rel(got.numpy(), ref) < TOL["highest"]


@pytest.mark.parametrize("metric", ["precomputed", "onthefly"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("p", DEGREES)
def test_sumfac_emulation_matches_jax(p, shape, metric):
    """The sum-factorized pass's arithmetic (the highest cell pass of
    B3/B4, and of B5/B6/B1/B2 on the lattice) on random cell batches
    against ``apply_local_batched``, f64: the plain version too."""
    jp, tp = _problems(p, shape, "reshape", metric)
    op, nc = tp.op, tp.op.n_cells
    u = np.random.default_rng(7 + p).standard_normal(
        (tp.n_components * (p + 1) ** 3, nc))
    u_pad = np.zeros((u.shape[0], jp.op.coeffs.shape[2]))
    u_pad[:, :nc] = u
    ref = np.asarray(jlp.apply_local_batched(jp.op, jnp.asarray(u_pad)))
    ref = ref[:, :nc]
    ut = torch.as_tensor(u)
    got = la._batched_sumfac_emulated(op, ut, la._metric(op))
    assert _rel(got.numpy(), ref) < TOL["highest"]
    assert _rel(la.apply_local_batched(op, ut).numpy(), ref) < TOL["highest"]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_mma_emulation_matches_jax_split2m(shape):
    """B3 dense under f32 split2m at p=2: the tensor-core pass's arithmetic
    (its packed bf16 tables at q, the K-stacked products) against the JAX
    kernel's split2m apply."""
    p = 2
    jp, tp = _problems(p, shape, "reshape", "precomputed", "split2m")
    op, nc = tp.op, tp.op.n_cells
    u = np.random.default_rng(3).standard_normal(
        (tp.n_components * (p + 1) ** 3, nc)).astype(np.float32)
    u_pad = np.zeros((u.shape[0], jp.op.coeffs.shape[2]), np.float32)
    u_pad[:, :nc] = u
    ref = np.asarray(jlp.apply_local_batched(jp.op, jnp.asarray(u_pad)))
    ref = ref[:, :nc]
    ut = torch.as_tensor(u)
    got = la._batched_mma_emulated(op, ut, la._metric(op))
    assert _rel(got.numpy(), ref) < TOL["split2m"]
    assert _rel(la.apply_local_batched(op, ut).numpy(), ref) < TOL["split2m"]


@pytest.mark.parametrize("factor", ["dense", "twostage"])
@pytest.mark.parametrize("dq", [1, 2])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_mma_tables_take_q(p, dq, factor):
    """The tensor-core tables at q Gauss points: both fragment orders
    unpack to the matrices of q rounded to bf16, and the pad is zero."""
    q = p + dq
    op = bp4.build(2, p, torch.float32, "split2m", factor=factor,
                   windowing="pieces", device="cpu", n_q=q).op
    mats = op.mats if factor == "dense" else op.mats2d
    rows, cols = laplace_cuda._mma_block(p, factor, q)
    rp, cp = laplace_cuda.mma_dims(p, factor, q)
    want = mats.to(torch.bfloat16).reshape(3, rows, cols)
    for m in laplace_cuda.unpack_mma_tables(op.mma_mats, p, factor, 0, q):
        m = m.reshape(3, rp, cp) if m.shape[0] == 3 * rp else (
            m.t().reshape(3, rp, cp))
        assert torch.equal(m[:, :rows, :cols], want)
        assert not m[:, rows:].any() and not m[:, :, cols:].any()


def test_operator_takes_q_from_the_jax_arrays():
    """``from_jax_arrays`` reads q from the JAX operator's arrays (w3's
    q^3 weights): a q = p + 1 operator of the JAX package, carried across,
    applies as the port's own."""
    p = 2
    jp, tp = _problems(p, "q1", "reshape", "precomputed")
    op = jp.op
    got = bp4.from_jax_arrays(
        S[p], p, pds=np.asarray(op.pds), w3=np.asarray(op.w3),
        coeffs=np.asarray(op.coeffs), mask=np.asarray(op.mask),
        b=np.asarray(jp.b), inv_diag=np.asarray(jp.inv_diag),
        gmetric=np.asarray(op.gmetric), factor="dense",
        windowing="reshape", precision="highest", dtype=torch.float64,
        device="cpu")
    assert got.op.n_q == p + 1 and got.n_components == 3
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (3,) + tp.layout.n_nodes_axis))
    assert _rel(la.vmult(got.op, u).numpy(),
                la.vmult(tp.op, u).numpy()) < TOL["highest"]
