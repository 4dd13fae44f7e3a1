"""PyTorch port: the operator apply (plain version of the matvec kernel)
against the JAX package's ``piece_vmult``.

The JAX side runs its Pallas kernel in interpret mode on the CPU, f64 for
"highest" and f32 for "split2m", on a random boundary-zero lattice vector
taken to and from the piece state with the package's own
``to_piece_state`` / ``from_piece_state``.  Tolerances: 1e-12 relative in
f64; 1e-5 relative max-norm in f32 split2m, for another accumulation order
and the Jacobian evaluated in exact f32 here (split3 bf16 products there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.ops import cg_fused_kernel as jfk
from mf_data_locality_tpu.ops import laplace_pallas as jlp
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_cuda

P = 4
# the fused solver's configuration (B1, B2)
FUSED = dict(factor="twostage", metric="onthefly", windowing="pieces")


def _jax_matvec(s, u, dtype, precision):
    jp = jbp4.build(s, P, dtype=dtype, backend="pallas", precision=precision,
                    windowing="pieces", factor="twostage", metric="onthefly",
                    cofactor="adjj")
    lat = jp.layout.n_nodes_axis
    ncx = (lat[2] - 1) // P
    dpc = jfk.to_piece_state(jnp.asarray(u), P)[:, :, :P * P]
    h, _ = jfk.piece_vmult(jp.op, lat, dpc, jfk.zplanes_init(dpc, P),
                           compact=True)
    return np.asarray(jfk.from_piece_state(jfk._expand_mm(h, P, ncx), P, lat))


def _random_state(s, dtype, seed):
    pb = bp4.build(s, P, dtype=torch.float64, precision="highest",
                   device="cpu", **FUSED)
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((3,) + pb.layout.n_nodes_axis)
    return (u * pb.op.mask.numpy()).astype(dtype)


@pytest.mark.parametrize("s,dtype,tdtype,precision,tol", [
    (4, np.float64, torch.float64, "highest", 1e-12),
    (5, np.float64, torch.float64, "highest", 1e-12),
    (4, np.float32, torch.float32, "split2m", 1e-5)])
def test_matvec_matches_piece_vmult(s, dtype, tdtype, precision, tol):
    u = _random_state(s, dtype, seed=s)
    ref = _jax_matvec(s, u, jnp.dtype(dtype), precision)
    op = bp4.build(s, P, dtype=tdtype, precision=precision, device="cpu",
                   **FUSED).op
    got = fk.matvec(op, torch.as_tensor(u)).numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < tol, err


def test_metric_matches_host_metric():
    """The on-the-fly metric rebuild (f64) equals the JAX package's host
    f64 metric ``laplace_pallas._metric_entries``."""
    s = 4
    op = bp4.build(s, P, dtype=torch.float64, precision="highest",
                   device="cpu", **FUSED).op
    q = P + 2
    ref = jlp.metric_for_coeffs(op.coeffs.numpy(), P, q)  # (6 q^3, nc)
    got = fk.metric_onthefly(op).permute(0, 2, 1).reshape(6 * q ** 3, -1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13,
                               atol=1e-15 * np.abs(ref).max())


def test_matvec_is_symmetric_and_masked():
    s = 3
    op = bp4.build(s, P, dtype=torch.float64, precision="highest",
                   device="cpu", **FUSED).op
    u, v = (torch.as_tensor(_random_state(s, np.float64, seed))
            for seed in (1, 2))
    au, av = fk.matvec(op, u), fk.matvec(op, v)
    a, b = torch.sum(v * au).item(), torch.sum(u * av).item()
    assert abs(a - b) <= 1e-12 * abs(a)
    assert torch.all(au[:, 0] == 0) and torch.all(au[..., -1] == 0)


def test_matvec_cpu_uses_plain_version():
    """On CPU tensors the wrapper runs the plain version and counts no
    kernel launch; an ``out`` buffer receives the result."""
    op = bp4.build(3, P, dtype=torch.float64, precision="highest",
                   device="cpu", **FUSED).op
    u = torch.as_tensor(_random_state(3, np.float64, seed=4))
    before = fk.matvec.launches
    out = torch.empty_like(u)
    res = fk.matvec(op, u, out=out)
    assert res is out
    assert fk.matvec.launches == before
    np.testing.assert_array_equal(out.numpy(), fk._matvec_plain(op, u).numpy())


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_mma_tables_2d_unpack_to_bf16_mats2d(p):
    """The fused path's split2m tables: both fragment orders unpack to
    ``op.mats2d`` in bf16, bit for bit, every pad entry is 0, and the
    rounding to bf16 is exact (``mats2d`` is already bf16-valued)."""
    op = bp4.build(1, p, torch.float32, "split2m", device="cpu", **FUSED).op
    q2, p12 = (p + 2) ** 2, (p + 1) ** 2
    q2p, p12p = laplace_cuda.mma_dims(p, "twostage")
    assert q2p % 16 == 0 and p12p % 16 == 0
    assert q2p - q2 < 16 and p12p - p12 < 16
    assert op.mma_mats.dtype == torch.bfloat16
    assert tuple(op.mma_mats.shape) == (2, 3 * q2p * p12p)
    bf = op.mats2d.to(torch.bfloat16)
    assert torch.equal(bf.to(torch.float32), op.mats2d)
    want = bf.reshape(3, q2, p12).view(torch.int16)
    for m in laplace_cuda.unpack_mma_tables(op.mma_mats, p, "twostage"):
        m = m.reshape(3, q2p, p12p).view(torch.int16).clone()
        assert torch.equal(m[:, :q2, :p12], want)
        m[:, :q2, :p12] = 0
        assert not m.any()
    assert bp4.build(1, p, torch.float32, "highest", device="cpu",
                     **FUSED).op.mma_mats is None


@pytest.mark.parametrize("s", [3, 5])
def test_cell_mma_emulation_matches_piece_vmult(s):
    """The split2m tensor-core cell pass's arithmetic (padded bf16 tables,
    hi/lo parts of the f32 z stage, f32 accumulation, t split after the
    metric apply) against JAX's ``piece_vmult`` under split2m in interpret
    mode, and against the plain cell pass: 1e-5 relative, the f32 class
    (s=3: 8 cells, one ragged 16-cell tile)."""
    u = _random_state(s, np.float32, seed=30 + s)
    ref = _jax_matvec(s, u, jnp.float32, "split2m")
    op = bp4.build(s, P, dtype=torch.float32, precision="split2m",
                   device="cpu", **FUSED).op
    ut = torch.as_tensor(u) * op.mask
    cells = fk._cell_apply_mma_emulated(op, ut)
    got = (fk._assemble(op, cells) * op.mask).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
    plain = fk._cell_apply(op, ut)
    assert ((cells - plain).abs().max() / plain.abs().max()).item() < 1e-5


@pytest.mark.parametrize("dtype,tdtype,tol", [
    (np.float64, torch.float64, 1e-12), (np.float32, torch.float32, 1e-5)])
@pytest.mark.parametrize("s", [3, 5])
def test_sumfac_emulation_matches_piece_vmult(s, dtype, tdtype, tol):
    """The ``highest`` cell pass of B1/B2 (``csrc/apply_sumfac.cuh``: x, y,
    z passes with S and D, the metric rebuilt) against JAX's
    ``piece_vmult`` under ``highest`` (twostage) in interpret mode, f64 and
    f32: the same function summed in another order, within 1e-12 (f64)
    and 1e-5 (f32, where the JAX Jacobian is split3 bf16 products)."""
    u = _random_state(s, dtype, seed=50 + s)
    ref = _jax_matvec(s, u, jnp.dtype(dtype), "highest")
    op = bp4.build(s, P, dtype=tdtype, precision="highest", device="cpu",
                   **FUSED).op
    got = fk._matvec_plain(op, torch.as_tensor(u),
                           fk._cell_apply_sumfac_emulated).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < tol
