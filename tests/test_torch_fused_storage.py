"""PyTorch port: the fused solver with the preconditioner or x stored in
bf16 (``prec_dtype``, ``x_dtype``) against the JAX package.

The JAX side runs on the CPU with x64 on, its Pallas kernels in interpret
mode (``tests/test_cg_fused.py:215,332``); the port runs its plain
iteration (``cg_fused_kernel._fused_iteration_plain``: P and x upcast where
they are read, x' rounded where it is stored).  Same problem (dense
factorization, streamed metric, ``pieces``), f64: the iteration counts
are identical, the residual histories agree within 1e-12 of the initial
residual and the solutions within 1e-12 of their largest entry (both sum
in another order).  x feeds none of the g, d, h recurrences, so with x in
bf16 the history equals the f32-x (f64-x) run's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.solvers import cg_fused as jcg_fused
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.solvers import cg_fused

BF = torch.bfloat16
STORAGE = {"prec": (dict(prec_dtype=jnp.bfloat16), dict(prec_dtype=BF)),
           "x": (dict(x_dtype=jnp.bfloat16), dict(x_dtype=BF)),
           "both": (dict(prec_dtype=jnp.bfloat16, x_dtype=jnp.bfloat16),
                    dict(prec_dtype=BF, x_dtype=BF))}


def _port(s, p, dtype=torch.float64):
    tp = bp4.build(s, p, dtype, "highest", factor="dense",
                   metric="precomputed", windowing="pieces", device="cpu")
    lat = tp.layout.n_nodes_axis
    return (tp.op, lat, tp.b.reshape((3,) + lat),
            tp.inv_diag.reshape((1,) + lat))


@pytest.mark.parametrize("storage", ["prec", "x", "both"])
@pytest.mark.parametrize("s,p", [(6, 2), (6, 3)])
def test_fused_storage_matches_jax(s, p, storage):
    jkw, tkw = STORAGE[storage]
    jp = jbp4.build(s, p, dtype=jnp.float64, backend="pallas",
                    windowing="pieces")
    lat = jp.layout.n_nodes_axis
    ref = jcg_fused.fused_merged_cg_solve(
        jp.op, lat, jp.b.reshape((3,) + lat),
        jp.inv_diag.reshape((1,) + lat), **jkw)
    res = cg_fused.fused_merged_cg_solve(*_port(s, p), **tkw)
    n = int(ref.n_iterations)
    assert res.n_iterations == n and res.converged == bool(ref.converged)
    hr = np.asarray(ref.res_history)[:n + 1]
    np.testing.assert_allclose(res.res_history.numpy()[:n + 1], hr, rtol=0,
                               atol=1e-12 * hr[0])
    xr = np.asarray(ref.x)
    assert res.x.dtype == torch.float64
    np.testing.assert_allclose(res.x.numpy(), xr, rtol=0,
                               atol=1e-12 * np.abs(xr).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_x_bf16_history_equals_working_x(dtype):
    """The iteration path does not see x: bitwise the same history and
    count; the delivered x within bf16's rounding of the working-x one."""
    args = _port(6, 2, dtype)
    ref = cg_fused.fused_merged_cg_solve(*args)
    res = cg_fused.fused_merged_cg_solve(*args, x_dtype=BF)
    n = ref.n_iterations
    assert res.n_iterations == n
    assert torch.equal(res.res_history[:n + 1], ref.res_history[:n + 1])
    assert ((res.x - ref.x).abs().max() <= 2e-2 * ref.x.abs().max()).item()


def test_prec_bf16_changes_the_history():
    """bf16 P is a ~0.4% Jacobi perturbation: another history (the
    storage takes effect), the count within 3 (test_cg_fused.py:332)."""
    args = _port(6, 3)
    ref = cg_fused.fused_merged_cg_solve(*args)
    res = cg_fused.fused_merged_cg_solve(*args, prec_dtype=BF)
    n = min(ref.n_iterations, res.n_iterations)
    assert abs(res.n_iterations - ref.n_iterations) <= 3
    assert not torch.equal(res.res_history[1:n], ref.res_history[1:n])


def test_plain_iteration_rounding_points():
    """One plain iteration with bf16 P and x: P upcast where it is read,
    x' the working-dtype update rounded once; g', d', h' and the scalars
    those of the working-dtype iteration on the rounded P."""
    op, lat, b, prec = _port(4, 2)
    gen = torch.Generator().manual_seed(3)
    x, g, d, h = [(torch.randn((3,) + lat, generator=gen,
                               dtype=torch.float64) * op.mask)
                  for _ in range(4)]
    scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6],
                        dtype=torch.float64)
    pb, xb = prec.to(BF), x.to(BF)
    got = fk._fused_iteration_plain(op, xb, g, d, h, scal, pb)
    want = fk._fused_iteration_plain(op, xb.double(), g, d, h, scal,
                                     pb.double())
    assert got[0].dtype == BF and torch.equal(got[0], want[0].to(BF))
    for a, w in zip(got[1:], want[1:]):
        assert a.dtype == torch.float64 and torch.equal(a, w)


def test_storage_dtypes_refused():
    args = _port(3, 2)
    with pytest.raises(ValueError, match="prec_dtype"):
        cg_fused.fused_merged_cg_solve(*args, prec_dtype=torch.float16)
    with pytest.raises(ValueError, match="x_dtype"):
        cg_fused.fused_merged_cg_solve(*args, x_dtype=torch.float32)
