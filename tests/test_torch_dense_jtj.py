"""PyTorch port: the tensor-core rungs' dense pass with the metric rebuilt
by the jtj chain (B1, B2; ``--factor dense --geometry onthefly --cofactor
jtj`` under split2m, split3 and bf16) against the JAX package.

The JAX side is ``bp4.build(..., backend="pallas", windowing="pieces",
factor="dense", metric="onthefly", cofactor="jtj")``, its Pallas kernels
in interpret mode on the CPU; the helpers and the tolerances are
``test_torch_reduced_rungs.py``'s (split2m and split3 1e-5 of the vectors'
max, the scalars 1e-4 relative; bf16 relative L2 5e-4 and max 1e-2, the
control refused).  The port runs its plain versions and the tensor-core
kernels' arithmetic (``_cell_apply_mma_emulated`` through
``laplace_apply._batched_mma_emulated``, which takes the metric of the
operator's chain).  p=2 and 4 are ``csrc/apply_mma.cuh``'s, p=5
``csrc/apply_mma_hd.cuh``'s.  The fast cases are every degree under
split2m and one degree of each other rung; the rest are ``slow``.  The
card compares every degree 1..5, 8 and 11 in ``chip_smoke.py`` (section
10).  A file of its own so that it runs on its own test worker.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_cuda
from test_torch_reduced_rungs import (CELL_APPLY, TOL,
                                      check_matvec_and_iteration)

RUNGS = laplace_cuda.TENSOR_RUNGS
FAST = {("split2m", 2), ("split2m", 4), ("split2m", 5), ("split3", 4),
        ("bf16", 2)}
CASES = [pytest.param(p, rung, ca, marks=(
    [] if (rung, p) in FAST else [pytest.mark.slow]))
    for p in (2, 4, 5) for rung in RUNGS for ca in CELL_APPLY]


@pytest.mark.parametrize("p,rung,cell_apply", CASES)
def test_dense_jtj_matvec_and_iteration_match_jax(p, rung, cell_apply):
    """B1 against ``piece_vmult`` and B2 against ``fused_cg_iteration``
    (``check_matvec_and_iteration``) in dense + onthefly + jtj, a
    configuration the port's fused solver runs, the operator keeping the
    chain."""
    laplace_cuda.check_config(rung, "dense", "onthefly", "jtj",
                              torch.float32, "pieces", "fused", p)
    check_matvec_and_iteration("dense", "onthefly", "jtj", p, rung,
                               cell_apply)


@pytest.mark.parametrize("p", [2, 5])
def test_jtj_equals_adjj_only_where_orientation_holds(p):
    """The control of the jtj comparisons: they cannot tell jtj from adjj
    on the BP4 mesh, where the JAX package's own
    ``test_cofactor_jtj_piece_vmult_matches_adjj`` has the two chains one
    metric (f64, 1e-12), so the port's plain B1 by either chain agrees to
    1e-12 in f64 there and, under split2m, the two chains' B1 within the
    comparisons' 1e-5.  Where det J < 0 (x reflected) jtj scales by |det
    J| and adjj by det J: the two B1 differ by the whole result, and the
    port refuses jtj on such a mesh (``check_orientation``, ROADMAP C1)."""
    u = None
    for dtype, rung, tol in ((torch.float64, "highest", 1e-12),
                             (torch.float32, "split2m", TOL)):
        ops = {c: bp4.build(3, p, dtype, rung, factor="dense",
                            metric="onthefly", cofactor=c,
                            windowing="pieces", device="cpu").op
               for c in ("adjj", "jtj")}
        if u is None:
            rng = np.random.default_rng(40 + p)
            u = rng.standard_normal((3,) + ops["adjj"].n_nodes_axis)
        d = torch.as_tensor(u, dtype=dtype) * ops["adjj"].mask
        va, vj = (fk._matvec_plain(ops[c], d, fk._cell_apply_mma_emulated
                                   if rung != "highest" else fk._cell_apply)
                  for c in ("adjj", "jtj"))
        assert (va - vj).abs().max() / va.abs().max() < tol
    op = ops["jtj"]
    flipped = op.coeffs.clone()
    flipped[0] *= -1.0  # x -> -x: det J < 0 at every q-point
    with pytest.raises(ValueError, match="det J"):
        laplace_cuda.check_orientation(op.pds.numpy(), flipped.numpy())
    va, vj = (fk._matvec_plain(dataclasses.replace(op, coeffs=flipped,
                                                   cofactor=c), d)
              for c in ("adjj", "jtj"))
    assert (va + vj).abs().max() / va.abs().max() < 1e-4
    assert (va - vj).abs().max() / va.abs().max() > 1.0


def test_from_jax_arrays_dense_jtj():
    """The JAX dense + onthefly + jtj operator under split2m carried across
    by ``from_jax_arrays`` (its dense M, in the TPU's piece column order,
    and the coefficients) is the port's own build, the chain kept: the
    same fragment tables bit for bit, the same coefficients."""
    p = 4
    jp = jbp4.build(1, p, dtype=jnp.float32, backend="pallas",
                    precision="split2m", windowing="pieces", factor="dense",
                    metric="onthefly", cofactor="jtj")
    jop = jp.op
    conv = bp4.from_jax_arrays(
        1, p, mats=np.asarray(jop.mats), pds=np.asarray(jop.pds),
        w3=np.asarray(jop.w3), coeffs=np.asarray(jop.coeffs),
        mask=np.asarray(jop.mask), b=np.asarray(jp.b),
        inv_diag=np.asarray(jp.inv_diag), factor="dense", cofactor="jtj",
        precision="split2m", dtype=torch.float32, device="cpu").op
    own = bp4.build(1, p, torch.float32, "split2m", factor="dense",
                    metric="onthefly", cofactor="jtj", windowing="pieces",
                    device="cpu").op
    assert (conv.factor, conv.metric, conv.cofactor) == ("dense", "onthefly",
                                                         "jtj")
    assert torch.equal(conv.mma_mats.view(torch.int16),
                       own.mma_mats.view(torch.int16))
    np.testing.assert_allclose(conv.coeffs.numpy(), own.coeffs.numpy(),
                               rtol=1e-6, atol=1e-7)
