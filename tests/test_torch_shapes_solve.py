"""PyTorch port at the shapes beyond BP4's: CEED BP3 (one component) and
the Gauss rule q = p + 1 (queue B item 6g) — the slice's whole f64 solves
against the JAX package's.

The merged solver on the JAX CLI's default operator (reshape: B3's plain
version) and the fused solver (its auto configuration: B1/B2's plain
versions) at the parity points, beside the JAX package's ``solve_merged``
and ``fused_merged_cg_solve`` (their Pallas kernels in interpret mode on
the CPU, f64): itCG equal to the JAX package's (BP3 93 at p=4 s=7 and 50
at p=2 s=9; q = p + 1 91 and 49), the residual history within 1e-10 of
res0 at p=2 s=9 and within 1e-8 of res0 at p=4 s=7, where CG amplifies
the two summation orders' difference to 1.4e-9 of res0 by its last
iterations (the tolerance of the BP4 fused solves,
``tests/test_torch_fused_cg.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.solvers import cg_fused as jcg_fused
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.solvers import cg_fused

SHAPES = {"bp3": (1, 2), "q1": (3, 1)}
# the parity points: (p, s, {shape: the JAX package's f64 itCG})
PARITY = ((4, 7, {"bp3": 93, "q1": 91}), (2, 9, {"bp3": 50, "q1": 49}))


def _history_tol(p):
    return 1e-8 if p == 4 else 1e-10


@pytest.mark.parametrize("solver", ["merged", "fused"])
@pytest.mark.parametrize("shape", ["bp3", "q1"])
@pytest.mark.parametrize("p,s,counts", PARITY)
def test_solve_f64_matches_jax(p, s, counts, shape, solver):
    """The slice's f64 solves at the parity points: the merged solver on
    the JAX CLI's default operator (reshape: B3) and the fused solver (its
    auto configuration) give the JAX package's itCG and residual
    history."""
    c, dq = SHAPES[shape]
    kw = dict(n_components=c, n_q=p + dq)
    if solver == "merged":
        jp = jbp4.build(s, p, dtype=jnp.float64, backend="pallas", **kw)
        tp = bp4.build(s, p, torch.float64, device="cpu", **kw)
        ref, res = jbp4.solve_merged(jp), bp4.solve_merged(tp)
    else:  # the auto configuration at p <= 4: dense + streamed
        kw.update(windowing="pieces", factor="dense", metric="precomputed")
        jp = jbp4.build(s, p, dtype=jnp.float64, backend="pallas", **kw)
        tp = bp4.build(s, p, torch.float64, device="cpu", **kw)
        lat = jp.layout.n_nodes_axis
        ref = jcg_fused.fused_merged_cg_solve(
            jp.op, lat, jp.b.reshape((c,) + lat),
            jp.inv_diag.reshape((1,) + lat))
        res = cg_fused.fused_merged_cg_solve(
            tp.op, lat, tp.b.reshape((c,) + lat),
            tp.inv_diag.reshape((1,) + lat))
    n = int(ref.n_iterations)
    assert n == counts[shape]
    assert res.n_iterations == n and res.converged == bool(ref.converged)
    hr = np.asarray(ref.res_history)[:n + 1]
    np.testing.assert_allclose(res.res_history.numpy()[:n + 1], hr, rtol=0,
                               atol=_history_tol(p) * hr[0])
