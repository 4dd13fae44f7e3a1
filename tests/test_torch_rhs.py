"""PyTorch port: the manufactured right-hand side, the L2 error and the
discretization's convergence rate.

``assemble_rhs`` and ``l2_error`` (f64 NumPy on the host in both
packages) against the JAX ones: within 1e-12 relative.  Then the port's
own end to end check, as ``tests/test_convergence.py``: -Laplace(u) = f
with u = sin(pi x) sin(pi y) sin(pi z) on the undeformed unit cube (affine
cells, so the clean rate shows), solved in f64 by the merged CG on the
general backend; the observed L2 rate between h = 1/2 and 1/4 must reach
(p + 1) - 0.35.
"""

import numpy as np
import pytest
import torch

from mf_data_locality_tpu.mesh.box import BoxMesh as JBoxMesh
from mf_data_locality_tpu.mesh.dofs import DofLayout as JDofLayout
from mf_data_locality_tpu.ops import rhs as jrhs
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import (diagonal, laplace,
                                            laplace_structured, rhs)
from mf_data_locality_tpu_torch.solvers import cg_merged


def u_exact(x):
    return (np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])
            * np.sin(np.pi * x[..., 2]))[..., None]


def f_source(x):
    return 3 * np.pi ** 2 * u_exact(x)


def u_exact3(x):
    return np.concatenate([u_exact(x), 2 * u_exact(x), -u_exact(x)], -1)


@pytest.mark.parametrize("deformed", [True, False])
@pytest.mark.parametrize("p,s,n_q", [(1, 4, None), (2, 3, None), (3, 2, 6)])
@pytest.mark.parametrize("f", [f_source, u_exact3])
def test_rhs_and_l2_error_match_jax(f, p, s, n_q, deformed):
    lay = DofLayout(BoxMesh.from_s(s, deformed=deformed), p)
    jlay = JDofLayout(JBoxMesh.from_s(s, deformed=deformed), p)
    for ac in (True, False):
        got = rhs.assemble_rhs(lay, f, n_q=n_q, apply_constraints=ac)
        want = jrhs.assemble_rhs(jlay, f, n_q=n_q, apply_constraints=ac)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    u = np.random.default_rng(p).standard_normal(got.shape)
    e = rhs.l2_error(lay, torch.tensor(u), f, n_q=n_q)
    assert abs(e - jrhs.l2_error(jlay, u, f, n_q=n_q)) <= 1e-12 * e


def test_rhs_constant_source_integral():
    """Partition of unity: with f = 1 the unconstrained load sums to the
    volume, 1."""
    lay = DofLayout(BoxMesh.from_s(3, deformed=False), 2)
    b = rhs.assemble_rhs(lay, lambda x: np.ones(x.shape[:-1] + (1,)),
                         apply_constraints=False)
    assert np.isclose(b.sum(), 1.0, atol=1e-12)


def _solve(s, p):
    layout = DofLayout(BoxMesh.from_s(s, deformed=False), p)
    op = laplace.make_operator(layout, dtype=torch.float64, device="cpu")
    b = torch.tensor(rhs.assemble_rhs(layout, f_source))
    prec = torch.tensor(diagonal.compute_inverse_diagonal(layout))[None, :]
    # rel_tol above the merged CG's residual-estimate floor (~sqrt(eps)
    # res0; at p=1 the load is nearly an eigenvector and one step
    # converges: ROADMAP.md queue C item C9)
    res = cg_merged.merged_cg_solve(
        lambda u: laplace.vmult(op, u, constrained_identity=False), b, prec,
        max_iter=400, rel_tol=1e-7)
    assert res.converged
    return layout, res.x


@pytest.mark.parametrize("p", [1, 2])
def test_l2_convergence_rate_general_backend(p):
    errors = [rhs.l2_error(*_solve(s, p), u_exact) for s in (3, 6)]
    rate = np.log2(errors[0] / errors[1])
    assert rate > (p + 1) - 0.35, (errors, rate)


def test_structured_backend_takes_the_manufactured_rhs():
    """The structured operator solves the same discrete problem: its
    solution of the manufactured load equals the general backend's."""
    layout, x = _solve(3, 2)
    op = laplace_structured.make_structured_operator(
        layout, dtype=torch.float64, device="cpu")
    lat = (1,) + layout.n_nodes_axis
    b = torch.tensor(rhs.assemble_rhs(layout, f_source))
    prec = torch.tensor(diagonal.compute_inverse_diagonal(layout))[None, :]
    res = cg_merged.merged_cg_solve(
        lambda u: laplace_structured.vmult(
            op, u.reshape(lat), constrained_identity=False).reshape(u.shape),
        b, prec, max_iter=400, rel_tol=1e-7)
    assert res.converged
    assert ((res.x - x).abs().max() <= 1e-9 * x.abs().max()).item()
