"""PyTorch port: ``ops/mass.py``, the CEED BP1/BP2 mass operator, against
the JAX package's ``ops.mass``.

Same inputs, made from a seed with numpy, f64 on the CPU: ``apply_cells``
and ``vmult`` within 1e-12 of the JAX ones relative to their largest
entry, for one component (BP1) and three (BP2), through
``make_mass_operator`` and through the JAX operator's arrays carried
across (``from_jax_arrays``); ``detw`` equal to JAX's to 1e-15 relative; q =
p + 1; an L-shaped general mesh; the total measure 1^T M 1 = 2^(s mod 3);
and positive definiteness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.mesh import general as jgeneral
from mf_data_locality_tpu.mesh.box import BoxMesh as JBoxMesh
from mf_data_locality_tpu.mesh.dofs import DofLayout as JDofLayout
from mf_data_locality_tpu.ops import mass as jmass
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.mesh.general import macro_hex_layout
from mf_data_locality_tpu_torch.ops import lagrange, mass

TOL = 1e-12
POINTS = [(1, 1), (3, 2), (0, 3)]  # (s, p) of tests/test_mass.py
japply = jax.jit(jmass.apply_cells)
jvmult = jax.jit(jmass.vmult)


def _ops(s, p, n_q=None):
    op = mass.make_mass_operator(DofLayout(BoxMesh.from_s(s), p), n_q,
                                 torch.float64, "cpu")
    jop = jmass.make_mass_operator(JDofLayout(JBoxMesh.from_s(s), p), n_q,
                                   jnp.float64)
    return op, jop


def _check(op, jop, n_comp: int, seed: int = 0) -> None:
    """apply_cells and vmult of one seeded vector against the JAX ones."""
    n = op.unconstrained.shape[0]
    u = np.random.default_rng(seed).normal(size=(n_comp, n))
    for fn, jfn in ((mass.apply_cells, japply), (mass.vmult, jvmult)):
        got = fn(op, torch.as_tensor(u)).numpy()
        want = np.asarray(jfn(jop, jnp.asarray(u)))
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("n_comp", [1, 3], ids=["BP1", "BP2"])
@pytest.mark.parametrize("s,p", POINTS)
def test_mass_matches_jax(s, p, n_comp):
    op, jop = _ops(s, p)
    np.testing.assert_allclose(op.detw.numpy(), np.asarray(jop.detw),
                               rtol=1e-15, atol=0)
    np.testing.assert_array_equal(op.values.numpy(), np.asarray(jop.values))
    np.testing.assert_array_equal(op.gather.numpy(), np.asarray(jop.gather))
    _check(op, jop, n_comp)


@pytest.mark.parametrize("s,p", POINTS)
def test_from_jax_arrays(s, p):
    """The JAX operator's arrays carried across give the port's own
    operator's results (BP1 and BP2), at the arrays' dtype."""
    own, jop = _ops(s, p)
    op = mass.from_jax_arrays(*(np.asarray(a) for a in jop), device="cpu")
    assert op.detw.dtype == torch.float64 and op.degree == p
    for n_comp in (1, 3):
        u = torch.as_tensor(np.random.default_rng(1).normal(
            size=(n_comp, own.unconstrained.shape[0])))
        torch.testing.assert_close(mass.vmult(op, u), mass.vmult(own, u),
                                   rtol=0, atol=0)
    _check(op, jop, 3)


def test_mass_q_p1():
    """deal.II's Gauss rule q = p + 1."""
    op, jop = _ops(3, 2, n_q=3)
    assert op.n_q == 3 and op.detw.shape == (8, 27)
    _check(op, jop, 3)


def test_mass_on_general_mesh():
    """The L-shaped general mesh of tests/test_general_mesh.py (unwarped):
    the port's operator against JAX's, and its measure, 5 unit cells."""
    cells = np.array([(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                      (1, 0, 0)])
    op = mass.make_mass_operator(macro_hex_layout(cells, 2), None,
                                 torch.float64, "cpu")
    jop = jmass.make_mass_operator(jgeneral.macro_hex_layout(cells, 2),
                                   dtype=jnp.float64)
    _check(op, jop, 3)
    ones = torch.ones((1, op.unconstrained.shape[0]), dtype=torch.float64)
    assert abs(mass.apply_cells(op, ones).sum().item() - 5.0) < 1e-12


def test_mass_matches_dense():
    """Against the independent dense assembly of tests/test_mass.py."""
    layout = DofLayout(BoxMesh.from_s(3), 2)
    op = mass.make_mass_operator(layout, None, torch.float64, "cpu")
    V = lagrange.make_shape(2, 4).values
    phi = np.einsum("ck,bj,ai->kjicba", V, V, V).reshape(27, 64)
    M_loc = np.einsum("aq,nq,bq->nab", phi, op.detw.numpy(), phi)
    M = np.zeros((layout.n_nodes, layout.n_nodes))
    for c, idx in enumerate(layout.gather_map):
        M[np.ix_(idx, idx)] += M_loc[c]
    u = np.random.default_rng(0).normal(size=(3, layout.n_nodes))
    got = mass.apply_cells(op, torch.as_tensor(u)).numpy()
    want = u @ M.T
    assert np.abs(got - want).max() < TOL * np.abs(want).max()


def test_mass_total_measure():
    """1^T M 1 = the volume of the deformed domain, 2^(s mod 3) = 2 at
    s=4, as the JAX package's."""
    layout = DofLayout(BoxMesh.from_s(4), 2)
    op = mass.make_mass_operator(layout, None, torch.float64, "cpu")
    ones = torch.ones((1, layout.n_nodes), dtype=torch.float64)
    assert np.isclose(mass.apply_cells(op, ones).sum().item(), 2.0,
                      atol=1e-12)


def test_mass_spd():
    layout = DofLayout(BoxMesh.from_s(2), 2)
    op = mass.make_mass_operator(layout, None, torch.float64, "cpu")
    rng = np.random.default_rng(1)
    for _ in range(3):
        u = torch.as_tensor(rng.normal(size=(1, layout.n_nodes)))
        assert torch.vdot(u.reshape(-1),
                          mass.apply_cells(op, u).reshape(-1)).item() > 0
        v = torch.as_tensor(rng.normal(size=(1, layout.n_nodes)))
        a = torch.vdot(v.reshape(-1), mass.vmult(op, u).reshape(-1))
        b = torch.vdot(u.reshape(-1), mass.vmult(op, v).reshape(-1))
        assert abs(a - b).item() < 1e-13 * abs(a).item()
