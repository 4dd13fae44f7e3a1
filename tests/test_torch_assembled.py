"""PyTorch port: the plain versions of the operator against the assembled
stiffness matrix, on tiny meshes in f64.

The reference is the JAX package's ``laplace.assemble_dense``: the scalar
stiffness block by straightforward quadrature assembly, not
sum-factorized and not matrix-free, an implementation independent of both
packages' operators; the vector operator applies it per component.  The
port's plain versions — B1's ``cg_fused_kernel._matvec_plain`` (dense and
twostage), B3's ``laplace_apply._batched_plain`` on the cell batches, B5's
and B6's ``_lattice_plain`` and the full ``vmult`` — run under
``highest`` in f64 on random inputs made with numpy from a seed, and agree
with it to 1e-11 of the result's largest entry (sums of ~1e3 terms in
another order; the metric is the host's in f64, or rebuilt from the
coefficients in f64).
"""

import numpy as np
import pytest
import torch

from mf_data_locality_tpu.mesh.box import BoxMesh as JBoxMesh
from mf_data_locality_tpu.mesh.dofs import DofLayout as JDofLayout
from mf_data_locality_tpu.ops import laplace
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la

S = 3  # 8 cells (2 x 2 x 2)
TOL = 1e-11
KINDS = ("matvec_dense", "matvec_twostage", "batched", "lattice",
         "vmult")


def _assembled(p: int, constraints: bool) -> np.ndarray:
    return laplace.assemble_dense(JDofLayout(JBoxMesh.from_s(S), p),
                                  apply_constraints=constraints)


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p", [1, 2, 3])
def test_plain_versions_match_assembled_matrix(p, kind):
    """Each plain version against K (``assemble_dense``), per component:
    B1 h = M A M d with M the Dirichlet mask (K without constraints, masked
    both sides), in the dense and the twostage factorization with the
    metric rebuilt; B3 through the cell batches, unmasked (K without
    constraints); B5 / B6 on the lattice with the index mask and the mask
    tensor; ``vmult`` with the constrained identity (K with constraints:
    identity rows and columns at the boundary)."""
    factor, metric, windowing = {
        "matvec_dense": ("dense", "precomputed", "pieces"),
        "matvec_twostage": ("twostage", "onthefly", "pieces"),
        "batched": ("dense", "precomputed", "reshape"),
        "lattice": ("dense", "precomputed", "zslab"),
        "vmult": ("dense", "precomputed", "reshape")}[kind]
    op = bp4.build(S, p, torch.float64, "highest", factor=factor,
                   metric=metric, windowing=windowing, device="cpu").op
    lat = (3,) + op.n_nodes_axis
    rng = np.random.default_rng(60 + p)
    u = rng.standard_normal(lat)
    ut = torch.as_tensor(u)
    flat = u.reshape(3, -1)
    mask = op.mask.numpy().reshape(-1)
    K = _assembled(p, constraints=kind == "vmult")
    masked = K * mask[:, None] * mask[None, :]
    if kind.startswith("matvec"):
        got, want = fk._matvec_plain(op, ut), flat @ masked.T
    elif kind == "batched":
        u_loc = la.to_cell_batches(ut, p).contiguous()
        v = la._batched_plain(op, u_loc, la._metric(op), True)
        got, want = la.from_cell_batches(v, p, op.n_cells_axis), flat @ K.T
    elif kind == "lattice":
        got = torch.stack([la._lattice_plain(op, ut, la._index_mask(op)),
                           la._lattice_plain(op, ut, op.mask)])
        want = np.stack([flat @ masked.T] * 2)
    else:
        got, want = la.vmult(op, ut), flat @ K.T
    assert _rel(got.reshape(want.shape), want) < TOL
