"""Operator data for the BP4 kernels (counterpart of ``laplace_pallas.make_pallas_operator``).

The slice's configuration only: the two-stage factorization (z direction
contracted by 1D factors, then a dense 2D stage), geometry rebuilt per
quadrature point from 24 trilinear coefficients per cell ("onthefly"),
and the adjugate-of-J inversion chain ("adjj").  The arrays are kept in
canonical order — the port works on the lattice ``(C, Nz, Ny, Nx)``, not on
the TPU's corner-piece rows, so no column permutation is applied to the
2D matrices.

Arrays (working dtype ``T``, f32 or f64, all on ``device``):

* ``mats2d`` (3 q^2, (p+1)^2): ``[Dx2d; Dy2d; S2d]``, rows (qy, qx) and
  columns (ky, kx), x fastest (``laplace_pallas._dense_gradient_matrices_2d``),
  as the kernels consume them: for the ``split2m`` rung rounded to bf16 once
  here (``cg_fused_kernel._prestack``), held in the working dtype.
* ``sz``, ``dz`` (q, p+1): the 1D z factors (``laplace_pallas._z_matrices``).
* ``pds`` (3 q^3, 8): derivatives of the trilinear monomials at the tensor
  quadrature points; ``w3`` (q^3, 1) the tensor weights.
* ``coeffs`` (3, 8, n_cells): trilinear coefficients, cell-minor.
* ``mask`` (1, Nz, Ny, Nx): 1 at free nodes, 0 at Dirichlet nodes.

``kpds`` (q^3, 24) and ``kcoeffs`` (n_cells, 24) are the same data in the
layouts the kernels read (one contiguous row per q-point / per cell).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mf_data_locality_tpu_torch import PRECISIONS
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout, boundary_node_mask
from mf_data_locality_tpu_torch.ops import geometry, lagrange

_TODO = ("not ported yet: see ROADMAP.md, queue B (remaining B1/B2 "
         "configurations)")


def dense_gradient_matrices_2d(p: int, q: int) -> np.ndarray:
    """[Dx2d; Dy2d; S2d] stacked (3 q^2, (p+1)^2), canonical (ky, kx) columns."""
    shape = lagrange.make_shape(p, q)
    S, Sg = shape.values, shape.grads

    def t2(ay, ax):
        out = np.einsum("bj,ai->baji", ay, ax)
        return np.ascontiguousarray(out.reshape(q * q, (p + 1) * (p + 1)))

    return np.concatenate([t2(S, Sg), t2(Sg, S), t2(S, S)], axis=0)


def z_matrices(p: int, q: int) -> tuple[np.ndarray, np.ndarray]:
    """(S_z, D_z) of shape (q, p+1): the 1D z-direction factors."""
    shape = lagrange.make_shape(p, q)
    return np.asarray(shape.values), np.asarray(shape.grads)


def monomial_derivative_matrices(q_points: np.ndarray) -> np.ndarray:
    """[P_du; P_dv; P_dw] stacked (3 q^3, 8): derivatives of the trilinear
    monomials [1, u, v, uv, w, uw, vw, uvw] at every tensor q-point
    (rows (qz, qy, qx), x fastest)."""
    qp = q_points
    n = qp.size
    w, v, u = np.meshgrid(qp, qp, qp, indexing="ij")
    u, v, w = u.reshape(-1), v.reshape(-1), w.reshape(-1)
    zero = np.zeros(n**3)
    one = np.ones(n**3)
    pdu = np.stack([zero, one, zero, v, zero, w, zero, v * w], axis=1)
    pdv = np.stack([zero, zero, one, u, zero, zero, w, u * w], axis=1)
    pdw = np.stack([zero, zero, zero, zero, one, u, v, u * v], axis=1)
    return np.concatenate([pdu, pdv, pdw], axis=0)


def tensor_weights(p: int, q: int) -> np.ndarray:
    """(q^3, 1) tensor-product Gauss weights, rows (qz, qy, qx)."""
    w = lagrange.make_shape(p, q).q_weights
    return (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(-1, 1)


@dataclass(frozen=True)
class OperatorData:
    mats2d: torch.Tensor
    sz: torch.Tensor
    dz: torch.Tensor
    pds: torch.Tensor
    w3: torch.Tensor
    coeffs: torch.Tensor
    mask: torch.Tensor
    kpds: torch.Tensor
    kcoeffs: torch.Tensor
    degree: int
    n_q: int
    n_cells_axis: tuple[int, int, int]
    precision: str

    @property
    def dtype(self) -> torch.dtype:
        return self.mats2d.dtype

    @property
    def device(self) -> torch.device:
        return self.mats2d.device

    @property
    def n_cells(self) -> int:
        ncz, ncy, ncx = self.n_cells_axis
        return ncz * ncy * ncx

    @property
    def n_nodes_axis(self) -> tuple[int, int, int]:
        return tuple(self.mask.shape[1:])


def check_config(precision: str, factor: str = "twostage",
                 metric: str = "onthefly", cofactor: str = "adjj",
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise NotImplementedError for a configuration the port lacks."""
    if precision not in PRECISIONS:
        raise NotImplementedError(f"precision={precision!r} is {_TODO}")
    if (factor, metric, cofactor) != ("twostage", "onthefly", "adjj"):
        raise NotImplementedError(
            f"factor={factor!r}, metric={metric!r}, cofactor={cofactor!r} "
            f"is {_TODO}; the port has twostage + onthefly + adjj")
    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"dtype={dtype} is {_TODO}")
    if precision == "split2m" and dtype != torch.float32:
        raise NotImplementedError(
            f"precision='split2m' with dtype={dtype} is {_TODO}")


def operator_from_arrays(mats2d: np.ndarray, pds: np.ndarray, w3: np.ndarray,
                         coeffs: np.ndarray, mask: np.ndarray, degree: int,
                         n_cells_axis: tuple[int, int, int], precision: str,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cpu") -> OperatorData:
    """Wrap host arrays (any float dtype) as an :class:`OperatorData`.

    Values are rounded to ``dtype`` first and, for ``split2m``, from there to
    bf16 — the same two roundings the JAX package applies.
    """
    check_config(precision, dtype=dtype)
    p = degree
    q = p + 2

    def t(a):
        return torch.tensor(np.asarray(a)).to(device=device, dtype=dtype)

    m2 = t(mats2d)
    if precision == "split2m":
        m2 = m2.to(torch.bfloat16).to(dtype)
    sz, dz = z_matrices(p, q)
    pds_t = t(pds)
    co = t(coeffs)
    nc = co.shape[-1]
    return OperatorData(
        mats2d=m2, sz=t(sz), dz=t(dz), pds=pds_t, w3=t(w3),
        coeffs=co, mask=t(mask),
        kpds=pds_t.reshape(3, q**3, 8).permute(1, 0, 2).reshape(q**3, 24)
        .contiguous(),
        kcoeffs=co.reshape(24, nc).t().contiguous(),
        degree=p, n_q=q, n_cells_axis=tuple(n_cells_axis),
        precision=precision)


def make_operator(layout: DofLayout, dtype: torch.dtype = torch.float32,
                  precision: str = "split2m", factor: str = "twostage",
                  metric: str = "onthefly", cofactor: str = "adjj",
                  device: torch.device | str = "cpu") -> OperatorData:
    """Build the operator data for ``layout`` (q = p + 2 Gauss points)."""
    check_config(precision, factor, metric, cofactor, dtype)
    p = layout.degree
    q = p + 2
    shape = lagrange.make_shape(p, q)
    coeffs = geometry.trilinear_coefficients(layout.mesh.cell_vertices)
    nz, ny, nx = layout.n_nodes_axis
    mask = (~boundary_node_mask((nz, ny, nx))).reshape(1, nz, ny, nx)
    return operator_from_arrays(
        dense_gradient_matrices_2d(p, q),
        monomial_derivative_matrices(shape.q_points), tensor_weights(p, q),
        coeffs.transpose(2, 1, 0), mask.astype(np.float64), p,
        layout.mesh.n_cells_axis, precision, dtype, device)
