"""Operator data for the BP4 kernels (counterpart of ``laplace_pallas.make_pallas_operator``).

Two families of configurations, named by (factor, metric, windowing):

* the fused path (``solvers/cg_fused``, kernels B1/B2) on ``"pieces"``, at
  degrees 1..4 (:func:`fused_configs`): the dense factorization or
  twostage (the z direction contracted by 1D factors, then a dense 2D
  stage), with the metric streamed (``"precomputed"``) or rebuilt per
  quadrature point from 24 trilinear coefficients per cell
  (``"onthefly"``, the adjugate inversion chain "adjj") — every pair under
  ``highest``; under ``split2m`` the dense pair and twostage + onthefly at
  p=4;
* the apply family (``ops/laplace_apply``, kernels B3-B6, used by the merged
  and baseline solvers): the dense factorization with the metric streamed
  (``metric="precomputed"``, any of the windowings ``reshape``, ``pieces``,
  ``zslab``) or rebuilt per q-point (``metric="onthefly"``, ``reshape``).

The arrays are kept in canonical order — the port works on the lattice
``(C, Nz, Ny, Nx)``, not on the TPU's corner-piece rows — so no column
permutation, no cell padding and no windowed mask are held.

Arrays (working dtype ``T``, f32 or f64, all on ``device``):

* ``mats2d`` (3 q^2, (p+1)^2): ``[Dx2d; Dy2d; S2d]``, rows (qy, qx) and
  columns (ky, kx), x fastest (``laplace_pallas._dense_gradient_matrices_2d``),
  as the fused path's plain version applies them: for the ``split2m`` rung
  rounded to bf16 once here (``cg_fused_kernel._prestack``), held in the
  working dtype (its kernel reads them as ``mma_mats``).
* ``sz``, ``dz`` (q, p+1): the 1D factors S and D
  (``laplace_pallas._z_matrices``): twostage's z factors, and every
  direction's in the sum-factorized ``highest`` kernels.
* ``mats`` (3 q^3, (p+1)^3): ``[M_x; M_y; M_z]``, the dense gradient
  matrices (``laplace_pallas._dense_gradient_matrices``), unrounded: the
  plain versions round them at the product for ``split2m``, as ``_mm``
  does, the split2m kernels read ``mma_mats`` (rounded once), and the
  on-the-fly apply (B4) is exact on every rung; the ``highest`` kernels
  apply their factors ``sz`` and ``dz`` instead.
* ``gmetric`` (6 q^3, n_cells) or None: the metric entries (00, 01, 02, 11,
  12, 22) per q-point, computed on the host in f64 and rounded to ``T``
  once (``metric="precomputed"``).
* ``pds`` (3 q^3, 8): derivatives of the trilinear monomials at the tensor
  quadrature points; ``w3`` (q^3, 1) the tensor weights.
* ``coeffs`` (3, 8, n_cells): trilinear coefficients, cell-minor (the
  JAX layout; the sum-factorized passes read it, the cell fastest).
* ``mask`` (1, Nz, Ny, Nx): 1 at free nodes, 0 at Dirichlet nodes.

``kpds`` (q^3, 24) and ``kcoeffs`` (n_cells, 24) are the same data with one
contiguous row per q-point / per cell: the kernels read ``kpds``, and the
twostage split2m tensor-core pass of B1/B2 ``kcoeffs``.  ``mma_mats``
(``split2m`` only) is the matrix of the tensor-core cell pass rounded once
to bf16 and packed as its fragments (:func:`mma_tables`): ``mats`` for the
dense factorization (the apply family, and the fused path's dense
configurations), ``mats2d`` for twostage.  ``factor`` records which.
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

WINDOWINGS = ("reshape", "pieces", "zslab")
FUSED_DEGREES = (1, 2, 3, 4)  # degrees of the fused solver's kernels
# (factor, metric, windowing) of the apply family
APPLY_CONFIGS = (("dense", "precomputed", "reshape"),
                 ("dense", "precomputed", "pieces"),
                 ("dense", "precomputed", "zslab"),
                 ("dense", "onthefly", "reshape"))


def dense_gradient_matrices(p: int, q: int) -> np.ndarray:
    """[M_x; M_y; M_z] stacked (3 q^3, (p+1)^3): rows (qz, qy, qx) and
    columns (kz, ky, kx), x fastest."""
    shape = lagrange.make_shape(p, q)
    S, Sg = shape.values, shape.grads

    def t3(az, ay, ax):
        out = np.einsum("ck,bj,ai->cbakji", az, ay, ax)
        return out.reshape(q ** 3, (p + 1) ** 3)

    return np.ascontiguousarray(
        np.concatenate([t3(S, S, Sg), t3(S, Sg, S), t3(Sg, S, S)], axis=0))


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


def metric_entries(coeffs: np.ndarray, q_points: np.ndarray,
                   w3: np.ndarray) -> np.ndarray:
    """G = det(J) w J^{-1} J^{-T} at every q-point, on the host in f64
    (``laplace_pallas._metric_entries``, its NumPy branch).

    ``coeffs``: (n_cells, 8, 3).  Returns the 6 unique entries (00, 01, 02,
    11, 12, 22) stacked as rows: (6 q^3, n_cells).
    """
    qp = q_points
    w, v, u = np.meshgrid(qp, qp, qp, indexing="ij")
    uvw = np.stack([u.reshape(-1), v.reshape(-1), w.reshape(-1)], axis=-1)
    jac = geometry.jacobian(np.asarray(coeffs, np.float64)[:, None, :, :],
                            uvw[None, :, :])
    inv, det = geometry.invert_3x3(jac)  # (nc, q^3, 3, 3), (nc, q^3)
    g = np.einsum("cqed,cqfd->cqef", inv, inv) * (det * w3.reshape(1, -1))[
        ..., None, None]
    entries = [g[..., 0, 0], g[..., 0, 1], g[..., 0, 2],
               g[..., 1, 1], g[..., 1, 2], g[..., 2, 2]]
    return np.concatenate([e.T for e in entries], axis=0)


@dataclass(frozen=True)
class OperatorData:
    mats2d: torch.Tensor
    sz: torch.Tensor
    dz: torch.Tensor
    mats: torch.Tensor
    gmetric: torch.Tensor | None
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
    windowing: str = "pieces"
    factor: str = "dense"
    mma_mats: torch.Tensor | None = None

    @property
    def dtype(self) -> torch.dtype:
        return self.w3.dtype

    @property
    def metric(self) -> str:
        return "onthefly" if self.gmetric is None else "precomputed"

    @property
    def device(self) -> torch.device:
        return self.w3.device

    @property
    def n_cells(self) -> int:
        ncz, ncy, ncx = self.n_cells_axis
        return ncz * ncy * ncx

    @property
    def n_nodes_axis(self) -> tuple[int, int, int]:
        return tuple(self.mask.shape[1:])


def _mma_block(p: int, factor: str) -> tuple[int, int]:
    """(rows, columns) of one direction's block of the matrix the
    tensor-core pass of ``factor`` reads: the dense (q^3, (p+1)^3) or the
    2D stage's (q^2, (p+1)^2)."""
    if factor == "dense":
        return (p + 2) ** 3, (p + 1) ** 3
    if factor == "twostage":
        return (p + 2) ** 2, (p + 1) ** 2
    raise ValueError(f"no tensor-core tables for factor={factor!r}")


def mma_dims(p: int, factor: str = "dense") -> tuple[int, int]:
    """(q-points per direction, nodes) of degree ``p``, each padded to a
    multiple of 16: the tensor-core tiles of ``csrc/apply_mma.cuh``
    (``factor="dense"``) or of the 2D stage in ``csrc/cell_mma.cuh``
    (``"twostage"``: q^2 and (p+1)^2)."""
    return tuple(-(-n // 16) * 16 for n in _mma_block(p, factor))


def _fragments(b: torch.Tensor) -> torch.Tensor:
    """(K, N) B operand -> its mma.m16n8k16 fragments, flat: fragment (n8
    tile, k16 step), lane = 4 row group + column pair, then the lane's four
    values (rows 2 t, 2 t + 1, 2 t + 8, 2 t + 9 of the k16 step)."""
    k, n = b.shape
    t = b.reshape(k // 16, 2, 4, 2, n // 8, 8)  # (ks, half, t, e, nt, g)
    return t.permute(4, 0, 5, 2, 1, 3).reshape(-1)


def _from_fragments(f: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Inverse of :func:`_fragments`."""
    t = f.reshape(n // 8, k // 16, 8, 4, 2, 2)  # (nt, ks, g, t, half, e)
    return t.permute(1, 4, 3, 5, 0, 2).reshape(k, n)


def mma_tables(mats: torch.Tensor, p: int,
               factor: str = "dense") -> torch.Tensor:
    """The split2m tensor-core pass's matrix: ``mats`` ((3 q^3, (p+1)^3)
    dense, or the (3 q^2, (p+1)^2) 2D stage for ``factor="twostage"``)
    rounded once to bf16, each direction's block zero-padded to (RP, CP)
    (:func:`mma_dims`), packed as fragments: row 0 for the forward product
    (B = Mh^T), row 1 for the backward (B = Mh).  Shape (2, 3 RP CP),
    bf16."""
    rows, cols = _mma_block(p, factor)
    rp, cp = mma_dims(p, factor)
    mh = mats.new_zeros((3, rp, cp), dtype=torch.bfloat16)
    mh[:, :rows, :cols] = mats.reshape(3, rows, cols)
    mh = mh.reshape(3 * rp, cp)
    return torch.stack([_fragments(mh.t()), _fragments(mh)])


def unpack_mma_tables(tables: torch.Tensor, p: int, factor: str = "dense"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The padded (3 RP, CP) bf16 matrices the two rows of
    :func:`mma_tables` hold: (forward's, backward's)."""
    rp, cp = mma_dims(p, factor)
    return (_from_fragments(tables[0], cp, 3 * rp).t(),
            _from_fragments(tables[1], 3 * rp, cp))


def fused_configs(precision: str,
                  degree: int | None = None) -> tuple[tuple[str, str], ...]:
    """The (factor, metric) pairs the fused solver runs on (windowing
    ``"pieces"``) at ``degree`` (None: at any of its degrees).  Under
    ``highest`` the dense and twostage operators are one function, which
    one sum-factorized pass computes with the metric streamed or rebuilt;
    under ``split2m`` each factorization's rounding defines the rung, and
    its tensor-core passes are the dense one (either metric) and
    twostage + onthefly at p=4."""
    if degree is not None and degree not in FUSED_DEGREES:
        return ()
    dense = (("dense", "precomputed"), ("dense", "onthefly"))
    twostage = (("twostage", "onthefly"),)
    if precision != "split2m":
        return dense + twostage + (("twostage", "precomputed"),)
    return dense + (twostage if degree in (None, 4) else ())


def check_config(precision: str, factor: str = "twostage",
                 metric: str = "onthefly", cofactor: str = "adjj",
                 dtype: torch.dtype = torch.float32,
                 windowing: str = "pieces", solver: str | None = None,
                 degree: int | None = None) -> None:
    """Raise for a configuration the port lacks (NotImplementedError) or
    that the JAX package refuses too (ValueError).

    ``solver``: also check that the configuration is the one its solver
    runs on — the fused path on :func:`fused_configs` at ``degree``, the
    merged and baseline solvers on the apply family.  Without a solver (the
    builders) the fused configurations of any degree pass: the plain
    versions take every degree, the kernels check theirs.
    """
    if precision not in PRECISIONS:
        raise NotImplementedError(f"precision={precision!r} is {_TODO}")
    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"dtype={dtype} is {_TODO}")
    if precision == "split2m" and dtype != torch.float32:
        raise NotImplementedError(
            f"precision='split2m' with dtype={dtype} is {_TODO}")
    if windowing not in WINDOWINGS:
        raise NotImplementedError(
            f"windowing={windowing!r} is not ported (XLA-level windowing in "
            f"front of B3/B4): see ROADMAP.md, queue A item 10")
    if solver == "fused" and windowing != "pieces":
        raise ValueError("--solver fused requires --windowing pieces")
    if metric == "onthefly" and windowing == "zslab":
        raise ValueError("windowing='zslab' requires metric='precomputed'")
    config = (factor, metric, windowing)
    if metric == "onthefly" and cofactor != "adjj":
        raise NotImplementedError(
            f"cofactor={cofactor!r} is not ported yet: see ROADMAP.md, "
            f"queue B item 6c; the port has adjj")
    if solver == "fused" and degree not in FUSED_DEGREES:
        raise NotImplementedError(
            f"degree {degree} of the fused solver is not ported yet: see "
            f"ROADMAP.md, queue B item 7 (has {FUSED_DEGREES})")
    fused = tuple(fm + ("pieces",) for fm in fused_configs(precision, degree))
    wanted = (fused if solver == "fused" else APPLY_CONFIGS
              if solver is not None else fused + APPLY_CONFIGS)
    if config not in wanted:
        todo = (f"not ported yet: see ROADMAP.md, queue B item 6f (split2m "
                f"twostage has p=4 and the rebuilt metric)"
                if config[0] == "twostage" and precision == "split2m"
                else _TODO)
        raise NotImplementedError(
            f"factor={factor!r}, metric={metric!r}, windowing={windowing!r}"
            + (f" with solver={solver!r}" if solver else "")
            + f" is {todo}; the port has {wanted}")


def operator_from_arrays(pds: np.ndarray, w3: np.ndarray, coeffs: np.ndarray,
                         mask: np.ndarray, degree: int,
                         n_cells_axis: tuple[int, int, int], precision: str,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cuda", *,
                         mats2d: np.ndarray | None = None,
                         mats: np.ndarray | None = None,
                         gmetric: np.ndarray | None = None,
                         factor: str = "twostage",
                         windowing: str = "pieces") -> OperatorData:
    """Wrap host arrays (any float dtype) as an :class:`OperatorData`.

    ``mats2d`` and ``mats`` default to the canonical matrices of ``degree``;
    ``gmetric`` given means ``metric="precomputed"``.  Values are rounded to
    ``dtype`` first and, for ``mats2d`` under ``split2m``, from there to
    bf16 — the same two roundings the JAX package applies.
    """
    metric = "onthefly" if gmetric is None else "precomputed"
    check_config(precision, factor, metric, "adjj", dtype, windowing)
    p = degree
    q = p + 2

    def t(a):
        # C order: the kernels read the tables by raw pointer
        return torch.tensor(np.ascontiguousarray(a)).to(device=device,
                                                         dtype=dtype)

    m2 = t(dense_gradient_matrices_2d(p, q) if mats2d is None else mats2d)
    if precision == "split2m":
        m2 = m2.to(torch.bfloat16).to(dtype)
    m3 = t(dense_gradient_matrices(p, q) if mats is None else mats)
    sz, dz = z_matrices(p, q)
    pds_t = t(pds)
    co = t(coeffs)
    nc = co.shape[-1]
    return OperatorData(
        mats2d=m2, sz=t(sz), dz=t(dz), mats=m3,
        gmetric=None if gmetric is None else t(gmetric),
        pds=pds_t, w3=t(w3), coeffs=co, mask=t(mask),
        kpds=pds_t.reshape(3, q**3, 8).permute(1, 0, 2).reshape(q**3, 24)
        .contiguous(),
        kcoeffs=co.reshape(24, nc).t().contiguous(),
        degree=p, n_q=q, n_cells_axis=tuple(n_cells_axis),
        precision=precision, windowing=windowing, factor=factor,
        mma_mats=(mma_tables(m3 if factor == "dense" else m2, p, factor)
                  if precision == "split2m" else None))


def make_operator(layout: DofLayout, dtype: torch.dtype = torch.float32,
                  precision: str = "highest", factor: str = "dense",
                  metric: str = "precomputed", cofactor: str = "adjj",
                  device: torch.device | str = "cuda",
                  windowing: str = "reshape") -> OperatorData:
    """Build the operator data for ``layout`` (q = p + 2 Gauss points); the
    defaults are ``make_pallas_operator``'s."""
    check_config(precision, factor, metric, cofactor, dtype, windowing)
    p = layout.degree
    q = p + 2
    shape = lagrange.make_shape(p, q)
    coeffs = geometry.trilinear_coefficients(layout.mesh.cell_vertices)
    w3 = tensor_weights(p, q)
    gmetric = (metric_entries(coeffs, shape.q_points, w3)
               if metric == "precomputed" else None)
    nz, ny, nx = layout.n_nodes_axis
    mask = (~boundary_node_mask((nz, ny, nx))).reshape(1, nz, ny, nx)
    return operator_from_arrays(
        monomial_derivative_matrices(shape.q_points), w3,
        coeffs.transpose(2, 1, 0), mask.astype(np.float64), p,
        layout.mesh.n_cells_axis, precision, dtype, device, gmetric=gmetric,
        factor=factor, windowing=windowing)
