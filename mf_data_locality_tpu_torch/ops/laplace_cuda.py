"""Operator data for the BP4 kernels (counterpart of ``laplace_pallas.make_pallas_operator``).

Two families of configurations, named by (factor, metric, windowing):

* the fused path (``solvers/cg_fused``, kernels B1/B2) on ``"pieces"``
  (:func:`fused_configs`): the dense factorization or twostage (the z
  direction contracted by 1D factors, then a dense 2D stage), with the
  metric streamed (``"precomputed"``) or rebuilt per quadrature point from
  24 trilinear coefficients per cell (``"onthefly"``, by the inversion
  chain ``cofactor``: "adjj", the adjugate of J, or "jtj", adj(J^T J)
  rsqrt(det)) — every pair and both chains at degrees 1..11, under
  ``highest`` and under each tensor-core rung (``split2m``, ``split3``,
  ``bf16``);
* the apply family (``ops/laplace_apply``, kernels B3-B6, used by the merged
  and baseline solvers): the dense factorization with the metric streamed
  (``metric="precomputed"``, any of the windowings ``reshape``, ``pieces``,
  ``zslab``) or rebuilt per q-point (``metric="onthefly"``, ``reshape``;
  always by adjj, as ``laplace_pallas._kernel``), at degrees 1..11 on
  every rung (``highest`` and the tensor-core rungs ``split2m``,
  ``split3``, ``bf16``); also twostage on ``pieces``, where the JAX
  resolvers put the merged and baseline solvers' ``--windowing pieces``
  from p=5 (B5 reads the dense operator whatever the factor says).

The Gauss points a direction, q, are the operator's (``n_q``, default
p + 2, the arrays' sizes): the kernels take q = p + 1 and p + 2 with one
or three components under ``highest`` and ``split2m``
(:func:`check_shape`; the rest is queue B item 6g), the plain versions
any.

The arrays are kept in canonical order — the port works on the lattice
``(C, Nz, Ny, Nx)``, not on the TPU's corner-piece rows — so no column
permutation, no cell padding and no windowed mask are held.

Arrays (working dtype ``T``, f32 or f64, all on ``device``; a bf16 state,
``dtype=torch.bfloat16`` — d and h of every solver on every rung —, keeps
them in f32, as the JAX package does):

* ``mats2d`` (3 q^2, (p+1)^2): ``[Dx2d; Dy2d; S2d]``, rows (qy, qx) and
  columns (ky, kx), x fastest (``laplace_pallas._dense_gradient_matrices_2d``),
  as the fused path's plain version applies them: for the ``split2m`` and
  ``bf16`` rungs rounded to bf16 once here (``cg_fused_kernel._prestack``),
  held in the working dtype (their kernels read them as ``mma_mats``);
  unrounded for ``split3``, whose hi and lo parts both come from it.
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
  12, 22) per q-point, computed on the host in f64 and rounded once to
  ``T``, or to bf16 (``metric_dtype``, every rung; the kernels upcast it
  at the load) (``metric="precomputed"``).
* ``pds`` (3 q^3, 8): derivatives of the trilinear monomials at the tensor
  quadrature points; ``w3`` (q^3, 1) the tensor weights.
* ``coeffs`` (3, 8, n_cells): trilinear coefficients, cell-minor (the
  JAX layout; the sum-factorized passes read it, the cell fastest).
* ``mask`` (1, Nz, Ny, Nx): 1 at free nodes, 0 at Dirichlet nodes.

``kpds`` (q^3, 24) and ``kcoeffs`` (n_cells, 24) are the same data with one
contiguous row per q-point / per cell: the kernels read ``kpds``, and the
twostage split2m tensor-core passes of B1/B2 ``kcoeffs`` (from p=5 each
thread rebuilds G at its own cell's q-points, or reads them from the
streamed ``gmetric`` in its canonical layout, where the 8 cells of a warp
are one 32-byte sector of a q-point's row).  ``mma_mats``
(the tensor-core rungs only) is the matrix of the tensor-core cell pass
rounded once to bf16 — under ``split3`` also its bf16 remainder — and
packed as its fragments (:func:`mma_tables`): ``mats`` for the dense
factorization (the apply family, and the fused path's dense
configurations), ``mats2d`` for twostage.  ``factor`` records which; the
apply family reads the dense tables whatever it says
(:func:`dense_mma_tables`, built once an operator).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from mf_data_locality_tpu_torch import PRECISIONS
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout, boundary_node_mask
from mf_data_locality_tpu_torch.ops import geometry, lagrange
from mf_data_locality_tpu_torch.ops._build import SHAPE_C1, SHAPE_Q1

_TODO = ("not ported yet: see ROADMAP.md, queue B (remaining B1/B2 "
         "configurations)")
# the rungs on the tensor cores, and their products a tile (the kernels'
# rung argument; 0: highest, the sum-factorized pass)
TENSOR_RUNGS = ("split2m", "split3", "bf16")
RUNG_PRODUCTS = {"highest": 0, "bf16": 1, "split2m": 2, "split3": 3}

_SHAPE_TODO = ("not instantiated: see ROADMAP.md, queue B item 6g (q != "
               "p+2 or C != 3 on the kernels: the kernels take C in (1, 3) "
               "and q in (p+1, p+2) under highest and split2m, at the "
               "working dtype, on one device)")
# the rungs of the kernels' instantiations beyond BP4's shape (3
# components, q = p + 2); their shape flags (one component, CEED BP3;
# q = p + 1) are _build.SHAPE_C1 and SHAPE_Q1
SHAPE_PRECISIONS = ("highest", "split2m")
_F64_TODO = ("not ported yet: see ROADMAP.md, queue B item 6h (f64 beside "
             "bf16 parts: the tensor-core rungs and the bf16 metric stream "
             "at f64)")

WINDOWINGS = ("reshape", "pieces", "zslab")
COFACTORS = ("adjj", "jtj")
# the reference's degree table (benchmark.h:290-313): the fused solver's
# and the apply family's kernels, on every rung — under the tensor-core
# rungs the dense tensor-core pass (B3/B5/B6, B1/B2 dense: csrc/apply_mma.cuh
# at p=1..4, csrc/apply_mma_hd.cuh at 5..11) and the twostage one of B1/B2
# (csrc/cell_mma.cuh at p=4 with the rebuilt metric, csrc/cell_mma_hd.cuh
# at every other (degree, metric))
FUSED_DEGREES = tuple(range(1, 12))
# (factor, metric, windowing) of the apply family; also twostage on pieces,
# where the JAX resolvers put the merged and baseline solvers' --windowing
# pieces at p >= 5 and which an explicit --factor twostage gives at any
# degree (B5 reads the dense operator whatever the factor says:
# ``laplace_pallas.apply_lattice_pieces``)
APPLY_CONFIGS = (("dense", "precomputed", "reshape"),
                 ("dense", "precomputed", "pieces"),
                 ("dense", "precomputed", "zslab"),
                 ("dense", "onthefly", "reshape"),
                 ("twostage", "precomputed", "pieces"))


@functools.lru_cache(maxsize=None)
def dense_gradient_matrices(p: int, q: int) -> np.ndarray:
    """[M_x; M_y; M_z] stacked (3 q^3, (p+1)^3): rows (qz, qy, qx) and
    columns (kz, ky, kx), x fastest; built once a process, read-only."""
    shape = lagrange.make_shape(p, q)
    S, Sg = shape.values, shape.grads

    def t3(az, ay, ax):
        out = np.einsum("ck,bj,ai->cbakji", az, ay, ax)
        return out.reshape(q ** 3, (p + 1) ** 3)

    out = np.ascontiguousarray(
        np.concatenate([t3(S, S, Sg), t3(S, Sg, S), t3(Sg, S, S)], axis=0))
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def dense_gradient_matrices_2d(p: int, q: int) -> np.ndarray:
    """[Dx2d; Dy2d; S2d] stacked (3 q^2, (p+1)^2), canonical (ky, kx)
    columns; built once a process, read-only."""
    shape = lagrange.make_shape(p, q)
    S, Sg = shape.values, shape.grads

    def t2(ay, ax):
        out = np.einsum("bj,ai->baji", ay, ax)
        return np.ascontiguousarray(out.reshape(q * q, (p + 1) * (p + 1)))

    out = np.concatenate([t2(S, Sg), t2(Sg, S), t2(S, S)], axis=0)
    out.setflags(write=False)
    return out


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
    (``laplace_pallas._metric_entries``): the native builder where it loads,
    else :func:`metric_entries_np`.

    ``coeffs``: (n_cells, 8, 3).  Returns the 6 unique entries (00, 01, 02,
    11, 12, 22) stacked as rows: (6 q^3, n_cells).
    """
    from mf_data_locality_tpu_torch import native

    if native.AVAILABLE:
        return native.metric_entries(coeffs, q_points, w3)
    return metric_entries_np(coeffs, q_points, w3)


def metric_entries_np(coeffs: np.ndarray, q_points: np.ndarray,
                      w3: np.ndarray) -> np.ndarray:
    """:func:`metric_entries` in NumPy (the JAX ``_metric_entries``'s
    NumPy branch)."""
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
    cofactor: str = "adjj"  # the rebuilt metric's chain (B1/B2; B4: adjj)
    # a block of a global lattice, a rank's of a (z), (z, y) or (z, y, x)
    # rank mesh (parallel/distributed.py; a z-slab is a block of a (N,)
    # mesh): ((z0, y0, x0), (ncz, ncy, ncx)), its first global cell per
    # axis and the global mesh's real cell counts; None for the whole box.
    # ``mask`` is then the block's (Dirichlet faces by global position,
    # dummy cells 0): B5 reads it in place of the box's index mask, and B2
    # runs its block form (``cg_fused_kernel.fused_cg_iteration``)
    slab: tuple | None = None
    # what is built once from the fields above: :func:`dense_mma_tables`,
    # the dense pass's scratch (``cg_fused_kernel.dense_scratch``)
    cache: dict = field(default_factory=dict, init=False, repr=False,
                        compare=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.w3.dtype

    @property
    def metric(self) -> str:
        return "onthefly" if self.gmetric is None else "precomputed"

    @property
    def metric_dtype(self) -> torch.dtype:
        """The streamed metric's storage dtype (the working dtype when the
        metric is rebuilt)."""
        return self.dtype if self.gmetric is None else self.gmetric.dtype

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


def sub_operator(op: OperatorData, c0: int, c1: int) -> OperatorData:
    """The operator on the cell layers [c0, c1) of ``op``'s lattice, its
    planes [c0 p, c1 p] (the JAX package's ``_sub_op``,
    ``mf_data_locality_tpu/parallel/distributed.py:322-368``): the
    coefficients and the metric columns of those layers' cells (cells are
    z-major: the cells [c0 ncy ncx, c1 ncy ncx)) and the mask's planes,
    copied contiguous, since the kernels read them by pointer; the
    matrices shared.  A block of ``op``'s lattice (``slab``: its first
    layer c0 further up), so B5 reads the mask tensor and not the
    sub-lattice's faces.  The port's kernels take any cell count, so no
    dummy cells pad a batch as the JAX package's do.  Built once a range,
    kept in ``op.cache``."""
    ncz, ncy, ncx = op.n_cells_axis
    if not 0 <= c0 < c1 <= ncz:
        raise ValueError(f"cell layers [{c0}, {c1}) are not a range of "
                         f"the operator's {ncz}")
    key = ("sub_operator", c0, c1)
    if key not in op.cache:
        a, b, p = c0 * ncy * ncx, c1 * ncy * ncx, op.degree
        (z0, y0, x0), nc = op.slab or ((0, 0, 0), op.n_cells_axis)
        op.cache[key] = replace(
            op, coeffs=op.coeffs[:, :, a:b].contiguous(),
            kcoeffs=op.kcoeffs[a:b].contiguous(),
            gmetric=(None if op.gmetric is None
                     else op.gmetric[:, a:b].contiguous()),
            mask=op.mask[:, c0 * p:c1 * p + 1].contiguous(),
            n_cells_axis=(c1 - c0, ncy, ncx), slab=((z0 + c0, y0, x0), nc))
    return op.cache[key]


def _mma_block(p: int, factor: str,
               q: int | None = None) -> tuple[int, int]:
    """(rows, columns) of one direction's block of the matrix the
    tensor-core pass of ``factor`` reads: the dense (q^3, (p+1)^3) or the
    2D stage's (q^2, (p+1)^2); q defaults to p + 2."""
    q = p + 2 if q is None else q
    if factor == "dense":
        return q ** 3, (p + 1) ** 3
    if factor == "twostage":
        return q ** 2, (p + 1) ** 2
    raise ValueError(f"no tensor-core tables for factor={factor!r}")


def mma_dims(p: int, factor: str = "dense",
             q: int | None = None) -> tuple[int, int]:
    """(q-points per direction, nodes) of degree ``p`` and ``q`` Gauss
    points a direction (default p + 2), each padded to a multiple of 16:
    the tensor-core tiles of ``csrc/apply_mma.cuh`` and
    ``csrc/apply_mma_hd.cuh`` (``factor="dense"``) or of the 2D stage in
    ``csrc/cell_mma.cuh`` and ``csrc/cell_mma_hd.cuh`` (``"twostage"``:
    q^2 and (p+1)^2)."""
    return tuple(-(-n // 16) * 16 for n in _mma_block(p, factor, q))


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


def mma_tables(mats: torch.Tensor, p: int, factor: str = "dense",
               precision: str = "split2m",
               q: int | None = None) -> torch.Tensor:
    """The tensor-core pass's matrix: ``mats`` ((3 q^3, (p+1)^3) dense, or
    the (3 q^2, (p+1)^2) 2D stage for ``factor="twostage"``) rounded once
    to bf16, Mh, each direction's block zero-padded to (RP, CP)
    (:func:`mma_dims`), packed as fragments: row 0 for the forward product
    (B = Mh^T), row 1 for the backward (B = Mh); under ``split3`` rows 2
    and 3 hold the remainder Ml = bf16(mats - Mh) in the same order
    (``cg_fused_kernel._prestack``).  Shape (2 or 4, 3 RP CP), bf16.  ``q``:
    the Gauss points a direction (default p + 2)."""
    rows, cols = _mma_block(p, factor, q)
    rp, cp = mma_dims(p, factor, q)
    mh = mats.to(torch.bfloat16)
    parts = [mh] + ([(mats - mh.to(mats.dtype)).to(torch.bfloat16)]
                    if precision == "split3" else [])
    out = []
    for part in parts:
        m = mats.new_zeros((3, rp, cp), dtype=torch.bfloat16)
        m[:, :rows, :cols] = part.reshape(3, rows, cols)
        m = m.reshape(3 * rp, cp)
        out += [_fragments(m.t()), _fragments(m)]
    return torch.stack(out)


def unpack_mma_tables(tables: torch.Tensor, p: int, factor: str = "dense",
                      part: int = 0,
                      q: int | None = None) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The padded (3 RP, CP) bf16 matrices that :func:`mma_tables` holds
    for ``part`` (0: Mh, 1: split3's Ml): (forward's, backward's)."""
    rp, cp = mma_dims(p, factor, q)
    return (_from_fragments(tables[2 * part], cp, 3 * rp).t(),
            _from_fragments(tables[2 * part + 1], 3 * rp, cp))


def dense_mma_tables(op: OperatorData) -> torch.Tensor:
    """:func:`mma_tables` of the dense M at ``op.precision``: the apply
    family's tables (B3/B5/B6) whatever ``op.factor`` says — B5 on a
    twostage operator (the merged and baseline solvers' ``pieces`` from
    p=5) reads the dense M, as ``laplace_pallas.apply_lattice_pieces``
    does —, built from ``op.mats`` once an operator and kept in
    ``op.cache``; ``op.mma_mats`` where that is the dense one."""
    if op.factor == "dense":
        return op.mma_mats
    if "dense_mma" not in op.cache:
        op.cache["dense_mma"] = mma_tables(op.mats, op.degree, "dense",
                                           op.precision, op.n_q)
    return op.cache["dense_mma"]


def fused_configs(precision: str,
                  degree: int | None = None) -> tuple[tuple[str, str], ...]:
    """The (factor, metric) pairs the fused solver runs on (windowing
    ``"pieces"``) at ``degree`` (None: at any of its degrees), the metric
    rebuilt by either chain: every pair at degrees 1..11, whatever the
    rung ``precision``.  Under ``highest`` the dense and twostage operators
    are one function, which one sum-factorized pass computes; under a
    tensor-core rung (:data:`TENSOR_RUNGS`) each factorization's rounding
    defines the rung, and each has its tensor-core pass."""
    if degree is not None and degree not in FUSED_DEGREES:
        return ()
    return (("dense", "precomputed"), ("dense", "onthefly"),
            ("twostage", "onthefly"), ("twostage", "precomputed"))


def check_config(precision: str, factor: str = "twostage",
                 metric: str = "onthefly", cofactor: str = "adjj",
                 dtype: torch.dtype = torch.float32,
                 windowing: str = "pieces", solver: str | None = None,
                 degree: int | None = None,
                 metric_dtype: torch.dtype | None = None) -> None:
    """Raise for a configuration the port lacks (NotImplementedError) or
    that the JAX package refuses too (ValueError).

    ``solver``: also check that the configuration is the one its solver
    runs on — the fused path on :func:`fused_configs` at ``degree``, the
    merged and baseline solvers on :data:`APPLY_CONFIGS`.
    Without a solver (the builders) the fused configurations of any degree
    pass: the plain versions take every degree, the kernels check theirs
    (no rung falls back to another, nor a kernel to its plain version).
    ``dtype=torch.bfloat16`` is the bf16 state (d and h of every solver,
    p and Ap of the baseline; f32 tables), on every rung and windowing;
    ``metric_dtype`` the streamed metric's storage (None: the working
    dtype), bf16 on every rung (ignored where the metric is rebuilt).
    """
    if precision not in PRECISIONS:
        raise NotImplementedError(f"precision={precision!r} is {_TODO}")
    if dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise NotImplementedError(f"dtype={dtype} is {_TODO}")
    if precision in TENSOR_RUNGS and dtype == torch.float64:
        raise NotImplementedError(
            f"precision={precision!r} with dtype={dtype} is {_F64_TODO}")
    table = torch.float32 if dtype == torch.bfloat16 else dtype
    if metric_dtype not in (None, table, torch.bfloat16):
        raise ValueError(f"metric_dtype={metric_dtype} with dtype={dtype}: "
                         f"the metric is stored at {table} or in bf16")
    if (metric_dtype == torch.bfloat16 and metric == "precomputed"
            and dtype == torch.float64):
        raise NotImplementedError(
            f"metric_dtype=torch.bfloat16 with dtype={dtype} is {_F64_TODO}")
    if windowing not in WINDOWINGS:
        raise NotImplementedError(
            f"windowing={windowing!r} is not ported (XLA-level windowing in "
            f"front of B3/B4): see ROADMAP.md, queue A item 10")
    if solver == "fused" and windowing != "pieces":
        raise ValueError("--solver fused requires --windowing pieces")
    if metric == "onthefly" and windowing == "zslab":
        raise ValueError("windowing='zslab' requires metric='precomputed'")
    config = (factor, metric, windowing)
    if cofactor not in COFACTORS:
        raise ValueError(f"unknown cofactor mode {cofactor!r}")
    if solver == "fused" and degree not in FUSED_DEGREES:
        raise NotImplementedError(
            f"degree {degree} of the fused solver has no kernel: the "
            f"reference's table is {FUSED_DEGREES} (benchmark.h:290-313)")
    fused = tuple(fm + ("pieces",) for fm in fused_configs(
        precision, degree if solver == "fused" else None))
    wanted = (fused if solver == "fused" else APPLY_CONFIGS
              if solver is not None else fused + APPLY_CONFIGS)
    if config not in wanted:
        raise NotImplementedError(
            f"factor={factor!r}, metric={metric!r}, windowing={windowing!r}"
            + (f" with solver={solver!r}" if solver else "")
            + f" is {_TODO}; the port has {wanted}")


def check_shape(degree: int, n_q: int, n_components: int,
                precision: str = "highest",
                dtype: torch.dtype = torch.float32,
                metric_dtype: torch.dtype | None = None,
                block: bool = False, px: bool = False) -> int:
    """The kernels' shape argument for ``n_components`` and ``n_q`` Gauss
    points a direction at ``degree``: 0 for BP4's (3, p + 2), else
    SHAPE_C1 (one component, CEED BP3) and/or SHAPE_Q1 (q = p + 1).
    NotImplementedError (queue B item 6g) for any other shape, and at
    those two for what they are not built with: a rung other than highest
    and split2m (:data:`SHAPE_PRECISIONS`), a bf16 state (``dtype``) or
    metric (``metric_dtype``), B2's block form (``block``, the distributed
    solvers) and its P/x form (``px``).  The plain versions take every
    shape."""
    if n_components not in (1, 3) or n_q not in (degree + 1, degree + 2):
        raise NotImplementedError(
            f"n_q={n_q} at degree {degree} with {n_components} component(s) "
            f"on the pallas backend is {_SHAPE_TODO}")
    flags = ((SHAPE_C1 if n_components == 1 else 0)
             | (SHAPE_Q1 if n_q == degree + 1 else 0))
    if not flags:
        return 0
    lacks = [what for what, bad in (
        (f"precision={precision!r}", precision not in SHAPE_PRECISIONS),
        ("a bf16 state", dtype == torch.bfloat16),
        ("a bf16 metric", metric_dtype == torch.bfloat16),
        ("the block form (distributed)", block),
        ("P or x in bf16", px)) if bad]
    if lacks:
        raise NotImplementedError(
            f"{', '.join(lacks)} at n_q={n_q}, degree {degree}, "
            f"{n_components} component(s) on the pallas backend is "
            f"{_SHAPE_TODO}")
    return flags


def operator_from_arrays(pds: np.ndarray, w3: np.ndarray, coeffs: np.ndarray,
                         mask: np.ndarray, degree: int,
                         n_cells_axis: tuple[int, int, int], precision: str,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cuda", *,
                         mats2d: np.ndarray | None = None,
                         mats: np.ndarray | None = None,
                         gmetric: np.ndarray | None = None,
                         factor: str = "twostage",
                         windowing: str = "pieces",
                         cofactor: str = "adjj",
                         metric_dtype: torch.dtype | None = None,
                         slab: tuple | None = None) -> OperatorData:
    """Wrap host arrays (any float dtype, bf16 ones of the JAX package bit
    for bit) as an :class:`OperatorData`.

    ``mats2d`` and ``mats`` default to the canonical matrices of ``degree``;
    ``gmetric`` given means ``metric="precomputed"``, stored at
    ``metric_dtype`` (None: the working dtype).  Values are rounded to
    ``dtype`` first and, for ``mats2d`` under ``split2m`` and ``bf16``, from
    there to bf16 — the same two roundings the JAX package applies.
    The Gauss points a direction, q, are the arrays' (``w3`` holds q^3
    weights): the plain versions take any q, the kernels p + 1 and p + 2
    (:func:`check_shape`).
    ``dtype=torch.bfloat16`` (the fused solver's bf16 state) keeps the
    tables in f32.  ``cofactor="jtj"`` raises ValueError unless det J > 0 at
    every quadrature point (:func:`check_orientation`).  ``slab``: the
    operator of a block (:attr:`OperatorData.slab`), ``mask`` its mask.
    """
    metric = "onthefly" if gmetric is None else "precomputed"
    check_config(precision, factor, metric, cofactor, dtype, windowing,
                 degree=degree, metric_dtype=metric_dtype)
    if cofactor == "jtj":
        check_orientation(pds, coeffs)
    p = degree
    n_w = host_tensor(w3).numel()
    q = round(n_w ** (1 / 3))
    if q ** 3 != n_w:
        raise ValueError(f"w3 holds {n_w} weights, not q^3 for a whole q")
    if dtype == torch.bfloat16:  # a bf16 state; the tables stay f32
        dtype = torch.float32

    def t(a, to=dtype):
        # C order: the kernels read the tables by raw pointer
        return host_tensor(a).contiguous().to(device=device, dtype=to)

    m2 = t(dense_gradient_matrices_2d(p, q) if mats2d is None else mats2d)
    if precision in ("split2m", "bf16"):
        m2 = m2.to(torch.bfloat16).to(dtype)
    m3 = t(dense_gradient_matrices(p, q) if mats is None else mats)
    sz, dz = z_matrices(p, q)
    pds_t = t(pds)
    co = t(coeffs)
    nc = co.shape[-1]
    return OperatorData(
        mats2d=m2, sz=t(sz), dz=t(dz), mats=m3,
        gmetric=None if gmetric is None else t(gmetric,
                                               metric_dtype or dtype),
        pds=pds_t, w3=t(w3), coeffs=co, mask=t(mask),
        kpds=pds_t.reshape(3, q**3, 8).permute(1, 0, 2).reshape(q**3, 24)
        .contiguous(),
        kcoeffs=co.reshape(24, nc).t().contiguous(),
        degree=p, n_q=q, n_cells_axis=tuple(n_cells_axis),
        precision=precision, windowing=windowing, factor=factor,
        mma_mats=(mma_tables(m3 if factor == "dense" else m2, p, factor,
                             precision, q)
                  if precision in TENSOR_RUNGS else None),
        cofactor=cofactor, slab=slab)


def host_tensor(a) -> torch.Tensor:
    """A CPU tensor of a host array: a torch tensor as it is; a JAX bf16
    array (numpy's ``ml_dtypes.bfloat16``, which ``torch.tensor`` does not
    take) bit for bit through its uint16 view; any other array copied."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.tensor(np.ascontiguousarray(a))


def jacobian_determinants(pds: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """det J at every (q-point, cell), in f64 on the host: ``pds`` (3 q^3,
    8), ``coeffs`` (3, 8, n_cells).  Returns (q^3, n_cells)."""
    pds = np.asarray(pds, np.float64)
    j = np.einsum("eqk,dkn->deqn", pds.reshape(3, -1, 8),
                  np.asarray(coeffs, np.float64), optimize=True)
    return (j[0, 0] * (j[1, 1] * j[2, 2] - j[1, 2] * j[2, 1])
            - j[0, 1] * (j[1, 0] * j[2, 2] - j[1, 2] * j[2, 0])
            + j[0, 2] * (j[1, 0] * j[2, 1] - j[1, 1] * j[2, 0]))


def check_orientation(pds: np.ndarray, coeffs: np.ndarray) -> None:
    """Raise ValueError unless det J > 0 at every quadrature point.

    The jtj chain scales the metric by |det J| (rsqrt of det J^T J), the
    adjj chain by det J: on an orientation-reversing cell the two differ in
    sign.  The JAX package does not check this (its ``_metric_onthefly``
    assumes det J > 0); the port refuses such a mesh under jtj — a
    deliberate divergence (ROADMAP C1).
    """
    det = jacobian_determinants(pds, coeffs)
    if not det.size or det.min() <= 0.0:
        raise ValueError(
            f"cofactor='jtj' needs det J > 0 at every quadrature point "
            f"(min {det.min() if det.size else float('nan'):.3e}): jtj "
            f"scales by |det J|, adjj by det J")


def make_operator(layout: DofLayout, dtype: torch.dtype = torch.float32,
                  precision: str = "highest", factor: str = "dense",
                  metric: str = "precomputed", cofactor: str = "adjj",
                  device: torch.device | str = "cuda",
                  windowing: str = "reshape",
                  metric_dtype: torch.dtype | None = None,
                  n_q: int | None = None) -> OperatorData:
    """Build the operator data for ``layout`` (``n_q`` Gauss points a
    direction, default p + 2); the defaults are ``make_pallas_operator``'s.
    ``n_q``: p + 1 or p + 2 under highest and split2m at the working dtype
    (NotImplementedError for the rest, queue B item 6g:
    :func:`check_shape`; the vectors' components are checked where they
    meet the kernels)."""
    check_config(precision, factor, metric, cofactor, dtype, windowing,
                 degree=layout.degree, metric_dtype=metric_dtype)
    p = layout.degree
    q = p + 2 if n_q is None else n_q
    check_shape(p, q, 3, precision, dtype, metric_dtype)
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
        factor=factor, windowing=windowing, cofactor=cofactor,
        metric_dtype=metric_dtype)
