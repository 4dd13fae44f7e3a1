"""The apply family of the BP4 operator: cell-batched and lattice applies.

Counterparts of ``mf_data_locality_tpu.ops.laplace_pallas`` for the dense
factorization (``factor="dense"``), the operator of the merged and baseline
solvers.  Per cell, ``v = sum_e M_e^T G_ef M_f u`` with the dense gradient
matrices ``M`` and the symmetric metric ``G``.  The kernels:

* :func:`apply_local_batched_g` — B3, ``apply_local_batched`` with the
  precomputed metric (TPU kernel ``_kernel_g``);
* :func:`apply_local_batched_onthefly` — B4, ``apply_local_batched`` with the
  metric rebuilt per q-point (TPU kernel ``_kernel``), exact at the working
  dtype on every rung;
* :func:`apply_lattice_pieces` — B5 (``_kernel_g_pieces``): M A M on the
  lattice, the Dirichlet mask computed from the node indices;
* :func:`apply_lattice_zslab` — B6 (``_kernel_g_zslab``): the same, the mask
  read from the operator's mask tensor.

Cell batches are ``(C (p+1)^3, n_cells)``, rows (c, kz, ky, kx), columns
cells (cz, cy, cx) — the JAX layout, without its lane padding.  Lattice
vectors are ``(C, Nz, Ny, Nx)``.  The windowing between the two
(:func:`to_cell_batches`, :func:`from_cell_batches`) is plain PyTorch, as it
is XLA outside the Pallas kernels in JAX.

Each kernel wrapper runs the hand-written CUDA kernel
(``csrc/laplace_apply.cu``: B3, B5 and B6 run its sum-factorized pass,
``csrc/apply_sumfac.cuh``, on the 1D factors ``op.sz`` and ``op.dz`` under
``highest``, and its tensor-core pass on the dense M's bf16 tables
(``laplace_cuda.dense_mma_tables``) under the f32 tensor-core rungs
``split2m``, ``split3`` and ``bf16`` — ``csrc/apply_mma.cuh`` at p=1..4,
``csrc/apply_mma_hd.cuh`` at p=5..11 with a scratch for its operands'
fragments (:func:`dense_scratch`) —, the metric streamed in f32 or, under
the last two, in bf16; B4 the sum-factorized pass with the metric rebuilt from
``op.coeffs`` on every rung) for tensors on a CUDA device and its plain
PyTorch version (the dense einsum over cells, the same bf16 rounding
points for the rung) for tensors on the CPU;
other devices raise.  Each wrapper counts its kernel launches in
``.launches``.

The components C come from the vectors' shape and q from ``op.n_q``: at
the shapes beyond BP4's (C = 1, CEED BP3; q = p + 1; both) the kernels
run ``csrc/shapes.cu``'s cell passes, the sum-factorized one under
``highest`` and ``apply_mma_hd.cuh``'s under ``split2m`` at every degree,
with u and the metric at the working dtype (``laplace_cuda.check_shape``).

A bf16 state (the merged and baseline solvers' ``dtype=torch.bfloat16``,
every rung): u arrives in bf16 and the result leaves in bf16, the
arithmetic at f32, rounded where the JAX package's kernels store
(``laplace_pallas.py``): B3 and B4 round each cell's result (``out_ref``
in u's dtype), which :func:`from_cell_batches` then sums in bf16 axis by
axis, as ``_from_cell_batches`` does; B5 and B6 sum each node's z
contributions at f32 and round (the kernels' z carry plane), then the y
and x sums in bf16, in ``_from_piece_forms``'s order (B5) or
``_from_zslab_form``'s (B6) (:func:`_from_cells_bf16`).  The metric may be
streamed in bf16 on every rung (``op.metric_dtype``), upcast where it is
read.  The kernels run the cell passes' storage instantiations
(``csrc/laplace_apply.cu``).
"""

from __future__ import annotations

import torch

from mf_data_locality_tpu_torch.mesh.dofs import boundary_node_mask
from mf_data_locality_tpu_torch.ops import _build, laplace_cuda
from mf_data_locality_tpu_torch.ops.cg_fused_kernel import (
    _mma_terms, _route, _terms, cell_metric,
    check_kernel_shape, check_tensors, dense_scratch, dtype_code,
    metric_onthefly, mma_parts, rung_args)
from mf_data_locality_tpu_torch.ops.laplace_cuda import OperatorData

# degrees instantiated in csrc/laplace_apply.cu: the reference's table
# 1..11, on every rung
KERNEL_DEGREES = laplace_cuda.FUSED_DEGREES


# ---------------------------------------------------------------------------
# windowing (laplace_structured.cellify_t / overlap_add_t,
# laplace_pallas._to_cell_batches / _from_cell_batches)
# ---------------------------------------------------------------------------

def cellify_t(t: torch.Tensor, axis: int, p: int) -> torch.Tensor:
    """Split a node axis of size nc p + 1 into (p+1, nc) overlapping
    windows, the window dim first: element [k, c] is node c p + k."""
    return t.unfold(axis, p + 1, p).movedim(-1, axis)


def overlap_add_t(v: torch.Tensor, axis: int, p: int) -> torch.Tensor:
    """Adjoint of :func:`cellify_t`: (p+1, nc) at (axis, axis+1) -> node axis.

    A shared node c p receives window p of cell c-1 and window 0 of cell c;
    each sum has two terms, so it equals the JAX package's to the bit.
    """
    nc = v.shape[axis + 1]
    lead, tail = v.shape[:axis], v.shape[axis + 2:]
    out = v.new_zeros(lead + (nc * p + 1,) + tail)
    main = v.narrow(axis, 0, p).transpose(axis, axis + 1)  # (nc, p)
    out.narrow(axis, 0, nc * p).copy_(main.reshape(lead + (nc * p,) + tail))
    index = (slice(None),) * axis + (slice(p, None, p),)
    out[index] += v.select(axis, p)
    return out


def to_cell_batches(u: torch.Tensor, p: int) -> torch.Tensor:
    """(C, Nz, Ny, Nx) lattice -> (C (p+1)^3, n_cells) cell batches."""
    t = cellify_t(u, 3, p)  # (C, Nz, Ny, p1, ncx)
    t = cellify_t(t, 2, p)  # (C, Nz, p1, ncy, p1, ncx)
    t = cellify_t(t, 1, p)  # (C, p1, ncz, p1, ncy, p1, ncx)
    t = t.permute(0, 1, 3, 5, 2, 4, 6)
    return t.reshape(u.shape[0] * (p + 1) ** 3, -1)


def from_cell_batches(v: torch.Tensor, p: int, n_cells_axis) -> torch.Tensor:
    """(C (p+1)^3, n_cells) -> (C, Nz, Ny, Nx), summing shared nodes axis by
    axis (z, then y, then x)."""
    ncz, ncy, ncx = n_cells_axis
    p1 = p + 1
    n_comp = v.shape[0] // p1 ** 3
    v = v.reshape(n_comp, p1, p1, p1, ncz, ncy, ncx)
    v = v.permute(0, 1, 4, 2, 5, 3, 6)  # (C, p1z, ncz, p1y, ncy, p1x, ncx)
    v = overlap_add_t(v, 1, p)
    v = overlap_add_t(v, 2, p)
    return overlap_add_t(v, 3, p)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _metric(op: OperatorData) -> torch.Tensor:
    """(6, q^3, n_cells): the streamed metric, or the one B4 rebuilds (by
    adjj whatever ``op.cofactor`` says: ``_kernel`` has no other chain)."""
    if op.gmetric is None:
        return metric_onthefly(op, "adjj").transpose(1, 2)
    return cell_metric(op).transpose(1, 2)


def _batched_plain(op: OperatorData, u_loc: torch.Tensor, G: torch.Tensor,
                   at_rung: bool, store: bool = True) -> torch.Tensor:
    """v = sum_e M_e^T G_ef M_f u on a cell batch (``_kernel_g`` /
    ``_kernel``), the products at ``op.precision`` when ``at_rung``, else
    exact (B4's ``Precision.HIGHEST``).  A bf16 ``u_loc`` is applied at the
    working dtype (its lo part is zero: the JAX kernels' degraded product
    sets are these) and the result rounded to bf16 when ``store`` (the
    kernels' ``out_ref``), else left at the working dtype."""
    p13 = (op.degree + 1) ** 3
    q3 = op.n_q ** 3
    nc = u_loc.shape[1]
    u = u_loc.to(op.dtype).reshape(-1, p13, nc)
    rung = op.precision if at_rung else "highest"
    g = sum(torch.einsum("rk,ckn->crn", a, b)
            for a, b in _terms(op.mats, u, rung))
    gx, gy, gz = g.reshape(-1, 3, q3, nc).unbind(1)
    t = torch.stack([G[0] * gx + G[1] * gy + G[2] * gz,
                     G[1] * gx + G[3] * gy + G[4] * gz,
                     G[2] * gx + G[4] * gy + G[5] * gz], dim=1)
    t = t.reshape(-1, 3 * q3, nc)
    v = sum(torch.einsum("rk,crn->ckn", a, b)
            for a, b in _terms(op.mats, t, rung))
    return v.reshape(-1, nc).to(u_loc.dtype if store else op.dtype)


def _batched_mma_emulated(op: OperatorData, u_loc: torch.Tensor,
                          G: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernels' arithmetic (``csrc/apply_mma.cuh``,
    ``csrc/apply_mma_hd.cuh``) in plain PyTorch, for the tests: M from its
    packed bf16 tables (Mh, and Ml under split3; the dense ones whatever
    ``op.factor`` says), nodes and q-points zero-padded, the K-stacked
    products of the rung (``cg_fused_kernel._mma_terms``; split2m [Mh |
    Mh] [uh; ul] and [Mh | Mh]^T [th; tl]) in f32, t split after the
    metric apply."""
    p13, q3 = (op.degree + 1) ** 3, op.n_q ** 3
    q3p, p13p = laplace_cuda.mma_dims(op.degree, "dense", op.n_q)
    tables = mma_parts(op, laplace_cuda.dense_mma_tables(op), "dense")
    nc = u_loc.shape[1]
    u = torch.nn.functional.pad(u_loc.reshape(-1, p13, nc),
                                (0, 0, 0, p13p - p13))
    x, m = _mma_terms(tables, u.transpose(1, 2), op.precision, back=False)
    g = (x @ m.t()).transpose(1, 2)
    gx, gy, gz = g.reshape(-1, 3, q3p, nc).unbind(1)
    G = torch.nn.functional.pad(G, (0, 0, 0, q3p - q3))
    t = torch.stack([G[0] * gx + G[1] * gy + G[2] * gz,
                     G[1] * gx + G[3] * gy + G[4] * gz,
                     G[2] * gx + G[4] * gy + G[5] * gz], dim=1)
    t = t.reshape(-1, 3 * q3p, nc)
    x, m = _mma_terms(tables, t.transpose(1, 2), op.precision, back=True)
    v = (x @ m).transpose(1, 2)
    return v[:, :p13].reshape(-1, nc)


def _batched_sumfac_emulated(op: OperatorData, u_loc: torch.Tensor,
                             G: torch.Tensor) -> torch.Tensor:
    """The ``highest`` sum-factorized kernel's arithmetic
    (``csrc/apply_sumfac.cuh``) in plain PyTorch, for the tests: 1D
    contractions with ``op.sz`` (S) and ``op.dz`` (D) in the kernel's order
    — x, y, z forward, the metric apply, z, y, x backward — in place of the
    dense ``M = [S S D; S D S; D S S]``."""
    p1, q = op.degree + 1, op.n_q
    nc = u_loc.shape[1]
    s, d = op.sz, op.dz
    u = u_loc.reshape(-1, p1, p1, p1, nc)  # (c, kz, ky, kx, cell)
    xs = torch.einsum("ai,czyin->czyan", s, u)  # (c, kz, ky, qx, cell)
    xd = torch.einsum("ai,czyin->czyan", d, u)
    uss = torch.einsum("bj,czjan->czban", s, xs)  # (c, kz, qy, qx, cell)
    uds = torch.einsum("bj,czjan->czban", d, xs)
    usd = torch.einsum("bj,czjan->czban", s, xd)
    grads = [torch.einsum("gz,czban->cgban", m, v).reshape(-1, q ** 3, nc)
             for m, v in ((s, usd), (s, uds), (d, uss))]
    gx, gy, gz = grads
    tx = G[0] * gx + G[1] * gy + G[2] * gz
    ty = G[1] * gx + G[3] * gy + G[4] * gz
    tz = G[2] * gx + G[4] * gy + G[5] * gz
    wsd, wds, wss = (torch.einsum("gz,cgban->czban", m,
                                  v.reshape(-1, q, q, q, nc))
                     for m, v in ((s, tx), (s, ty), (d, tz)))
    vs = (torch.einsum("bj,czban->czjan", d, wds)
          + torch.einsum("bj,czban->czjan", s, wss))
    vd = torch.einsum("bj,czban->czjan", s, wsd)
    v = (torch.einsum("ai,czjan->czjin", s, vs)
         + torch.einsum("ai,czjan->czjin", d, vd))
    return v.reshape(-1, nc)


def _lattice_plain(op: OperatorData, u: torch.Tensor, mask: torch.Tensor,
                   pieces: bool | None = None) -> torch.Tensor:
    """M A M u on the lattice through the cell batches; a bf16 u summed at
    B5's (``pieces``; None: ``op.windowing == "pieces"``) or B6's rounding
    points (:func:`_from_cells_bf16`)."""
    p = op.degree
    pieces = op.windowing == "pieces" if pieces is None else pieces
    if u.dtype != torch.bfloat16:
        v = _batched_plain(op, to_cell_batches(u * mask, p), _metric(op),
                           True)
        return from_cell_batches(v, p, op.n_cells_axis) * mask
    m = mask.to(op.dtype)
    v = _batched_plain(op, to_cell_batches(u.to(op.dtype) * m, p),
                       _metric(op), True, store=False)
    nc = v.shape[1]
    v = (v.reshape(-1, (p + 1) ** 3, nc) * to_cell_batches(m, p)).reshape(
        -1, nc)
    return _from_cells_bf16(v, p, op.n_cells_axis, pieces)


def _place(t: torch.Tensor, axis: int, p: int, top: bool) -> torch.Tensor:
    """The windows of one class at (axis, axis+1) on the node axis, zero
    elsewhere: a cell's windows 0..p-1 (``top`` false) or its window p,
    the node it shares with the next cell (``top``)."""
    nc = t.shape[axis + 1]
    lead, tail = t.shape[:axis], t.shape[axis + 2:]
    out = t.new_zeros(lead + (nc * p + 1,) + tail)
    if top:
        out[(slice(None),) * axis + (slice(p, None, p),)] = t.select(axis, p)
    else:
        main = t.narrow(axis, 0, p).transpose(axis, axis + 1)
        out.narrow(axis, 0, nc * p).copy_(main.reshape(lead + (nc * p,)
                                                       + tail))
    return out


def _from_cells_bf16(v: torch.Tensor, p: int, n_cells_axis,
                     pieces: bool) -> torch.Tensor:
    """(C (p+1)^3, n_cells) masked f32 cell results -> the bf16 lattice at
    the JAX lattice kernels' rounding points: the z sums at f32 and rounded
    (the kernels' carry plane and store), then the y and x sums in bf16 —
    B6 along y, then along x (``_from_zslab_form``); B5 the corner pieces
    mm, mp, pm, pp in turn (``_from_piece_forms``)."""
    ncz, ncy, ncx = n_cells_axis
    p1 = p + 1
    t = v.reshape(-1, p1, p1, p1, ncz, ncy, ncx).permute(0, 1, 4, 2, 5, 3, 6)
    t = overlap_add_t(t, 1, p).to(torch.bfloat16)  # (C, Nz, p1y, ncy, ...)
    if not pieces:
        return overlap_add_t(overlap_add_t(t, 2, p), 3, p)
    out = None
    for ty, tx in ((False, False), (False, True), (True, False),
                   (True, True)):
        piece = _place(_place(t, 2, p, ty), 3, p, tx)
        out = piece if out is None else out + piece
    return out


def _index_mask(op: OperatorData) -> torch.Tensor:
    """The box's Dirichlet mask built from the node indices (B5's source)."""
    m = ~boundary_node_mask(op.n_nodes_axis)
    return torch.as_tensor(m.reshape((1,) + op.n_nodes_axis)).to(
        device=op.device, dtype=op.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _tables(op: OperatorData, onthefly: bool) -> tuple[list, int, int]:
    """The operator tables the kernels read by pointer, with their shapes
    (and dtype where it is not the operator's), and the two pointers of the
    C interface's matrix slots: for B3/B5/B6 under a tensor-core rung the
    tensor-core pass's bf16 fragment tables of the dense M (forward,
    backward; split3's Ml pair follows them), else (B4 on every rung) the
    sum-factorized pass's 1D factors S and D."""
    p1, q3 = op.degree + 1, op.n_q ** 3
    if op.precision in laplace_cuda.TENSOR_RUNGS and not onthefly:
        q3p, p13p = laplace_cuda.mma_dims(op.degree, "dense", op.n_q)
        mm = laplace_cuda.dense_mma_tables(op)
        pairs = [(mm, (mm.shape[0], 3 * q3p * p13p), torch.bfloat16)]
        ptrs = (mm[0].data_ptr(), mm[1].data_ptr())
    else:
        pairs = [(op.sz, (op.n_q, p1)), (op.dz, (op.n_q, p1))]
        ptrs = (op.sz.data_ptr(), op.dz.data_ptr())
    if onthefly:  # the metric rebuilt from the coefficients, cell fastest
        pairs += [(op.kpds, (q3, 24)), (op.w3, (q3, 1)),
                  (op.coeffs, (3, 8, op.n_cells))]
    else:
        pairs.append((op.gmetric, (6 * q3, op.n_cells), op.metric_dtype))
    return pairs, *ptrs


def _state(op: OperatorData, u: torch.Tensor) -> torch.dtype:
    """The storage dtype of a kernel's u and output: bf16 (the bf16 state,
    f32 operators only) or the working dtype."""
    if u.dtype == torch.bfloat16 and op.dtype == torch.float32:
        return torch.bfloat16
    return op.dtype


def _batched_kernel(op: OperatorData, u_loc: torch.Tensor,
                    onthefly: bool) -> torch.Tensor:
    n_comp = u_loc.shape[0] // (op.degree + 1) ** 3
    state = _state(op, u_loc)
    code = check_kernel_shape(op, n_comp, state)
    rung, metric_bf16 = rung_args(op)
    tables, mats, kmats = _tables(op, onthefly)
    check_tensors(op, KERNEL_DEGREES,
                  [(u_loc, (n_comp * (op.degree + 1) ** 3, op.n_cells),
                    state)] + tables)
    lib = _build.load()
    out = torch.empty_like(u_loc)
    rc = lib.bp4_apply_batched(
        dtype_code(op), 0 if onthefly else rung, op.degree, code,
        int(onthefly),
        0 if onthefly else metric_bf16, int(state == torch.bfloat16), mats,
        kmats,
        0 if onthefly else op.gmetric.data_ptr(), op.kpds.data_ptr(),
        op.w3.data_ptr(), op.coeffs.data_ptr(), u_loc.data_ptr(),
        out.data_ptr(), None if onthefly else dense_scratch(op, code),
        op.n_cells,
        torch.cuda.current_stream(u_loc.device).cuda_stream)
    _build.check(lib, rc, "bp4_apply_batched")
    return out


def apply_local_batched_g(op: OperatorData, u_loc: torch.Tensor) -> torch.Tensor:
    """B3: the cell-batch apply with the streamed metric, at ``op.precision``."""
    if op.gmetric is None:
        raise ValueError("apply_local_batched_g needs metric='precomputed'")
    if _route(u_loc) == "plain":
        return _batched_plain(op, u_loc, _metric(op), True)
    out = _batched_kernel(op, u_loc, onthefly=False)
    apply_local_batched_g.launches += 1
    return out


apply_local_batched_g.launches = 0


def apply_local_batched_onthefly(op: OperatorData,
                                 u_loc: torch.Tensor) -> torch.Tensor:
    """B4: the cell-batch apply with the metric rebuilt per q-point from
    the trilinear coefficients; exact at the working dtype whatever
    ``op.precision`` says (``_kernel`` runs at ``Precision.HIGHEST``)."""
    if _route(u_loc) == "plain":
        return _batched_plain(op, u_loc, _metric(op), at_rung=False)
    out = _batched_kernel(op, u_loc, onthefly=True)
    apply_local_batched_onthefly.launches += 1
    return out


apply_local_batched_onthefly.launches = 0


def apply_local_batched(op: OperatorData, u_loc: torch.Tensor) -> torch.Tensor:
    """(C (p+1)^3, n_cells) -> same: B3 with a precomputed metric, else B4."""
    if op.gmetric is not None:
        return apply_local_batched_g(op, u_loc)
    return apply_local_batched_onthefly(op, u_loc)


def _lattice_kernel(op: OperatorData, u: torch.Tensor,
                    mask: torch.Tensor | None, pieces: bool) -> torch.Tensor:
    # on a block operator (op.slab: a rank's, or a layer range of it) the
    # faces keep their partial sums: the mask tensor is applied in the cell
    # pass and the assemble pass only sums, as the plain version masks
    if op.gmetric is None:
        raise ValueError("the lattice applies need metric='precomputed'")
    state = _state(op, u)
    code = check_kernel_shape(op, u.shape[0], state)
    lat = (u.shape[0],) + op.n_nodes_axis
    tables, mats, kmats = _tables(op, onthefly=False)
    check_tensors(op, KERNEL_DEGREES, [(u, lat, state)] + tables)
    lib = _build.load()
    out = torch.empty_like(u)
    cells = torch.empty((u.shape[0], op.n_cells, (op.degree + 1) ** 3),
                        dtype=op.dtype, device=op.device)
    ncz, ncy, ncx = op.n_cells_axis
    # the state's code: 0 at the working dtype, bf16 summed as B6 (1) or
    # B5 (2)
    store = 0 if state != torch.bfloat16 else 2 if pieces else 1
    rc = lib.bp4_apply_lattice(
        dtype_code(op), *rung_args(op), store, op.degree, code, mats, kmats,
        op.gmetric.data_ptr(),
        0 if mask is None else mask.data_ptr(), u.data_ptr(),
        cells.data_ptr(), out.data_ptr(), dense_scratch(op, code), ncz, ncy,
        ncx,
        int(op.slab is not None),
        torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(lib, rc, "bp4_apply_lattice")
    return out


def apply_lattice_pieces(op: OperatorData, u: torch.Tensor) -> torch.Tensor:
    """B5: M A M u on a (C, Nz, Ny, Nx) lattice, the Dirichlet mask built
    from the node indices (``_dirichlet_mask_pieces``); on a z-slab
    operator (``op.slab``) the slab's mask, ``op.mask``, by the kernel's
    mask pointer (the JAX slab operator's ``mask_mode="none"``, whose
    caller masks both sides)."""
    if _route(u) == "plain":
        return _lattice_plain(op, u, _index_mask(op) if op.slab is None
                              else op.mask, pieces=True)
    if op.slab is not None:
        check_tensors(op, KERNEL_DEGREES, [(op.mask, (1,) + op.n_nodes_axis)])
    out = _lattice_kernel(op, u, mask=None if op.slab is None else op.mask,
                          pieces=True)
    apply_lattice_pieces.launches += 1
    return out


apply_lattice_pieces.launches = 0


def apply_lattice_zslab(op: OperatorData, u: torch.Tensor) -> torch.Tensor:
    """B6: M A M u on a (C, Nz, Ny, Nx) lattice, the mask read from
    ``op.mask``."""
    if _route(u) == "plain":
        return _lattice_plain(op, u, op.mask, pieces=False)
    check_tensors(op, KERNEL_DEGREES, [(op.mask, (1,) + op.n_nodes_axis)])
    out = _lattice_kernel(op, u, mask=op.mask, pieces=False)
    apply_lattice_zslab.launches += 1
    return out


apply_lattice_zslab.launches = 0


def apply_lattice(op: OperatorData, u: torch.Tensor) -> torch.Tensor:
    """The operator on a (C, Nz, Ny, Nx) lattice by ``op.windowing``; the
    ``pieces`` and ``zslab`` applies mask both sides themselves."""
    if op.windowing == "zslab":
        return apply_lattice_zslab(op, u)
    if op.windowing == "pieces":
        return apply_lattice_pieces(op, u)
    p = op.degree
    v_loc = apply_local_batched(op, to_cell_batches(u, p).contiguous())
    return from_cell_batches(v_loc, p, op.n_cells_axis)


def vmult(op: OperatorData, u: torch.Tensor,
          constrained_identity: bool = True) -> torch.Tensor:
    """The full operator with Dirichlet masking (``laplace_pallas.vmult``):
    M A M u, plus u at the constrained nodes when ``constrained_identity``;
    the masks and the identity in u's dtype (exact: the mask is 0 or 1)."""
    mask = op.mask.to(u.dtype)
    if op.windowing in ("zslab", "pieces"):
        v = apply_lattice(op, u)
    else:
        v = apply_lattice(op, u * mask) * mask
    if constrained_identity:
        v = v + u * (1.0 - mask)
    return v
