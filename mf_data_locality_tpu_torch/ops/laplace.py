"""The BP4 operator on any hex mesh by gather and scatter (``--backend general``).

Counterpart of ``mf_data_locality_tpu.ops.laplace``: the sum-factorized
``n_components``-component Laplacian with the trilinear geometry rebuilt
at every quadrature point (``poisson_operator.h:74-695``), on flat vectors
``(C, n_nodes)``.  A cell's nodes are gathered by the cell-to-node map,
each 1D factor is a batched contraction (``torch.tensordot``, full f32
or f64: the package pins TF32 off), and the cell-local results are summed
back per node through the transposed scatter map: each node lists the
positions of its <= 8 copies in the flattened cell-local output, and the
sum takes them in slot order.  No ``index_add_`` or ``scatter_add_``: on
a CUDA device their atomics would make the order, and so the iteration
counts, vary from run to run.  The JAX package computes this operator in
plain XLA contractions, with no Pallas kernel, so this module is plain
PyTorch on an explicit device.

:func:`assemble_dense` is the independent check: the scalar stiffness
matrix assembled by straightforward quadrature in f64 NumPy.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from mf_data_locality_tpu_torch.mesh import renumber as rn
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.mesh.general import GeneralDofLayout
from mf_data_locality_tpu_torch.ops import geometry, lagrange


@dataclass(frozen=True)
class LaplaceOperatorData:
    """The operator's tensors, all on one device."""

    values: torch.Tensor         # S: (q, p+1) basis values at the q-points
    d_col: torch.Tensor          # (q, q) collocation derivative, q-points
    q_uvw: torch.Tensor          # (q^3, 3) tensor q-points, (u, v, w) each
    q_w3: torch.Tensor           # (q^3,) tensor quadrature weights
    coeffs: torch.Tensor         # (n_cells, 8, 3) trilinear coefficients
    gather: torch.Tensor         # (n_cells, (p+1)^3) int64 cell-to-node map
    unconstrained: torch.Tensor  # (n_nodes,) 1 where free, 0 where Dirichlet
    # the transposed scatter map: each node's copies in the flattened
    # cell-local output (n_cells (p+1)^3), padded to the largest node
    # multiplicity KMAX (8 on a conforming hex mesh) with valid = 0
    scatter_pos: torch.Tensor    # (n_nodes, KMAX) int64
    scatter_valid: torch.Tensor  # (n_nodes, KMAX) 0/1

    @property
    def n_q(self) -> int:
        return self.d_col.shape[0]

    @property
    def degree(self) -> int:
        return self.values.shape[1] - 1

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device


def make_operator(layout: DofLayout | GeneralDofLayout,
                  n_q: int | None = None, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cuda") -> LaplaceOperatorData:
    """The operator of ``layout`` (the box's or any conforming hex
    mesh's, :func:`~mf_data_locality_tpu_torch.mesh.general.
    macro_hex_layout`) with q = ``n_q`` (default p + 2, the BP4 protocol,
    ``benchmark.h:290-313``) Gauss points per direction."""
    p = layout.degree
    q = n_q if n_q is not None else p + 2
    shape = lagrange.make_shape(p, q)
    qz, qy, qx = np.meshgrid(shape.q_points, shape.q_points, shape.q_points,
                             indexing="ij")
    q_uvw = np.stack([qx, qy, qz], axis=-1).reshape(-1, 3)
    w = shape.q_weights
    q_w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(-1)
    return operator_of_arrays(LaplaceOperatorData, dict(
        values=shape.values, d_col=shape.d_col, q_uvw=q_uvw, q_w3=q_w3,
        coeffs=geometry.trilinear_coefficients(layout.mesh.cell_vertices),
        gather=layout.gather_map,
        unconstrained=(~layout.boundary_node_mask).astype(np.float64)),
        dtype, device)


def renumber_operator(op: LaplaceOperatorData,
                      perm: np.ndarray) -> LaplaceOperatorData:
    """The operator for the node numbering new_id = perm[old_id]: the
    gather map and the constraint mask permuted, and the transposed
    scatter map rebuilt (it indexes by node id, so a stale one would sum
    into the wrong nodes; the analog of re-running
    ``renumber_dofs_for_mf.h`` after a renumbering)."""
    perm = np.asarray(perm)
    gm2 = rn.apply_permutation(op.gather.cpu().numpy(), perm)
    mask2 = rn.permute_nodes(op.unconstrained.cpu().numpy(), perm)
    pos, valid = _transposed_scatter_map(gm2, op.unconstrained.shape[0])
    dev, dt = op.device, op.dtype
    return replace(
        op, gather=torch.as_tensor(gm2, dtype=torch.int64, device=dev),
        unconstrained=torch.as_tensor(mask2, dtype=dt, device=dev),
        scatter_pos=torch.as_tensor(pos, dtype=torch.int64, device=dev),
        scatter_valid=torch.as_tensor(valid, dtype=dt, device=dev))


def operator_of_arrays(cls, arrays: dict, dtype: torch.dtype | None,
                       device: torch.device | str):
    """A gather/scatter operator ``cls`` (a dataclass with one field a
    host array of ``arrays``, ``gather`` and ``unconstrained`` among them,
    and ``scatter_pos``/``scatter_valid``) on ``device``: the float arrays
    at ``dtype`` (None: ``values``' own), the maps int64, the transposed
    scatter map built from ``gather``."""
    dtype = dtype or torch.as_tensor(np.array(arrays["values"])).dtype
    gather = np.asarray(arrays["gather"])
    pos, valid = _transposed_scatter_map(gather,
                                         len(arrays["unconstrained"]))

    def t(a, to=dtype):  # a C-ordered, writable copy on the host first
        return torch.as_tensor(np.array(a, order="C")).to(device=device,
                                                          dtype=to)

    return cls(**{k: t(a) for k, a in arrays.items() if k != "gather"},
               gather=t(gather, torch.int64), scatter_pos=t(pos, torch.int64),
               scatter_valid=t(valid))


def _transposed_scatter_map(gather_map: np.ndarray, n_nodes: int
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Invert a (n_cells, nloc) gather map into per-node copy positions.

    Returns ``pos`` (n_nodes, KMAX) indices into the flattened (n_cells
    nloc) local output, in ascending position order, and ``valid``
    (n_nodes, KMAX) 0/1; unused slots point at position 0 with valid = 0.
    """
    flat = np.asarray(gather_map).reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    sorted_nodes = flat[order]
    counts = np.bincount(sorted_nodes, minlength=n_nodes)
    kmax = int(counts.max()) if counts.size else 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.zeros((n_nodes, kmax), np.int64)
    valid = np.zeros((n_nodes, kmax), np.float64)
    slot = np.arange(flat.size) - np.repeat(starts, counts)
    pos[sorted_nodes, slot] = order
    valid[sorted_nodes, slot] = 1.0
    return pos, valid


def apply_axis(mat: torch.Tensor, arr: torch.Tensor,
               axis: int) -> torch.Tensor:
    """Contract ``arr``'s ``axis`` with ``mat``'s second index."""
    return torch.tensordot(mat, arr, dims=([1], [axis])).movedim(0, axis)


def metric_terms(op: LaplaceOperatorData) -> torch.Tensor:
    """G = det(J) w J^{-1} J^{-T} at every q-point: (n_cells, q^3, 3, 3),
    from the 24 coefficients a cell (the reference's trade: O(1) stored a
    cell, recomputed per q-point)."""
    jac = geometry.jacobian(op.coeffs[:, None], op.q_uvw[None])
    jinv, det = geometry.invert_3x3(jac)
    scale = (det * op.q_w3[None, :])[..., None, None]
    return scale * torch.einsum("...ab,...cb->...ac", jinv, jinv)


def local_apply(op: LaplaceOperatorData, u_loc: torch.Tensor) -> torch.Tensor:
    """Per-cell weak Laplacian: (C, n_cells, p+1, p+1, p+1) -> same shape
    (``poisson_operator.h:534-666``): interpolate, collocation gradients,
    the metric, the transpose."""
    q = op.n_q
    n_comp, nc = u_loc.shape[0], u_loc.shape[1]
    uq = apply_axis(op.values, u_loc, 2)
    uq = apply_axis(op.values, uq, 3)
    uq = apply_axis(op.values, uq, 4)
    gx = apply_axis(op.d_col, uq, 4)
    gy = apply_axis(op.d_col, uq, 3)
    gz = apply_axis(op.d_col, uq, 2)
    grad = torch.stack([gx, gy, gz]).reshape(3, n_comp, nc, q * q * q)
    tmp = torch.einsum("nqef,fcnq->ecnq", metric_terms(op), grad)
    tmp = tmp.reshape(3, n_comp, nc, q, q, q)
    vq = (apply_axis(op.d_col.T, tmp[0], 4)
          + apply_axis(op.d_col.T, tmp[1], 3)
          + apply_axis(op.d_col.T, tmp[2], 2))
    vq = apply_axis(op.values.T, vq, 2)
    vq = apply_axis(op.values.T, vq, 3)
    return apply_axis(op.values.T, vq, 4)


def apply_cells(op: LaplaceOperatorData, u: torch.Tensor) -> torch.Tensor:
    """Gather, local apply, and the sum of each node's copies in slot
    order through the transposed scatter map.  ``u``: (C, n_nodes)."""
    nc, nloc = op.gather.shape
    p1 = op.degree + 1
    n_comp = u.shape[0]
    u_loc = u[:, op.gather].reshape(n_comp, nc, p1, p1, p1)
    v_flat = local_apply(op, u_loc).reshape(n_comp, nc * nloc)
    return slot_sum(v_flat, op.scatter_pos, op.scatter_valid)


def slot_sum(v_flat: torch.Tensor, pos: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """Each node's copies in the flattened cell-local output ``v_flat``
    (C, n_cells nloc) summed in slot order through the transposed scatter
    map (``pos``, ``valid``: :func:`_transposed_scatter_map`'s): (C,
    n_nodes), the same bits on every run."""
    valid = valid.to(v_flat.dtype)
    out = v_flat[:, pos[:, 0]] * valid[:, 0]
    for k in range(1, pos.shape[1]):
        out = out + v_flat[:, pos[:, k]] * valid[:, k]
    return out


def vmult(op: LaplaceOperatorData, u: torch.Tensor,
          constrained_identity: bool = True) -> torch.Tensor:
    """A u = M K M u (+ (I - M) u), M the unconstrained mask: constrained
    DoFs read as zero and receive nothing, and with
    ``constrained_identity`` copy the input (``poisson_operator.h:307-313``;
    the merged CG applies it without, as ``vmult_with_merged_sums``).
    ``u``: (C, n_nodes)."""
    mask = op.unconstrained[None, :]
    v = apply_cells(op, u * mask) * mask
    if constrained_identity:
        v = v + u * (1.0 - mask)
    return v


def tvmult(op: LaplaceOperatorData, u: torch.Tensor) -> torch.Tensor:
    """The transpose apply: the operator is symmetric
    (``poisson_operator.h:383-387``)."""
    return vmult(op, u)


def vmult_add(op: LaplaceOperatorData, dst: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """dst + A src with identity on the constrained rows (the slot of
    ``poisson_operator.h:318-325``, dead code in the reference)."""
    mask = op.unconstrained[None, :]
    return dst + apply_cells(op, src * mask) * mask + src * (1.0 - mask)


def assemble_dense(layout: DofLayout | GeneralDofLayout,
                   n_q: int | None = None,
                   apply_constraints: bool = True,
                   rule: str = "gauss") -> np.ndarray:
    """The dense scalar stiffness matrix (n_nodes, n_nodes) by
    straightforward quadrature assembly in f64: not sum-factorized, an
    independent check of the matrix-free operators on tiny meshes.  The
    vector operator is block diagonal with this block per component.
    ``rule="gll"``: the GLL(p+1) operator the preconditioner's diagonal is
    built from (``benchmark.h:124-154``)."""
    p = layout.degree
    if rule == "gll":
        shape = lagrange.make_shape_gll(p)
        q = p + 1
    else:
        q = n_q if n_q is not None else p + 2
        shape = lagrange.make_shape(p, q)
    nloc = (p + 1) ** 3

    # the full basis gradient table: gphi[a, q-point, e]
    V, D = shape.values, shape.grads
    gphi = np.zeros((nloc, q ** 3, 3))
    a = 0
    for k in range(p + 1):  # z
        for j in range(p + 1):  # y
            for i in range(p + 1):  # x
                gu = np.einsum("c,b,a->cba", V[:, k], V[:, j], D[:, i])
                gv = np.einsum("c,b,a->cba", V[:, k], D[:, j], V[:, i])
                gw = np.einsum("c,b,a->cba", D[:, k], V[:, j], V[:, i])
                gphi[a] = np.stack([gu.reshape(-1), gv.reshape(-1),
                                    gw.reshape(-1)], axis=-1)
                a += 1

    qz, qy, qx = np.meshgrid(shape.q_points, shape.q_points, shape.q_points,
                             indexing="ij")
    uvw = np.stack([qx, qy, qz], axis=-1).reshape(-1, 3)
    w = shape.q_weights
    w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(-1)
    coeffs = geometry.trilinear_coefficients(layout.mesh.cell_vertices)
    jinv, det = geometry.invert_3x3(geometry.jacobian(coeffs[:, None],
                                                      uvw[None]))
    G = ((det * w3[None])[..., None, None]
         * np.einsum("...ab,...cb->...ac", jinv, jinv))
    K_loc = np.einsum("aqe,nqef,bqf->nab", gphi, G, gphi)

    n = layout.n_nodes
    K = np.zeros((n, n))
    gmap = layout.gather_map
    for c in range(layout.mesh.n_cells):
        idx = gmap[c]
        K[np.ix_(idx, idx)] += K_loc[c]
    if apply_constraints:
        m = layout.boundary_node_mask
        K[m, :] = 0.0
        K[:, m] = 0.0
        K[m, m] = 1.0
    return K
