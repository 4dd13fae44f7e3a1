"""The distributed general (gather/scatter) backend: a cell-chunk
decomposition over rank processes.

Counterpart of ``mf_data_locality_tpu.parallel.dist_general``: the
reference decomposes any p4est mesh over MPI ranks
(``common_code/benchmark.h:79``) and relies on the renumbering's rank-set
grouping so that each rank's halo is a few contiguous index ranges
(``renumber_dofs_for_mf.h:492-535, 673-730``).  On the general backend
(:mod:`~mf_data_locality_tpu_torch.ops.laplace`, plain PyTorch: the JAX
backend is plain XLA, no Pallas kernel):

* **Partition**: the cells in contiguous chunks of ceil(n_cells / N) in
  sweep order (the space-filling-curve partition's analog); each node is
  owned by the lowest rank whose cells touch it (first touch,
  ``domain_dof_mapping``, :673-730).
* **Local numbering**: each rank numbers its nodes by
  :func:`~mf_data_locality_tpu_torch.mesh.renumber.locality_permutation`
  under its real ghost flags (interior, shared, ghosts last), then a
  rank-set pass moves the exports (owned nodes other ranks read) to the
  end of the owned block and sorts the ghosts by (owner offset, global
  id): the import halo is a trailing slice, one contiguous sub-slice an
  owner.
* **Ghost exchange**: one shift an owner-to-reader rank offset each way
  (:meth:`~.comm.Comm.shift` with ``step``; a z-slab cut has offset 1
  only, thinner chunks also 2, ...): the ghosts' partial sums to the owner
  (compress), the owners' completed values back (update ghost values),
  ``poisson_operator.h:310,339``.  Both ends order each (owner, reader)
  set by global id.
* **Dots**: weight 0 on ghosts and padding, so one all-reduce of the
  merged CG's 7 sums an iteration (``poisson_operator.h:373-375``).

Every rank holds arrays of one shape: node, cell, scatter multiplicity and
halo widths padded to the largest rank's, with a dead node (zero mask and
weight) and dummy cells of replicated real geometry whose gather points at
it (``poisson_operator.h:269-280``).  Each rank builds the decomposition of
the whole mesh on the host, which is cheap, and keeps its own part.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from mf_data_locality_tpu_torch.mesh import renumber as rn
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.mesh.general import GeneralDofLayout
from mf_data_locality_tpu_torch.ops import diagonal, geometry, lagrange, laplace
from mf_data_locality_tpu_torch.parallel.comm import Comm
from mf_data_locality_tpu_torch.solvers import cg, cg_merged
from mf_data_locality_tpu_torch.solvers.cg import SolveResult


@dataclass(frozen=True)
class GeneralProblem:
    """One rank's part of the general-backend problem (the JAX
    ``DistributedGeneral``'s per-device arrays), on the rank's device:
    ``op`` on its NL local nodes (the last one dead), ``inv_diag`` (1, NL),
    ``b`` (C, NL), ``weight`` (1, NL) (1 on owned real nodes),
    ``export_idx`` / ``import_idx`` (n_offsets, E) (local ids read by rank
    + off / ghosts owned by rank - off, padded with the dead node) and the
    rank ``offsets``."""

    op: laplace.LaplaceOperatorData
    inv_diag: torch.Tensor
    b: torch.Tensor
    weight: torch.Tensor
    export_idx: torch.Tensor
    import_idx: torch.Tensor
    offsets: tuple
    n_dofs: int
    n_cells: int


def _partition_cells(n_cells: int, n_ranks: int) -> list[np.ndarray]:
    """Contiguous sweep-order cell chunks, ceil-sized (benchmark.h:79)."""
    cpr = -(-n_cells // n_ranks)
    return [np.arange(r * cpr, min((r + 1) * cpr, n_cells))
            for r in range(n_ranks)]


def decompose(layout: DofLayout | GeneralDofLayout, n_ranks: int
              ) -> tuple[list[dict], tuple[int, ...]]:
    """The host decomposition (``_decompose``): per rank its cells, global
    ids ``gids`` (old-local order), the locality-renumbered local gather
    map, ``order`` (new-local -> old-local), the per-offset export and
    import ids (new-local, global-id order) and ``owner_mask``
    (old-local); and the rank offsets present anywhere."""
    gather = np.asarray(layout.gather_map)
    n_cells, nloc = gather.shape
    n = layout.n_nodes
    if n_ranks > n_cells:
        raise ValueError(f"{n_ranks} ranks > {n_cells} cells")
    chunks = _partition_cells(n_cells, n_ranks)
    cell_rank = np.empty(n_cells, np.int64)
    for r, ch in enumerate(chunks):
        cell_rank[ch] = r
    rank_of_slot = np.repeat(cell_rank, nloc)
    flat = gather.reshape(-1).astype(np.int64)
    # first-touch ownership (domain_dof_mapping, :673-730)
    owner = np.full(n, n_ranks, np.int64)
    np.minimum.at(owner, flat, rank_of_slot)
    # the (node, touching rank) relation: the reference's rank sets
    pairs = np.unique(flat * n_ranks + rank_of_slot)
    pair_node, pair_rank = pairs // n_ranks, pairs % n_ranks
    reader = pair_rank != owner[pair_node]
    offsets = tuple(sorted(np.unique(
        (pair_rank - owner[pair_node])[reader]).tolist()))

    per_rank = []
    for r, ch in enumerate(chunks):
        gids = np.unique(gather[ch].reshape(-1))
        g2l = np.full(n, -1, np.int64)
        g2l[gids] = np.arange(gids.size)
        gather_r = g2l[gather[ch]].astype(np.int32)
        ghost_flags = owner[gids] != r
        base_perm, _ = rn.locality_permutation(gather_r, gids.size,
                                               ghost_flags=ghost_flags)
        # the rank-set pass: exports last in the owned block (by gid),
        # ghosts by (owner offset, gid)
        exported = np.zeros(n, bool)
        exported[pair_node[reader & (owner[pair_node] == r)]] = True
        export_flags = (~ghost_flags) & exported[gids]
        cls = np.where(ghost_flags, 2, np.where(export_flags, 1, 0))
        delta = np.where(ghost_flags, r - owner[gids], 0)
        within = np.where(cls == 0, base_perm.astype(np.int64),
                          delta * n + gids)
        order = np.lexsort((within, cls))
        perm = np.empty(gids.size, np.int32)
        perm[order] = np.arange(gids.size, dtype=np.int32)
        exports, imports = {}, {}
        for off in offsets:
            is_reader = (pair_rank == r + off) & (owner[pair_node] == r)
            eg = np.intersect1d(pair_node[is_reader], gids)
            exports[off] = perm[g2l[eg]]
            ig = gids[ghost_flags & (owner[gids] == r - off)]
            imports[off] = perm[g2l[np.sort(ig)]]
        per_rank.append(dict(
            cells=ch, gids=gids, n_local=gids.size,
            gather=rn.apply_permutation(gather_r, perm),
            order=np.argsort(perm), exports=exports, imports=imports,
            owner_mask=~ghost_flags))
    return per_rank, offsets


def general_arrays(layout: DofLayout | GeneralDofLayout, n_ranks: int,
                   n_components: int = 3
                   ) -> tuple[list[dict], tuple[int, ...]]:
    """Every rank's host arrays (f64 NumPy; ``build_dist_general``'s):
    ``coeffs`` (NC, 8, 3), ``gather`` (NC, nloc), ``uncon`` (NL,),
    ``pos`` / ``valid`` (NL, KM), ``inv`` (1, NL), ``b`` (C, NL),
    ``weight`` (1, NL), ``exp`` / ``imp`` (n_offsets, E); and the
    offsets."""
    per_rank, offsets = decompose(layout, n_ranks)
    n = layout.n_nodes
    dof = np.arange(n)[:, None] * n_components + np.arange(n_components)
    b_glob = (dof % 8).astype(np.float64)
    b_glob[layout.boundary_node_mask] = 0.0
    b_glob = b_glob.T
    inv_glob = diagonal.compute_inverse_diagonal(layout)
    uncon_glob = (~layout.boundary_node_mask).astype(np.float64)
    coeffs_glob = geometry.trilinear_coefficients(layout.mesh.cell_vertices)

    NL = max(pr["n_local"] for pr in per_rank) + 1  # + the dead node
    NC = max(len(pr["cells"]) for pr in per_rank)
    E = max((pr[k][o].size for pr in per_rank for o in offsets
             for k in ("exports", "imports")), default=0)
    dead = NL - 1
    out = []
    for pr in per_rank:
        nl, ncr = pr["n_local"], len(pr["cells"])
        n_ghost = int((~pr["owner_mask"]).sum())
        gl_new = pr["gids"][pr["order"]]
        gather = np.full((NC, pr["gather"].shape[1]), dead, np.int32)
        gather[:ncr] = pr["gather"]
        co = np.empty((NC, 8, 3))
        co[:ncr] = coeffs_glob[pr["cells"]]
        co[ncr:] = coeffs_glob[pr["cells"][0]]  # replicated real geometry
        uncon = np.zeros(NL)
        uncon[:nl] = uncon_glob[gl_new]
        # the real cells' scatter map: the dead node's row stays invalid
        pos, valid = laplace._transposed_scatter_map(pr["gather"], NL)
        inv = np.ones((1, NL))
        inv[0, :nl] = inv_glob[gl_new]
        b = np.zeros((n_components, NL))
        b[:, :nl] = b_glob[:, gl_new]
        weight = np.zeros((1, NL))
        weight[0, :nl - n_ghost] = 1.0
        exp = np.full((len(offsets), E), dead, np.int32)
        imp = np.full((len(offsets), E), dead, np.int32)
        for k, off in enumerate(offsets):
            exp[k, :pr["exports"][off].size] = pr["exports"][off]
            imp[k, :pr["imports"][off].size] = pr["imports"][off]
        out.append(dict(coeffs=co, gather=gather, uncon=uncon, pos=pos,
                        valid=valid, inv=inv, b=b, weight=weight, exp=exp,
                        imp=imp))
    km = max(a["pos"].shape[1] for a in out)
    for a in out:  # the scatter multiplicity padded to the mesh's largest
        pad = ((0, 0), (0, km - a["pos"].shape[1]))
        a["pos"], a["valid"] = np.pad(a["pos"], pad), np.pad(a["valid"], pad)
    return out, offsets


def _problem(degree: int, a: dict, offsets, n_dofs: int, n_cells: int,
             dtype: torch.dtype, device) -> GeneralProblem:
    """A :class:`GeneralProblem` of one rank's host arrays ``a``
    (:func:`general_arrays`' keys)."""
    q = degree + 2
    shape = lagrange.make_shape(degree, q)
    qz, qy, qx = np.meshgrid(shape.q_points, shape.q_points, shape.q_points,
                             indexing="ij")
    w = shape.q_weights

    def t(x, to=dtype):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device=device,
                                                           dtype=to)

    op = laplace.LaplaceOperatorData(
        values=t(shape.values), d_col=t(shape.d_col),
        q_uvw=t(np.stack([qx, qy, qz], axis=-1).reshape(-1, 3)),
        q_w3=t((w[:, None, None] * w[None, :, None]
                * w[None, None, :]).reshape(-1)),
        coeffs=t(a["coeffs"]), gather=t(a["gather"], torch.int64),
        unconstrained=t(a["uncon"]), scatter_pos=t(a["pos"], torch.int64),
        scatter_valid=t(a["valid"]))
    return GeneralProblem(
        op=op, inv_diag=t(a["inv"]), b=t(a["b"]), weight=t(a["weight"]),
        export_idx=t(a["exp"], torch.int64),
        import_idx=t(a["imp"], torch.int64), offsets=tuple(offsets),
        n_dofs=n_dofs, n_cells=n_cells)


def build_general(s: int, degree: int, rank: int, n_ranks: int,
                  dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cuda",
                  n_components: int = 3,
                  layout: DofLayout | GeneralDofLayout | None = None
                  ) -> GeneralProblem:
    """Rank ``rank``'s part of BP4 on 2**s cells over ``n_ranks`` ranks on
    the general backend (``build_dist_general``).  ``layout``: the box's
    or any conforming hex mesh's (a :class:`~mf_data_locality_tpu_torch.
    mesh.general.GeneralDofLayout`, e.g. ``macro_hex_layout``'s L-shape);
    ``s`` is ignored then."""
    if layout is None:
        layout = DofLayout(BoxMesh.from_s(s), degree)
    arrays, offsets = general_arrays(layout, n_ranks, n_components)
    return _problem(degree, arrays[rank], offsets,
                    layout.n_nodes * n_components, layout.mesh.n_cells,
                    dtype, device)


def general_from_jax_arrays(*, degree: int, values, d_col, q_uvw, q_w3,
                            coeffs, gather, unconstrained, scatter_pos,
                            scatter_valid, inv_diag, b, weight, export_idx,
                            import_idx, offsets, n_dofs: int, n_cells: int,
                            device: torch.device | str = "cuda"
                            ) -> GeneralProblem:
    """A rank's :class:`GeneralProblem` from the arrays of a JAX
    ``DistributedGeneral`` at that rank (its ``op_stack`` leaves,
    ``inv_diag``, ``b``, ``weight``, ``export_idx``, ``import_idx``,
    indexed by the rank, as host arrays; ``offsets``, ``n_dofs``,
    ``n_cells``), carried across value for value."""
    def t(x, to=None):
        x = torch.as_tensor(np.ascontiguousarray(np.asarray(x)))
        return x.to(device=device, dtype=to or x.dtype)

    dtype = t(values).dtype
    op = laplace.LaplaceOperatorData(
        values=t(values), d_col=t(d_col), q_uvw=t(q_uvw), q_w3=t(q_w3),
        coeffs=t(coeffs), gather=t(gather, torch.int64),
        unconstrained=t(unconstrained),
        scatter_pos=t(scatter_pos, torch.int64),
        scatter_valid=t(scatter_valid, dtype))
    if op.degree != degree:
        raise ValueError(f"the arrays are of degree {op.degree}, not "
                         f"{degree}")
    return GeneralProblem(
        op=op, inv_diag=t(inv_diag), b=t(b), weight=t(weight),
        export_idx=t(export_idx, torch.int64),
        import_idx=t(import_idx, torch.int64), offsets=tuple(offsets),
        n_dofs=n_dofs, n_cells=n_cells)


def dist_vmult_general(prob: GeneralProblem, comm: Comm, u: torch.Tensor,
                       constrained_identity: bool = True) -> torch.Tensor:
    """The operator on a rank's local vector (C, NL)
    (``dist_vmult_general``): the masked local gather, apply and scatter
    (``laplace.apply_cells``); then, an offset after another, one shift
    of the ghosts' partial sums to their owners, added to the exports; an
    offset after another, one shift of the exports' completed values back
    into the readers' ghosts; the mask again, plus u at the constrained
    nodes when ``constrained_identity``.  Padded halo slots are the dead
    node, whose value is 0, so they exchange zeros."""
    mask = prob.op.unconstrained[None]
    raw = laplace.apply_cells(prob.op, u * mask)
    if comm.size > 1:
        exp, imp = prob.export_idx, prob.import_idx
        for k, off in enumerate(prob.offsets):  # compress
            recv = comm.shift([raw[:, imp[k]]], up=False, step=off)
            if recv is not None:
                raw[:, exp[k]] += recv[0]
        for k, off in enumerate(prob.offsets):  # update ghost values
            recv = comm.shift([raw[:, exp[k]]], up=True, step=off)
            if recv is not None:
                raw[:, imp[k]] = recv[0]
    v = raw * mask
    if constrained_identity:
        v = v + u * (1.0 - mask)
    return v


def solve_general(prob: GeneralProblem, comm: Comm, solver: str = "merged",
                  max_iter: int = 100, rel_tol: float = 1e-8) -> SolveResult:
    """The rank's part of the distributed CG on the general backend
    (``solve_general``): the merged solver one all-reduce of 7 sums an
    iteration beside the shifts of each apply, the baseline solver one a
    dot product; x is the rank's local vector (C, NL)."""
    a = partial(dist_vmult_general, prob, comm,
                constrained_identity=(solver == "baseline"))
    if solver == "merged":
        return cg_merged.merged_cg_solve(
            a, prob.b, prob.inv_diag, max_iter=max_iter, rel_tol=rel_tol,
            reduce_sums=comm.allreduce, dot_weight=prob.weight)
    if solver == "baseline":
        return cg.cg_solve(a, prob.b, prob.inv_diag, max_iter=max_iter,
                           rel_tol=rel_tol, reduce_scalar=comm.allreduce,
                           dot_weight=prob.weight)
    raise ValueError(f"unknown solver {solver!r}")


def gather_global_general(xs, layout: DofLayout | GeneralDofLayout,
                          n_components: int = 3) -> torch.Tensor:
    """The ranks' local vectors (C, NL), in rank order, -> the global
    (C, n_nodes) vector (``gather_global_general``): each rank's owned
    nodes at their global ids."""
    per_rank, _ = decompose(layout, len(xs))
    out = torch.zeros((n_components, layout.n_nodes), dtype=xs[0].dtype)
    for x, pr in zip(xs, per_rank):
        own = pr["owner_mask"]  # old-local
        perm = np.empty(pr["n_local"], np.int64)
        perm[pr["order"]] = np.arange(pr["n_local"])
        out[:, torch.as_tensor(pr["gids"][own])] = x.cpu()[
            :, torch.as_tensor(perm[own])]
    return out
