"""Irregular (non-box) conforming hex meshes for the general backend.

Counterpart of ``mf_data_locality_tpu.mesh.general``.  The reference takes
any conforming hex mesh from deal.II/p4est (its mesh recipe is pluggable,
``common_code/benchmark.h:67-89``); here that slot is "any hex mesh
expressible as gather maps".  The general operator (:mod:`..ops.laplace`),
the preconditioner's diagonal (:mod:`..ops.diagonal`) and the cell-chunk
ranks (:mod:`..parallel.dist_general`) read only

  - ``mesh.cell_vertices``: (n_cells, 8, 3) corner coordinates in deal.II
    local order (bit0 -> x, bit1 -> y, bit2 -> z), and ``mesh.n_cells``,
  - ``gather_map``: (n_cells, (p+1)^3) int32 cell-to-node map,
  - ``boundary_node_mask``: (n_nodes,) Dirichlet flags,
  - ``n_nodes`` and ``degree``,

so any conforming hex mesh fits through :class:`GeneralDofLayout`.
:func:`macro_hex_layout` builds one from an active subset of a box's
cells (L-shapes, steps, holes).  Host-side NumPy, the same numbering as
the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np


@dataclass(frozen=True)
class GeneralHexMesh:
    """A conforming hex mesh as plain connectivity and coordinates."""

    vertices: np.ndarray  # (n_vertices, 3), coordinates (x, y, z)
    cells: np.ndarray  # (n_cells, 8) int, deal.II local corner order

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @cached_property
    def cell_vertices(self) -> np.ndarray:
        """(n_cells, 8, 3) corner coordinates (the geometry input of
        ``ops.geometry.trilinear_coefficients``)."""
        return np.asarray(self.vertices, np.float64)[self.cells]


@dataclass(frozen=True)
class GeneralDofLayout:
    """Q_p DoF layout on any conforming hex mesh: what the general path's
    consumers read of :class:`~.dofs.DofLayout` (``ops.laplace.
    make_operator`` / ``assemble_dense``, ``ops.diagonal.
    compute_inverse_diagonal``, ``parallel.dist_general``).  The kernels'
    lattice paths need the box and do not take it."""

    mesh: GeneralHexMesh
    degree: int
    gather_map: np.ndarray  # (n_cells, (p+1)^3) int32
    boundary_node_mask: np.ndarray  # (n_nodes,) bool

    @property
    def n_nodes(self) -> int:
        return self.boundary_node_mask.shape[0]

    @property
    def nodes_per_cell(self) -> int:
        return (self.degree + 1) ** 3


def _lex_keys(pts: np.ndarray) -> np.ndarray:
    """Lexicographic keys of (n, 3) (z, y, x) lattice points, z slowest."""
    span = pts.max(axis=0) + 1
    return (pts[:, 0] * span[1] + pts[:, 1]) * span[2] + pts[:, 2]


def macro_hex_layout(active_cells, degree: int, spacing: float = 1.0,
                     deform=None) -> GeneralDofLayout:
    """A :class:`GeneralDofLayout` of an active macro-cell set.

    ``active_cells``: (n_cells, 3) int array of (cz, cy, cx) unit-cell
    positions, any subset of a box lattice, in the order the cells are
    numbered.  Zero Dirichlet conditions on the whole domain boundary
    (every face not shared by two active cells), the BP4 protocol
    (``benchmark.h:96-102``).  Nodes are numbered lexicographically over
    the lattice points the cells touch, z slowest; vertices likewise.
    ``deform``: an optional map of the vertex coordinates, ``(n, 3) ->
    (n, 3)`` in (x, y, z); conformity only needs the connectivity to be a
    lattice subset.
    """
    cells = np.asarray(active_cells, np.int64)
    if cells.ndim != 2 or cells.shape[1] != 3:
        raise ValueError("active_cells must be (n_cells, 3) (cz, cy, cx)")
    if not len(cells) or cells.min() < 0:
        raise ValueError("active_cells must be a non-empty set of "
                         "non-negative positions")
    p, n_cells = degree, len(cells)
    if np.unique(_lex_keys(cells)).size != n_cells:
        raise ValueError("duplicate active cells")

    # scalar nodes: the union of each cell's (p+1)^3 lattice points
    k = np.arange(p + 1)
    loc = np.stack(np.meshgrid(k, k, k, indexing="ij"), axis=-1).reshape(-1, 3)
    pts = (cells[:, None, :] * p + loc[None]).reshape(-1, 3)
    uniq, inv = np.unique(_lex_keys(pts), return_inverse=True)
    gather = inv.reshape(n_cells, -1).astype(np.int32)

    # the Dirichlet mask: the nodes of every face without a neighbour,
    # looked up in an occupancy grid padded by one cell on each side
    occ = np.zeros(tuple(cells.max(axis=0) + 3), bool)
    occ[tuple((cells + 1).T)] = True
    boundary = np.zeros(uniq.size, bool)
    g3 = gather.reshape(n_cells, p + 1, p + 1, p + 1)
    for axis in range(3):
        for side in (-1, 1):
            nb = cells + 1
            nb[:, axis] += side
            open_ = ~occ[tuple(nb.T)]
            face = np.take(g3[open_], 0 if side < 0 else p, axis=axis + 1)
            boundary[face.reshape(-1)] = True

    # vertices and the cell connectivity: corner rows (dz, dy, dx), dx
    # fastest, are deal.II's order v -> (x = v & 1, y = v >> 1 & 1,
    # z = v >> 2)
    corner = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                      axis=-1).reshape(-1, 3)
    cflat = (cells[:, None, :] + corner[None]).reshape(-1, 3)
    vspan = cflat.max(axis=0) + 1
    vuniq, vinv = np.unique(_lex_keys(cflat), return_inverse=True)
    conn = vinv.reshape(n_cells, 8).astype(np.int64)
    vz = vuniq // (vspan[1] * vspan[2])
    vy = (vuniq // vspan[2]) % vspan[1]
    vx = vuniq % vspan[2]
    verts = np.stack([vx, vy, vz], axis=-1).astype(np.float64) * spacing
    if deform is not None:
        verts = np.asarray(deform(verts), np.float64)

    return GeneralDofLayout(mesh=GeneralHexMesh(vertices=verts, cells=conn),
                            degree=degree, gather_map=gather,
                            boundary_node_mask=boundary)
