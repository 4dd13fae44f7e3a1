"""Degree-of-freedom numbering and Dirichlet constraints on the box mesh.

DoF nodes are numbered lexicographically over the global node lattice
(z slowest); a vector of ``C`` components is stored as ``(C, Nz, Ny, Nx)``
(or flat ``(C, n_nodes)``), so per-cell data is a strided window of the
lattice.  Every node on the domain boundary carries a zero Dirichlet value
for all components (``benchmark.h:91-120``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from mf_data_locality_tpu_torch.mesh.box import BoxMesh


def n_nodes_axis(n_cells_axis: tuple[int, int, int],
                 degree: int) -> tuple[int, int, int]:
    """(Nz, Ny, Nx) scalar-node lattice dimensions of a Q_degree space."""
    return tuple(degree * n + 1 for n in n_cells_axis)


@dataclass(frozen=True)
class DofLayout:
    """DoF numbering of a continuous Q_p space on a structured box mesh."""

    mesh: BoxMesh
    degree: int

    @property
    def n_nodes_axis(self) -> tuple[int, int, int]:
        """(Nz, Ny, Nx) scalar-node lattice dimensions."""
        return n_nodes_axis(self.mesh.n_cells_axis, self.degree)

    @property
    def n_nodes(self) -> int:
        nz, ny, nx = self.n_nodes_axis
        return nz * ny * nx

    @cached_property
    def gather_map(self) -> np.ndarray:
        """(n_cells, (p+1)^3) int32: global node id for each cell-local node.

        Cell-local nodes in lexicographic (z, y, x) order, x fastest; cells in
        lexicographic order, z slowest (matching :class:`BoxMesh`).  The
        native builder where it loads (``mf_data_locality_tpu_torch.
        native``), as the JAX package's.
        """
        if self.n_nodes < np.iinfo(np.int32).max:
            from mf_data_locality_tpu_torch import native
            if native.AVAILABLE:
                return native.gather_map(self.degree, *self.mesh.n_cells_axis)
        return gather_map_np(self.degree, self.mesh.n_cells_axis)

    @cached_property
    def boundary_node_mask(self) -> np.ndarray:
        """(n_nodes,) bool: True where the node lies on the domain boundary
        (the native builder where it loads)."""
        from mf_data_locality_tpu_torch import native
        if native.AVAILABLE:
            return native.boundary_mask(*self.n_nodes_axis)
        return boundary_node_mask(self.n_nodes_axis)


def gather_map_np(p: int, n_cells_axis: tuple[int, int, int]) -> np.ndarray:
    """:attr:`DofLayout.gather_map` in NumPy."""
    ncz, ncy, ncx = n_cells_axis
    nz, ny, nx = n_nodes_axis(n_cells_axis, p)
    cz, cy, cx = np.meshgrid(
        np.arange(ncz), np.arange(ncy), np.arange(ncx), indexing="ij"
    )
    base = ((p * cz) * ny + p * cy) * nx + p * cx  # node (0,0,0) of each cell
    k, j, i = np.meshgrid(
        np.arange(p + 1), np.arange(p + 1), np.arange(p + 1), indexing="ij"
    )
    local = (k * ny + j) * nx + i
    out = base.reshape(-1, 1) + local.reshape(1, -1)
    if out.max() >= np.iinfo(np.int32).max:
        raise ValueError("mesh too large for int32 gather indices")
    return out.astype(np.int32)


def boundary_node_mask(nodes_axis: tuple[int, int, int]) -> np.ndarray:
    """(Nz*Ny*Nx,) bool lattice mask of the boundary (constrained) nodes."""
    nz, ny, nx = nodes_axis
    m = np.zeros((nz, ny, nx), dtype=bool)
    m[0, :, :] = m[-1, :, :] = True
    m[:, 0, :] = m[:, -1, :] = True
    m[:, :, 0] = m[:, :, -1] = True
    return m.reshape(-1)
