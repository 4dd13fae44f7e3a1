"""Data-locality DoF renumbering for the gather/scatter backend (NumPy).

Counterpart of ``mf_data_locality_tpu.mesh.renumber``: the capability of
``Renumber<dim, Number>`` (``common_code/renumber_dofs_for_mf.h:15-145``)
with the benchmark's strategy triple (0, 1, 2) = (cell assembly, first
touch, touch-count grouping, ``benchmark.h:112``).  The permutation orders
the scalar nodes so that nodes touched by one cell come first in
first-touch sweep order, nodes shared between cells follow, and ghost
nodes (shared with other partitions) come last.  The structured lattice
has this order by construction; the general backend (``ops/laplace``)
uses it.  The JAX package also has a native C++ path for the default
strategies; here :func:`locality_permutation` is the NumPy path always
(the native library is queue A item 7 of ``ROADMAP.md``).
"""

from __future__ import annotations

import numpy as np


def locality_permutation_np(gather: np.ndarray, n_nodes: int,
                            ghost_flags: np.ndarray | None = None,
                            touch_order: str = "first",
                            grouping: str = "touch_count",
                            batch_cells: int | None = None,
                            ) -> tuple[np.ndarray, int]:
    """Locality permutation: returns (perm old -> new, n_interior).

    ``touch_order``: "first" (``first_touch_renumber`` :461-474) or "last"
    (``last_touch_renumber`` :476-490).  ``grouping``: "touch_count"
    (:556-590), "none" (``base_grouping`` :537-554: sweep order only,
    ghosts last) or "touch_count_cellbatch" (:592-620: a node shared only
    within one cell batch counts as touched once).  ``batch_cells``
    quantizes the sweep positions to batches of that many cells
    (``cellbatch_assembly`` :363-459): nodes first touched by one batch tie
    in sweep order and keep their old relative order.
    """
    flat = gather.reshape(-1)
    nodes_per_cell = gather.shape[-1] if gather.ndim > 1 else 1
    touch = np.bincount(flat, minlength=n_nodes)

    if batch_cells:
        pos = np.arange(flat.size) // (nodes_per_cell * batch_cells)
    else:
        pos = np.arange(flat.size)

    # touch order: first/last batch (or flat position) in the cell sweep
    order_idx = np.full(n_nodes, flat.size, dtype=np.int64)
    if touch_order == "first":
        np.minimum.at(order_idx, flat, pos)
    elif touch_order == "last":
        order_idx[:] = -1
        np.maximum.at(order_idx, flat, pos)
        order_idx[order_idx < 0] = flat.size
    else:
        raise ValueError(touch_order)
    order_rank = np.argsort(np.argsort(order_idx, kind="stable"), kind="stable")

    if ghost_flags is None:
        ghost_flags = np.zeros(n_nodes, dtype=bool)
    if grouping == "touch_count":
        cls = np.where(ghost_flags, 2, np.where(touch == 1, 0, 1))
    elif grouping == "touch_count_cellbatch":
        bc = batch_cells or 1
        batch_of_slot = np.arange(flat.size) // (nodes_per_cell * bc)
        nb = int(batch_of_slot[-1]) + 1 if flat.size else 1
        pairs = np.unique(flat.astype(np.int64) * nb + batch_of_slot)
        touch_b = np.bincount(pairs // nb, minlength=n_nodes)
        cls = np.where(ghost_flags, 2, np.where(touch_b <= 1, 0, 1))
    elif grouping == "none":
        cls = np.where(ghost_flags, 2, 0)
    else:
        raise ValueError(grouping)
    key = cls.astype(np.int64) * (2 * n_nodes + flat.size) + order_rank
    order = np.argsort(key, kind="stable")
    perm = np.empty(n_nodes, dtype=np.int32)
    perm[order] = np.arange(n_nodes, dtype=np.int32)
    n_interior = int(np.count_nonzero((cls == 0) & ~ghost_flags & (touch == 1)))
    return perm, n_interior


def locality_permutation(gather: np.ndarray, n_nodes: int,
                         ghost_flags: np.ndarray | None = None,
                         touch_order: str = "first",
                         grouping: str = "touch_count",
                         batch_cells: int | None = None,
                         ) -> tuple[np.ndarray, int]:
    """The locality permutation, by :func:`locality_permutation_np`."""
    return locality_permutation_np(gather, n_nodes, ghost_flags,
                                   touch_order=touch_order, grouping=grouping,
                                   batch_cells=batch_cells)


def apply_permutation(gather: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Renumbered gather map: new node ids at the same cell-local slots."""
    return perm[gather]


def permute_nodes(arr: np.ndarray, perm: np.ndarray, axis: int = -1
                  ) -> np.ndarray:
    """Reorder a per-node array into the new numbering (out[perm[i]] = in[i])."""
    out = np.empty_like(arr)
    idx = [slice(None)] * arr.ndim
    idx[axis] = perm
    out[tuple(idx)] = arr
    return out
