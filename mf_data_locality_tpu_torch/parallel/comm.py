"""Rank processes and their collectives: the port's counterpart of the JAX
package's ``shard_map`` region with its ``ppermute`` halos and its ``psum``
of the seven sums (``mf_data_locality_tpu/parallel/distributed.py``,
``dist_fused.py``).

A distributed solve runs one process per rank (:func:`run`):

* the processes start by ``torch.multiprocessing``'s spawn method (a fork
  after CUDA initialisation breaks) and meet through a ``file://`` store in
  a temporary directory, so concurrent runs never share a TCP port;
* rank r works on ``cuda:{r % device_count}``, or on the CPU where the
  caller asks for it (one torch thread a rank);
* the transport is gloo.  gloo does no point-to-point on CUDA tensors, so
  a halo plane goes through pinned host buffers (:meth:`Comm.shift`), and
  the all-reduce of the seven sums is one call on their host copy
  (:meth:`Comm.allreduce`).  NCCL with one card per rank is queued
  (ROADMAP.md, queue A item 9b): NCCL refuses two ranks on one card.
* the ranks form a Cartesian grid (:meth:`Comm.set_mesh`): ``(N,)`` for
  z-slabs, ``(Dz, Dy)`` or ``(Dz, Dy, Dx)`` for blocks, laid out
  row-major as the JAX ``Mesh(devices.reshape(mesh_shape))`` is; a
  2-level ``(n_slices, chips)`` grid runs the z-slabs over both axes
  flattened row-major, slab k on slice k // chips (the JAX package's
  ``axis=(AXIS_DCN, AXIS)``).
* a rank that raises fails the run: ``spawn`` stops the others and
  re-raises, and nothing here catches it.  No compute moves to the CPU.

:class:`Comm` counts what a rank does: ``allreduces`` (calls of
:meth:`Comm.allreduce`) and ``shifts`` (calls of :meth:`Comm.shift`: in
one shift every rank sends one message to its neighbour on one side along
one axis of the grid and receives one from the other side, the JAX
package's one ``ppermute``),
and the host seconds spent in them (``seconds``: ``"d2h"`` the copies of
the planes to the host, which wait for the device's work before them;
``"wait"`` the messages, which wait for the neighbours; ``"h2d"`` the
copies back; ``"allreduce"``).
"""

from __future__ import annotations

import datetime
import math
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

TRANSPORT = "gloo"
_ALIGN = 8  # byte offset of each plane in a packed message


class Comm:
    """One rank's view of the process group: its rank, the rank count,
    its device, its place in the rank grid, and counters of its
    collectives."""

    def __init__(self, rank: int, size: int, device: torch.device):
        self.rank, self.size, self.device = rank, size, torch.device(device)
        self.allreduces = 0
        self.shifts = 0
        self.seconds = dict.fromkeys(("d2h", "wait", "h2d", "allreduce"),
                                     0.0)
        self._buffers: dict[Any, tuple] = {}
        self.set_mesh((size,))

    def set_mesh(self, mesh_shape: tuple[int, ...]) -> None:
        """Lay the ranks out as a row-major grid of ``mesh_shape`` (its
        product the rank count); ``coords`` is this rank's place in it."""
        if math.prod(mesh_shape) != self.size:
            raise ValueError(f"mesh {mesh_shape} does not hold {self.size} "
                             f"ranks")
        self.mesh_shape = tuple(mesh_shape)
        self.coords = _unravel(self.rank, self.mesh_shape)

    def neighbour(self, axis: int | tuple[int, ...], step: int) -> int | None:
        """The rank ``step`` places away along ``axis`` of the grid (a tuple:
        those axes flattened row-major), or None past the grid's edge."""
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        dims = tuple(self.mesh_shape[a] for a in axes)
        k = _ravel(tuple(self.coords[a] for a in axes), dims) + step
        if not 0 <= k < math.prod(dims):
            return None
        coords = list(self.coords)
        for a, c in zip(axes, _unravel(k, dims)):
            coords[a] = c
        return _ravel(tuple(coords), self.mesh_shape)

    def reset(self) -> None:
        """Zero the counters and the seconds."""
        self.allreduces = self.shifts = 0
        self.seconds = dict.fromkeys(self.seconds, 0.0)

    def allreduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``t`` (a few scalars), on ``t``'s
        device: one all-reduce."""
        self.allreduces += 1
        t0 = time.perf_counter()
        host = t.detach().to("cpu", copy=True)
        dist.all_reduce(host)
        out = host.to(t.device)
        self.seconds["allreduce"] += time.perf_counter() - t0
        return out

    def _packed(self, planes: Sequence[torch.Tensor]):
        # one byte buffer a direction for the planes' shapes and dtypes,
        # pinned when the rank works on a card; typed views into it
        key = tuple((tuple(p.shape), p.dtype) for p in planes)
        if key not in self._buffers:
            offsets, total = [], 0
            for p in planes:
                offsets.append(total)
                n = p.numel() * p.element_size()
                total += -(-n // _ALIGN) * _ALIGN
            pin = self.device.type == "cuda"
            bufs = tuple(torch.empty(total, dtype=torch.uint8, pin_memory=pin)
                         for _ in range(2))
            views = tuple(
                [b[o:o + p.numel() * p.element_size()].view(p.dtype)
                 .view(p.shape) for o, p in zip(offsets, planes)]
                for b in bufs)
            self._buffers[key] = bufs + views
        return self._buffers[key]

    def shift(self, planes: Sequence[torch.Tensor], up: bool,
              axis: int | tuple[int, ...] = 0) -> list[torch.Tensor] | None:
        """Send ``planes`` (this rank's tensors, packed into one message) to
        the neighbour above (``up``) or below along ``axis`` of the grid
        (:meth:`neighbour`), and receive the same planes of the neighbour
        on the other side: copies on this rank's device, or None where
        that neighbour does not exist (the first rank of the axis
        receiving from below, the last from above)."""
        self.shifts += 1
        dst = self.neighbour(axis, 1 if up else -1)
        src = self.neighbour(axis, -1 if up else 1)
        send_buf, recv_buf, send_views, recv_views = self._packed(planes)
        t0 = time.perf_counter()
        reqs = []
        if dst is not None:
            for v, p in zip(send_views, planes):
                v.copy_(p)  # from a card: synchronous into pinned memory
            reqs.append(dist.isend(send_buf, dst))
        t1 = time.perf_counter()
        if src is not None:
            reqs.append(dist.irecv(recv_buf, src))
        for r in reqs:
            r.wait()
        t2 = time.perf_counter()
        out = (None if src is None else
               [v.to(self.device, copy=True) for v in recv_views])
        sec = self.seconds
        sec["d2h"] += t1 - t0
        sec["wait"] += t2 - t1
        sec["h2d"] += time.perf_counter() - t2
        return out


def _ravel(coords: tuple[int, ...], dims: tuple[int, ...]) -> int:
    k = 0
    for c, n in zip(coords, dims):
        k = k * n + c
    return k


def _unravel(k: int, dims: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for n in reversed(dims):
        out.append(k % n)
        k //= n
    return tuple(reversed(out))


def rank_device(rank: int, device: str) -> torch.device:
    """The device of ``rank``: ``cuda:{rank % device_count}`` for a CUDA
    run, else the CPU."""
    if torch.device(device).type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _rank_main(rank: int, size: int, device: str, tmp: str) -> None:
    with open(Path(tmp) / "call.pkl", "rb") as f:
        target, args = pickle.load(f)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(TRANSPORT, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=size,
                            timeout=datetime.timedelta(minutes=15))
    try:
        out = target(Comm(rank, size, dev), *args)
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run(target: Callable[..., Any], n_ranks: int, args: tuple = (),
        device: str = "cuda") -> list[Any]:
    """``target(comm, *args)`` on ``n_ranks`` rank processes; returns each
    rank's return value (torch-saveable), in rank order.

    ``target`` and ``args`` are pickled once into the run's temporary
    directory, which every rank reads (``target`` a module-level function
    of this package): the spawn passes only the directory, so the
    processes start together however large ``args`` is.  For a CUDA run
    the kernel library is built here first, so that the ranks load it and
    never compile it; raises without a card.
    """
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA run of the ranks needs a CUDA device")
        from mf_data_locality_tpu_torch.ops import _build

        _build.build()
    with tempfile.TemporaryDirectory(prefix="bp4_ranks_") as tmp:
        with open(Path(tmp) / "call.pkl", "wb") as f:
            pickle.dump((target, args), f)
        torch.multiprocessing.spawn(_rank_main,
                                    args=(n_ranks, device, tmp),
                                    nprocs=n_ranks, join=True)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(n_ranks)]


def describe(n_ranks: int, device: str) -> str:
    """The run's transport: ``gloo, 4 ranks on 1 x <card name>``."""
    if torch.device(device).type == "cuda":
        n = min(n_ranks, torch.cuda.device_count())
        where = f"{n} x {torch.cuda.get_device_name(0)}"
    else:
        where = "the CPU"
    return f"{TRANSPORT}, {n_ranks} ranks on {where}"
