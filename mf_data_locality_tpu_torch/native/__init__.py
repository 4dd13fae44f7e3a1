"""ctypes bindings of the native C++ host setup (the repo's
``native/setup.cc``): the port's counterpart of ``mf_data_locality_tpu.
native``.

The library is built from that source with ``g++`` at its first use (the
first read of :data:`AVAILABLE`, which the callers make before they call
an entry point; importing the module builds nothing), into the port's
``_kernel_build/`` (gitignored) under a name keyed by a
hash of the source and the flags: under an exclusive lock on a file beside
it, to a temporary name, then ``os.replace``d into place, so processes
that import the package at once (pytest's workers, the rank processes)
build it once and never load a half-written file.  Every entry point has
a NumPy counterpart in the package (``mesh/dofs.py``, ``mesh/box.py``,
``mesh/renumber.py``, ``ops/laplace_cuda.metric_entries``), which the
callers take where :data:`AVAILABLE` is False (no ``g++``, or the build
failed), as the JAX package's callers do.  The integer entry points and
``trilinear_coefficients`` return the NumPy paths' arrays bit for bit;
``vertex_lattice`` (``std::sin``) and ``metric_entries`` (another
evaluation order) agree with them to a few units in the last place.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "setup.cc"
BUILD_DIR = _PKG / "_kernel_build"
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """The library of the current source and flags in ``build_dir``."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir) / f"libmfdl_setup_{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path | None:
    """Build the library into ``build_dir`` unless it is there; its path,
    or None without ``g++`` or the source, or when the build fails."""
    if not SOURCE.exists() or shutil.which("g++") is None:
        return None
    lib = library_path(build_dir)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():  # built while this process waited for the lock
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, lib)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
    return lib


def load(build_dir: Path = BUILD_DIR) -> ctypes.CDLL | None:
    """The library (built first where needed) with its signatures set, or
    None where it cannot be built or loaded."""
    path = build(build_dir)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c, c64 = ctypes.c_int32, ctypes.c_int64
    lib.build_gather_map.argtypes = [c, c, c, c, i32p]
    lib.build_vertex_lattice.argtypes = [c, c, c, ctypes.c_double,
                                         ctypes.c_double, c, f64p]
    lib.build_trilinear_coefficients.argtypes = [c, c, c, f64p, f64p]
    lib.renumber_locality.argtypes = [i32p, c64, c, c64, u8p, i32p]
    lib.renumber_locality.restype = c64
    lib.build_boundary_mask.argtypes = [c64, c64, c64, u8p]
    lib.metric_entries.argtypes = [f64p, c64, f64p, f64p, c, f64p]
    return lib


@functools.cache
def _library() -> ctypes.CDLL | None:
    return load()


def __getattr__(name: str):
    # AVAILABLE: whether the library builds and loads, read on first use
    if name == "AVAILABLE":
        return _library() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def gather_map(p: int, ncz: int, ncy: int, ncx: int) -> np.ndarray:
    """(n_cells, (p+1)^3) int32 structured gather map."""
    out = np.empty((ncz * ncy * ncx, (p + 1) ** 3), dtype=np.int32)
    _library().build_gather_map(p, ncz, ncy, ncx, out)
    return out


def vertex_lattice(ncz: int, ncy: int, ncx: int, h: float,
                   factor: float = 0.1, deformed: bool = True) -> np.ndarray:
    """The deformed vertex lattice (ncz+1, ncy+1, ncx+1, 3), (x, y, z)."""
    out = np.empty(((ncz + 1) * (ncy + 1) * (ncx + 1) * 3,), dtype=np.float64)
    _library().build_vertex_lattice(ncz, ncy, ncx, float(h), float(factor),
                              int(deformed), out)
    return out.reshape(ncz + 1, ncy + 1, ncx + 1, 3)


def trilinear_coefficients(ncz: int, ncy: int, ncx: int,
                           verts: np.ndarray) -> np.ndarray:
    """(n_cells, 8, 3) trilinear coefficients from the vertex lattice."""
    v = np.ascontiguousarray(verts.reshape(-1), dtype=np.float64)
    out = np.empty((ncz * ncy * ncx * 24,), dtype=np.float64)
    _library().build_trilinear_coefficients(ncz, ncy, ncx, v, out)
    return out.reshape(ncz * ncy * ncx, 8, 3)


def renumber_locality(gather: np.ndarray, n_nodes: int,
                      ghost_flags: np.ndarray | None = None
                      ) -> tuple[np.ndarray, int]:
    """The locality permutation (old node -> new node) and the count of
    interior nodes (first touch, touch-count grouping)."""
    g = np.ascontiguousarray(gather, dtype=np.int32)
    n_cells, nloc = g.shape
    if ghost_flags is None:
        ghost_flags = np.zeros(n_nodes, dtype=np.uint8)
    gf = np.ascontiguousarray(ghost_flags, dtype=np.uint8)
    out = np.empty(n_nodes, dtype=np.int32)
    n_int = _library().renumber_locality(g, n_cells, nloc, n_nodes, gf, out)
    return out, int(n_int)


def boundary_mask(nz: int, ny: int, nx: int) -> np.ndarray:
    """(nz ny nx,) bool mask of the box's boundary nodes."""
    out = np.empty(nz * ny * nx, dtype=np.uint8)
    _library().build_boundary_mask(nz, ny, nx, out)
    return out.astype(bool)


def metric_entries(coeffs: np.ndarray, q_points: np.ndarray,
                   w3: np.ndarray) -> np.ndarray:
    """(6 q^3, n_cells) metric entries (00, 01, 02, 11, 12, 22) of the
    cells' coefficients (n_cells, 8, 3)."""
    co = np.ascontiguousarray(coeffs, dtype=np.float64)
    nc = co.shape[0]
    qp = np.ascontiguousarray(q_points, dtype=np.float64)
    w3f = np.ascontiguousarray(np.asarray(w3).reshape(-1), dtype=np.float64)
    q = qp.size
    out = np.empty((6 * q ** 3) * nc, dtype=np.float64)
    _library().metric_entries(co.reshape(-1), nc, qp, w3f, q, out)
    return out.reshape(6 * q ** 3, nc)
