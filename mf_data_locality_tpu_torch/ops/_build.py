"""Build and load the CUDA kernels (``csrc/``) at first use.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into an object, all
sources at once in parallel processes (the sum-factorized pass, the
twostage tensor-core pass and the dense tensor-core pass of each degree
5..11 have a source of their own, ``sumfac_pNN.cu``, ``cell_mma_pNN.cu``
and ``apply_mma_pNN.cu``, the largest instantiations, and B2 with P or x
in bf16 at p <= 4 ``cg_fused_px.cu``, its block form
``cg_fused_block.cu``; the tensor-core
sources of :data:`RUNG_BUILDS` are
compiled once per rung, ``-DBP4_RUNG=n``), and links them into one shared
library with a plain C interface, which is loaded with :mod:`ctypes` (no
PyTorch headers, so a build takes seconds).  The library lands in ``_kernel_build/`` inside
the package, under a name keyed by a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is reused.  A missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernel_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# sources compiled once per rung, -DBP4_RUNG=n with n the products a tile
# (1 bf16, 2 split2m, 3 split3), so that nvcc builds the rungs in parallel:
# the twostage and the dense tensor-core passes at p=5..11 on every rung,
# and the tensor-core passes at p <= 4 on the rungs other than split2m
# (whose instantiations stay in cg_fused.cu and laplace_apply.cu)
RUNG_BUILDS = {"mma_rungs.cu": (1, 3),
               **{f"{pass_}_p{p:02d}.cu": (1, 2, 3)
                  for pass_ in ("cell_mma", "apply_mma")
                  for p in range(5, 12)}}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bp4_partials_len": (_I, [_I] * 4),
    "bp4_error_string": (ctypes.c_char_p, [_I]),
    # rung, degree, cells
    "bp4_dense_scratch_len": (_I, [_I] * 3),
    # dtype, rung, degree, dense, cofactor, bf16 state, bf16 metric
    # (bp4_fused_iteration: then bf16 P, bf16 x); the tables, vectors and
    # the dense pass's scratch; the cells per axis; the stream
    "bp4_matvec": (_I, [_I] * 7 + [_P] * 11 + [_I] * 3 + [_P]),
    "bp4_fused_iteration": (_I, [_I] * 9 + [_P] * 21 + [_I] * 3 + [_P]),
    # ... the cells per axis, then the block's (lo, hi, own) on z, y, x
    "bp4_fused_iteration_block": (_I, [_I] * 9 + [_P] * 21 + [_I] * 12
                                  + [_P]),
    # dtype, rung, degree, onthefly, bf16 metric; ...
    "bp4_apply_batched": (_I, [_I] * 5 + [_P] * 9 + [_I] + [_P]),
    # dtype, rung, bf16 metric, degree; ...
    "bp4_apply_lattice": (_I, [_I] * 4 + [_P] * 8 + [_I] * 3 + [_P]),
}


def nvcc_path() -> str:
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, else the one on PATH,
    else the toolkit's default install location."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(RUNG_BUILDS.items())).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbp4_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if no library for the current sources exists.

    Returns (library path, compiler output — empty when the library was
    already built).  The output includes ``-Xptxas -v``'s per-kernel
    register and shared-memory report and, per compile, a line ``nvcc:
    <source> [-DBP4_RUNG=n] <seconds> s``.
    """
    lib = library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{lib.stem}.{os.getpid()}"
    objs, procs, names = [], [], []
    t0 = time.perf_counter()
    for src in (s for s in _sources() if s.suffix == ".cu"):
        for rung in RUNG_BUILDS.get(src.name, (None,)):
            flags = () if rung is None else (f"-DBP4_RUNG={rung}",)
            obj = BUILD_DIR / f"{tag}.{src.stem}{rung or ''}.o"
            objs.append(obj)
            names.append(" ".join((src.name, *flags)))
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *flags, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def finish(i):  # (output, seconds from the start to this compile's end)
        out = procs[i].communicate()[0]
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(len(procs)) as pool:
        ends = list(pool.map(finish, range(len(procs))))
    log = "".join(f"{out}nvcc: {name} {t:.1f} s\n"
                  for name, (out, t) in zip(names, ends))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    failed = [n for n, p in zip(names, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, lib)  # atomic: another process never loads half a file
    (BUILD_DIR / (lib.stem + ".log")).write_text(log)
    return lib, log


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), one per process."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise for a nonzero return code of a kernel entry point."""
    if rc == -1:
        raise NotImplementedError(
            f"{what}: no kernel instantiated for this configuration")
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc}: {lib.bp4_error_string(rc).decode()}")
