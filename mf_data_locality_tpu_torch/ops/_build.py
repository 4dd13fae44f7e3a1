"""Build and load the CUDA kernels (``csrc/``) at first use.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into an object, all
sources at once in parallel processes, and links them into one shared
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
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernel_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bp4_partials_len": (_I, [_I] * 4),
    "bp4_error_string": (ctypes.c_char_p, [_I]),
    "bp4_matvec": (_I, [_I] * 4 + [_P] * 10 + [_I] * 3 + [_P]),
    "bp4_fused_iteration": (_I, [_I] * 4 + [_P] * 20 + [_I] * 3 + [_P]),
    "bp4_apply_batched": (_I, [_I] * 4 + [_P] * 8 + [_I] + [_P]),
    "bp4_apply_lattice": (_I, [_I] * 3 + [_P] * 7 + [_I] * 3 + [_P]),
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
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbp4_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if no library for the current sources exists.

    Returns (library path, compiler output — empty when the library was
    already built).  The output includes ``-Xptxas -v``'s per-kernel
    register and shared-memory report.
    """
    lib = library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{lib.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(logs)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    failed = [p.args[-3] for p in procs if p.returncode != 0]
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
