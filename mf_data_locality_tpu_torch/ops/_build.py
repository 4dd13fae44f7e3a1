"""Build and load the CUDA kernels (``csrc/``) at first use.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into an object, all
sources at once in parallel processes (the sum-factorized pass, the
twostage tensor-core pass and the dense tensor-core pass of each degree
5..11 have a source of their own, ``sumfac_pNN.cu``, ``cell_mma_pNN.cu``
and ``apply_mma_pNN.cu``, the largest instantiations, the twostage one at
p=1..3 too, the dense one at p <= 4 with the jtj chain ``mma_jtj.cu``, and
B2 with P or x in bf16 at p <= 4 ``cg_fused_px.cu``, its block form
``cg_fused_block.cu``, the cell passes at the shapes beyond BP4's
``shapes.cu``, B2's block form at one component ``shapes_block.cu`` and
the f64 form of split2m's tensor-core passes ``mma_f64.cu``;
the sources of :data:`FLAG_BUILDS` are compiled once per
flag set, ``-DBP4_RUNG=n``, ``-DBP4_DEGREE=p`` and ``-DBP4_SHAPE=f``), and
links them into one shared library with a plain C interface, which is
loaded with :mod:`ctypes` (no PyTorch headers, so a build takes seconds).
The library lands in ``_kernel_build/`` inside the package, under a name
keyed by a hash of the sources and flags, so a
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
# -O is nvcc's level for the host code alone (the entry points' dispatch
# and the launch stubs); the device code is optimized as it is without it.
# -O0 there takes about a tenth of a source's compile time off, and the
# build is CPU-bound (utils/smoke_profile.py --nvcc)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O0",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the shape flags of the instantiations beyond BP4's (csrc/bp4_operator.cuh:
# kShC1 one component, kShQ1 q = p + 1; the kernels' shape argument), and
# the storage flag of the bf16 state (kSbState; the kernels take it by
# their state arguments)
SHAPE_C1, SHAPE_Q1, STATE_BF16 = 32, 64, 4
# the f64 form of split2m's tensor-core passes (kF64): bp4_dense_scratch_len
# takes its rung as 2 | F64_FORM
F64_FORM = 128


def _rungs(*rungs: int) -> tuple[tuple[str, ...], ...]:
    return tuple((f"-DBP4_RUNG={r}",) for r in rungs)


def _rung_degrees(degrees) -> tuple[tuple[str, ...], ...]:
    # the bf16 rung's few once for all degrees, split2m's and split3's
    # once per degree
    return _rungs(1) + tuple((f"-DBP4_RUNG={r}", f"-DBP4_DEGREE={p}")
                             for r in (2, 3) for p in degrees)


# sources compiled more than once, each time with one of their -D flag sets
# (n the products a tile: 1 bf16, 2 split2m, 3 split3), so that nvcc
# builds them in parallel: the twostage and the dense tensor-core passes
# at p=5..11 once per rung, the tensor-core passes at p <= 4 once per rung
# other than split2m (whose instantiations stay in cg_fused.cu and
# laplace_apply.cu), and the twostage pass at p=1..3 once per rung and
# degree (cell_mma_p01.cu .. p03.cu); the bf16-storage instantiations (the
# passes' kSbState / kSbMetric) of the sum-factorized pass once for p=1..4
# and once per degree 5..11, of the tensor-core passes once per rung and
# degree (p <= 4: mma_sb.cu; 5..11: apply_mma_sb.cu and cell_mma_sb.cu;
# the twostage pass's at p=1..3 once per rung, cell_mma_sb.cu); the dense
# tensor-core pass at p <= 4 with the metric rebuilt by jtj (kJtjChain)
# once per rung (mma_jtj.cu; from p=5 in apply_mma_pNN.cu)
FLAG_BUILDS = {
    "mma_rungs.cu": _rungs(1, 3),
    **{f"cell_mma_p{p:02d}.cu": _rungs(1, 2, 3)
       for p in (*range(1, 4), *range(5, 12))},
    **{f"apply_mma_p{p:02d}.cu": _rungs(1, 2, 3) for p in range(5, 12)},
    "sumfac_sb.cu": ((),) + tuple((f"-DBP4_DEGREE={p}",)
                                  for p in range(5, 12)),
    "mma_sb.cu": _rung_degrees(range(1, 5)),
    "apply_mma_sb.cu": _rung_degrees(range(5, 12)),
    "cell_mma_sb.cu": _rungs(2, 3) + _rung_degrees(range(5, 12))[1:],
    "mma_jtj.cu": _rungs(1, 2, 3),
    # the cell passes at the shapes beyond BP4's (csrc/shapes.cuh: one
    # component, q = p + 1, both; one component with the bf16 state,
    # SHAPE_C1 | STATE_BF16), one object a degree and shape
    "shapes.cu": tuple((f"-DBP4_DEGREE={p}", f"-DBP4_SHAPE={sh}")
                       for p in range(1, 12)
                       for sh in (SHAPE_C1, SHAPE_Q1, SHAPE_C1 | SHAPE_Q1,
                                  SHAPE_C1 | STATE_BF16)),
    # B2's block form at one component, one object a degree
    "shapes_block.cu": tuple((f"-DBP4_DEGREE={p}",) for p in range(1, 12)),
    # the f64 form of split2m (the dense and twostage tensor-core passes
    # at f64, csrc/bp4_operator.cuh's kF64), one object a degree
    "mma_f64.cu": tuple((f"-DBP4_DEGREE={p}",) for p in range(1, 12)),
}


def _flags(name: str) -> tuple[tuple[str, ...], ...]:
    """The -D flag sets a source is compiled with, one object each."""
    return FLAG_BUILDS.get(name, ((),))

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bp4_partials_len": (_I, [_I] * 4),
    "bp4_error_string": (ctypes.c_char_p, [_I]),
    # rung, degree, shape, cells
    "bp4_dense_scratch_len": (_I, [_I] * 4),
    # dtype, rung, degree, shape, dense, cofactor, bf16 state, bf16 metric
    # (bp4_fused_iteration: then bf16 P, bf16 x); the tables, vectors and
    # the dense pass's scratch; the cells per axis; the stream
    "bp4_matvec": (_I, [_I] * 8 + [_P] * 11 + [_I] * 3 + [_P]),
    "bp4_fused_iteration": (_I, [_I] * 10 + [_P] * 21 + [_I] * 3 + [_P]),
    # the arguments of bp4_fused_iteration (the shape 0 or SHAPE_C1); the
    # cells per axis, then the block's (lo, hi, own) on z, y, x, the cell
    # pass's range of cells and the passes to run
    "bp4_fused_iteration_block": (_I, [_I] * 10 + [_P] * 21 + [_I] * 15
                                  + [_P]),
    # dtype, rung, degree, shape, onthefly, bf16 metric, bf16 state; ...
    "bp4_apply_batched": (_I, [_I] * 7 + [_P] * 9 + [_I] + [_P]),
    # dtype, rung, bf16 metric, bf16 state, degree, shape; ...; the cells
    # per axis, a block's
    "bp4_apply_lattice": (_I, [_I] * 6 + [_P] * 8 + [_I] * 4 + [_P]),
    # degree, components, the cells per axis, the block's (lo, hi, own) on
    # z, y, x; the cell results, the carry; the stream
    "bp4_block_carry": (_I, [_I] * 14 + [_P] * 3),
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
    h.update(repr(sorted(FLAG_BUILDS.items())).encode())
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
        for flags in _flags(src.name):
            obj = BUILD_DIR / f"{tag}.{src.stem}{''.join(flags)}.o"
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
