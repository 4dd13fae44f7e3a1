"""Time source variants of the f32 split2m B1/B2 cell pass on the card.

    python -m mf_data_locality_tpu_torch.utils.variants [ablate|stamps]

Each variant is a copy of the package with a few text patches applied to
``csrc/`` (built by its own process, all builds at once, into the copy's
own ``_kernel_build/``): two kernel libraries in one process make launches
fail, so every variant is timed in its own process.

* ``ablate`` times B1 (matvec) and B2 (fused iteration) at p=4 s=13 for
  the pass as it is and for variants that drop or change one part of it,
  in turns (every variant, then every variant in reverse order), and prints
  the minimum of each and the ptxas resource line of the B2 cell kernel.
  Variants that drop work compute wrong values: they only say what that
  work costs.
* ``stamps`` builds the pass with ``clock64()`` stamps at its phase
  boundaries (thread 0 of each block, after a barrier) and prints the mean
  and maximum cycles of each phase over the blocks of one B1 call.

The patches match this version of ``csrc/cell_mma.cuh``; a patch that no
longer matches raises.  Copies go to ``_scratch/variants/`` (gitignored).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent / "_scratch" / "variants"
CM = "csrc/cell_mma.cuh"
_STAMP = "if (threadIdx.x == 0) g_prof[blockIdx.x][{k}] = clock64();"

ABLATE = {
    "base": [],
    # the metric rebuild replaced by a diagonal metric (no Jacobian chain)
    "nometric": [(CM, "onthefly_metric(pq, c24[b], __ldg(tb.w3 + qp), gm);",
                  "gm[0] = gm[3] = gm[5] = pq[0] + 1.f; "
                  "gm[1] = gm[2] = gm[4] = 0.f;")],
    # no gather: the inputs are constants (no loads of d, g, h, P, x)
    "nogather": [(CM, "    gather_row_tile<P, FUSED>(sm, io, sc, gr, cell0);",
                  "    for (int i = tid; i < kComps * kTileCells * LDU; "
                  "i += blockDim.x) (&sm.u[0][0][0])[i] = 0.25f * (i % 7);"),
                 (CM, "    gather_cells<P, FUSED>(sm, io, sc, gr, cell0);",
                  "    for (int i = tid; i < kComps * kTileCells * LDU; "
                  "i += blockDim.x) (&sm.u[0][0][0])[i] = 0.25f * (i % 7);")],
    # every tile gathered per (cell, node), as a tile that crosses rows
    "cellgather": [(CM, "if (cell0 + kTileCells <= nc && cell0 % gr.ncx + "
                        "kTileCells <= gr.ncx)", "if (false)")],
    # the mma instructions skipped (their operands still computed)
    "nomma": [("csrc/mma.cuh", 'asm("mma.sync',
               'if (b.x == 12345u) asm volatile("mma.sync')],
    # three warps a block, no fourth warp for the gather and the metric
    "three_warps": [(CM, "constexpr int kCellMmaThreads = 32 * (kComps + 1);",
                     "constexpr int kCellMmaThreads = 32 * kComps;")],
    # the fragment tables read through L1 from global memory, not copied
    "ldg_tables": [
        (CM, "const uint2 bf = sm.mf[(nt * Ms::KF + ks) * 32 + lane];",
         "const uint2 bf = __ldg(reinterpret_cast<const uint2*>(tb.mats) + "
         "(nt * Ms::KF + ks) * 32 + lane);"),
        (CM, "const uint2* bn = sm.mb + (nt * Ms::KB + j) * 32 + lane;\n"
             "        const uint2 bx = bn[0], by = bn[Ms::QC * 32], "
             "bz = bn[2 * Ms::QC * 32];",
         "const uint2* bn = reinterpret_cast<const uint2*>(tb.mats) + Ms::TF "
         "+ (nt * Ms::KB + j) * 32 + lane;\n        const uint2 bx = "
         "__ldg(bn), by = __ldg(bn + Ms::QC * 32), bz = __ldg(bn + 2 * "
         "Ms::QC * 32);"),
        (CM, "constexpr int PER = (NT + kCellMmaThreads - 1) / "
             "kCellMmaThreads;", "constexpr int PER = 0;"),
        (CM, "    uint4 t[PER];", "    uint4 t[1];")],
}

STAMPS = {"stamps": [
    (CM, "namespace bp4 {\n",
     "namespace bp4 {\n__device__ long long g_prof[8192][12];\n"),
    (CM, "  const int cell0 = blockIdx.x * kTileCells;\n\n",
     "  const int cell0 = blockIdx.x * kTileCells;\n  " + _STAMP.format(k=0)
     + "\n\n"),
    (CM, "  __syncthreads();  // coefficients ready\n"
         "  metric_plane<P>(sm.g[0], sm.c24, tb, 0);\n",
     "  __syncthreads();  // coefficients ready\n  " + _STAMP.format(k=1)
     + "\n  metric_plane<P>(sm.g[0], sm.c24, tb, 0);\n  "
     + _STAMP.format(k=2) + "\n"),
    (CM, "    __syncthreads();\n    if (qz + 1 < S::Q)",
     "    __syncthreads();\n    if (qz > 0 && threadIdx.x == 0) "
     "g_prof[blockIdx.x][2 + qz] = clock64();\n    if (qz + 1 < S::Q)"),
    (CM, "  // v into this warp's input rows",
     "  __syncthreads();\n  " + _STAMP.format(k=8)
     + "\n  // v into this warp's input rows"),
    (CM, "                     : 0.f;\n    }\n  }\n}",
     "                     : 0.f;\n    }\n  }\n  __syncthreads();\n  "
     + _STAMP.format(k=9) + "\n}"),
    ("csrc/cg_fused.cu", "const char* bp4_error_string(int err) {",
     "int bp4_prof_read(void* dst, int n) {\n  return cudaMemcpyFromSymbol("
     "dst, bp4::g_prof, n * 12 * sizeof(long long));\n}\n\n"
     "const char* bp4_error_string(int err) {"),
]}

_SETUP = r'''
import ctypes, json, numpy as np, torch
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import _build, cg_fused_kernel as fk
from mf_data_locality_tpu_torch.utils import timing
dev = torch.device("cuda")
pb = bp4.build(13, 4, torch.float32, "split2m", device=dev)
op = pb.op
gen = torch.Generator(device=dev).manual_seed(0)
x, g, d, h = [(torch.randn((3,) + op.n_nodes_axis, generator=gen,
                           device=dev) * op.mask).contiguous()
              for _ in range(4)]
prec = pb.inv_diag.reshape((1,) + op.n_nodes_axis).contiguous()
scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6], device=dev)
out, work = torch.empty_like(d), fk.Workspace(op)
bufs = tuple(torch.empty_like(t) for t in (x, g, d, h, scal))
'''

_TIME = _SETUP + r'''
t1 = timing.time_per_call(lambda: fk.matvec(op, d, out=out, work=work), dev,
                          inner=50, repeats=5)
t2 = timing.time_per_call(lambda: fk.fused_cg_iteration(
    op, x, g, d, h, scal, prec, out=bufs, work=work), dev, inner=50,
    repeats=5)
print(json.dumps({"b1_ms": t1 * 1e3, "b2_ms": t2 * 1e3}))
'''

_READ_STAMPS = _SETUP + r'''
lib = _build.load()
lib.bp4_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
for _ in range(3):
    fk.matvec(op, d, out=out, work=work)
torch.cuda.synchronize()
nb = -(-op.n_cells // 16)
buf = np.zeros((nb, 12), np.int64)
assert lib.bp4_prof_read(buf.ctypes.data, nb) == 0
names = ["prologue (tables, gather)", "metric of plane 0"] + [
    f"plane {q} (products; metric of the next)" for q in range(6)] + [
    "output"]
steps = np.diff(buf[:, :10], axis=1)
for name, col in zip(names, steps.T):
    print(f"  {name:42s} mean {col.mean():9.0f} cycles, max {col.max():7d}")
total = buf[:, 9] - buf[:, 0]
print(f"  block total mean {total.mean():.0f} cycles, max {total.max()}, "
      f"{nb} blocks")
'''


def _copy(name: str, patches) -> Path:
    dst = ROOT / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(PKG, dst / PKG.name, ignore=shutil.ignore_patterns(
        "_kernel_build", "__pycache__"))
    for rel, old, new in patches:
        path = dst / PKG.name / rel
        text = path.read_text()
        if old not in text:
            raise ValueError(f"variant {name}: patch does not match {rel}: "
                             f"{old[:60]!r}")
        path.write_text(text.replace(old, new))
    return dst


def _run(root: Path, code: str) -> subprocess.CompletedProcess:
    # run from the copy: the working directory comes first on sys.path
    return subprocess.run([sys.executable, "-c", code], cwd=root,
                          env=dict(os.environ, PYTHONPATH=str(root)),
                          capture_output=True, text=True)


def build_all(variants: dict) -> dict[str, Path]:
    """Copy, patch and build every variant at once; return the built ones."""
    roots = {name: _copy(name, p) for name, p in variants.items()}
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", "from mf_data_locality_tpu_torch.ops import "
         "_build; print(_build.build()[1])"], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, root in roots.items()}
    built = {}
    for name, proc in procs.items():
        lines = proc.communicate()[0].splitlines()
        if proc.returncode:
            print(f"{name}: build failed\n" + "\n".join(lines[-40:]))
            continue
        built[name] = roots[name]
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and \
                    "cells_mma_kernelILi4ELb1E" in line:
                print(f"{name}: " + " | ".join(
                    s.split("ptxas info    : ")[-1].strip()
                    for s in lines[i + 1:i + 4]))
    return built


def main(argv: list[str] | None = None) -> None:
    which = (argv if argv is not None else sys.argv[1:]) or ["ablate"]
    if "stamps" in which:
        for name, root in build_all(STAMPS).items():
            r = _run(root, _READ_STAMPS)
            print(f"{name}:\n{r.stdout}{r.stderr[-2000:]}")
    if "ablate" in which:
        built = build_all(ABLATE)
        names = list(built)
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                r = _run(built[name], _TIME)
                if r.returncode:
                    print(f"{name}: run failed\n{r.stderr[-2000:]}")
                    continue
                times[name].append(json.loads(r.stdout.splitlines()[-1]))
        for name, rows in times.items():
            if rows:
                print(f"{name:12s} B1 {min(t['b1_ms'] for t in rows):.4f} ms"
                      f"  B2 {min(t['b2_ms'] for t in rows):.4f} ms  "
                      f"(each run: "
                      f"{[round(t['b1_ms'], 4) for t in rows]} / "
                      f"{[round(t['b2_ms'], 4) for t in rows]})")


if __name__ == "__main__":
    main()
