"""Time source variants of the cell passes on the card.

    python -m mf_data_locality_tpu_torch.utils.variants \
        [ablate|stamps|sumfac|sfstamps|rebuilt|paths|dense|px]
        [sf_name ...] [DIR ...]

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
* ``sumfac [sf_name ...]`` times B3, B5 and B6 under ``highest`` (f32
  and f64) at p=4 s=13, the sum-factorized pass of
  ``csrc/apply_sumfac.cuh``, as it is and in variants (those named, else
  all), in turns, and prints the ptxas resource lines of the pass;
  ``sfstamps`` prints per-phase ``clock64()`` cycles of its f32 B3, B4, B1
  and B2 passes and how many of their blocks an SM runs at once.
* ``paths [DIR ...]`` times two rows of the benchmark at p=4 s=13 in the
  same turns: merged ``--geometry onthefly`` (B4) and the fused solver
  under f32 ``highest`` (B1, B2): time/it and time/matvec, in ms.
* ``dense [DIR ...]`` times B1 and B2 in the fused solver's dense
  configurations — f32 split2m (the tensor-core pass of
  ``csrc/apply_mma.cuh``) with the metric streamed and rebuilt, f32
  ``highest`` streamed (the sum-factorized pass) — and B5 under split2m,
  at p=4 s=13 and p=2 s=16, in turns.
* ``px`` times the cell pass of B2 with P or x stored in bf16 (the PX
  instantiation of ``csrc/cell_mma.cuh``) at p=4 s=13 under split2m by
  ``torch.profiler``: the pass as it is (f32, bf16 P, bf16 x) and with
  the storage known at compile time in its row gather (``ct_p``: bf16 P,
  ``ct_x``: bf16 x; each timed only in its own storage), in turns.
* ``rebuilt [sf_name ...] [DIR ...]`` times B1, B2 and B4 under
  ``highest`` (f32 and f64) at p=4 s=13 — the pass with the metric rebuilt
  from the coefficients — in the package as it is (or in the named
  variants) and in the package under each directory ``DIR`` (another
  checkout, such as the parent commit's), in turns: DIR, tree, tree, DIR.

The patches match this version of ``csrc/cell_mma.cuh`` and
``csrc/apply_sumfac.cuh``; a patch that no longer matches raises.  Copies
go to ``_scratch/variants/`` (gitignored).
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
SF = "csrc/apply_sumfac.cuh"
SF_KERNEL = "apply_sumfac_kernelIfLi4E"  # its f32 p=4 instantiations
_STAMP = "if (threadIdx.x == 0) g_prof[blockIdx.x][{k}] = clock64();"

ABLATE = {
    "base": [],
    # the metric rebuild replaced by a diagonal metric (no Jacobian chain)
    "nometric": [(CM, "onthefly_metric<1, COFACTOR>(pq, c24[b], "
                       "__ldg(tb.w3 + qp), gm);",
                  "gm[0] = gm[3] = gm[5] = pq[0] + 1.f; "
                  "gm[1] = gm[2] = gm[4] = 0.f;")],
    # no gather: the inputs are constants (no loads of d, g, h, P, x)
    "nogather": [(CM, "    gather_row_tile<P, FUSED, FLEX, PX>(sm, io, sc, gr, "
                      "cell0);",
                  "    for (int i = tid; i < kComps * kTileCells * LDU; "
                  "i += blockDim.x) (&sm.u[0][0][0])[i] = 0.25f * (i % 7);"),
                 (CM, "    gather_cells<P, FUSED, FLEX, PX>(sm, io, sc, gr, "
                      "cell0);",
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
         "  metric_plane<P, COFACTOR>(sm.g[0], sm.c24, tb, 0);\n",
     "  __syncthreads();  // coefficients ready\n  " + _STAMP.format(k=1)
     + "\n  metric_plane<P, COFACTOR>(sm.g[0], sm.c24, tb, 0);\n  "
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

_SF_PREFETCH = r'''
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}
template <typename T, int P, bool LATTICE>
__device__ __forceinline__ void sumfac_prefetch(const Grid& gr,
                                                const T* gmetric, const T* u,
                                                int cell0) {
  using S = Shape<P>;
  using Sm = SumfacSmem<T, P, false>;
  const int nc = gr.n_cells();
  if (cell0 >= nc || gmetric == nullptr) return;
  for (int r = threadIdx.x; r < 6 * S::Q3; r += Sm::kThreads)
    prefetch_l2(gmetric + static_cast<size_t>(r) * nc + cell0);
  if constexpr (LATTICE) {
    for (int r = threadIdx.x; r < Sm::BC * kComps * S::P12; r += Sm::kThreads) {
      const int cell = cell0 + r % Sm::BC, row = r / Sm::BC;
      if (cell >= nc) continue;
      T m;
      const size_t node = cell_node<P>(gr, cell, (row % S::P12) * S::P1,
                                       static_cast<const T*>(nullptr), &m);
      prefetch_l2(u + (row / S::P12) * static_cast<size_t>(gr.n_nodes())
                  + node);
    }
  } else {
    for (int r = threadIdx.x; r < kComps * S::P13; r += Sm::kThreads)
      prefetch_l2(u + static_cast<size_t>(r) * nc + cell0);
  }
}

'''

_SF_BOUNDS = ("SumfacSmem<T, P, REBUILD>::kThreads,\n"
              "                                  sumfac_blocks<T, P, REBUILD>())")

_SF_METRIC = """      if (a.cofactor == kJtj)
        onthefly_metric<BC, kJtj>(pq, &sm.c24[0][b], __ldg(a.w3 + qp), gm);
      else
        onthefly_metric<BC>(pq, &sm.c24[0][b], __ldg(a.w3 + qp), gm);
"""
_SF_REBUILD = """    for (int qz = 0; qz < Q; ++qz) {
      const int qp = qz * Q2 + col;
      T pq[24], gm[6];
      load_pds_row(a.pds + qp * 24, pq);
""" + _SF_METRIC + """#pragma unroll
      for (int e = 0; e < 6; ++e) sm.g[e][qp][b] = gm[e];
    }
  }
"""
_SF_WAIT = ("    if constexpr (!REBUILD) {\n      if (c == 0) "
            "__pipeline_wait_prior(0);  // this thread's metric copies\n"
            "    }\n    __syncthreads();\n")

SUMFAC = {
    "sf_base": [],
    # no minimum of three blocks an SM in __launch_bounds__
    "sf_minblocks_free": [(SF, _SF_BOUNDS,
                           "SumfacSmem<T, P, REBUILD>::kThreads)")],
    # once its metric has arrived, a block brings the inputs of the block
    # that runs one wave later (132 SMs x 3 blocks) into L2
    "sf_l2_prefetch": [
        (SF, "// Blocks an SM: three at p <= 4",
         _SF_PREFETCH + "// Blocks an SM: three at p <= 4"),
        (SF, _SF_WAIT,
         _SF_WAIT + "    if (c == 0)\n      sumfac_prefetch<T, P, FORM != "
         "kCellBatch>(gr, a.gmetric, a.io.d, cell0 + 396 * BC);\n")],
    # the metric staged by plain loads, not cp.async
    "sf_sync_metric": [
        (SF, "      __pipeline_memcpy_async(\n          &sm.g[0][0][0] + i,\n"
             "          a.gmetric + static_cast<size_t>(i / BC) * nc + cell0 +"
             "\n              min(bb, nlive - 1),\n          sizeof(T), "
             "bb < nlive ? 0 : sizeof(T));",
         "      (&sm.g[0][0][0])[i] = bb < nlive ? a.gmetric[static_cast<"
         "size_t>(i / BC) * nc + cell0 + bb] : T(0);")],
    # the next component's input loaded ahead in every form (the lattice
    # forms too), or just before its store in every form (the cell batch too)
    "sf_ahead_all": [(SF, "constexpr bool kAhead = FORM == kCellBatch;",
                      "constexpr bool kAhead = true;")],
    "sf_ahead_none": [(SF, "constexpr bool kAhead = FORM == kCellBatch;",
                       "constexpr bool kAhead = false;")],
    # ahead in the rebuilt lattice forms too (B1, B2), not in B5/B6
    "sf_ahead_rebuilt": [(SF, "constexpr bool kAhead = FORM == kCellBatch;",
                          "constexpr bool kAhead = FORM == kCellBatch || "
                          "REBUILD;")],
    # four f32 cells a block (half a sector a row), 144 threads, six blocks
    # an SM
    "sf_bc4": [(SF, "struct SumfacCells {\n  static constexpr int N = "
                    "sumfac_cells<T, P>();",
                "struct SumfacCells {\n  static constexpr int N = "
                "sizeof(T) == 4 && P <= 4 ? 4 : sumfac_cells<T, P>();"),
               (SF, _SF_BOUNDS, "SumfacSmem<T, P, REBUILD>::kThreads, 6)")],
    # S and D read from (unset) constant memory, not shared memory: what
    # the table loads cost
    "sf_const_tables": [
        (SF, "template <typename T, int P>\nstruct SumfacCells {",
         "__constant__ float c_sf_f[2][64];\n__constant__ double c_sf_d[2][64];"
         "\ntemplate <typename T>\n__device__ __forceinline__ const T* "
         "sf_ct(int i) {\n  if constexpr (sizeof(T) == 4) return "
         "reinterpret_cast<const T*>(c_sf_f[i]);\n  else return "
         "reinterpret_cast<const T*>(c_sf_d[i]);\n}\n\n"
         "template <typename T, int P>\nstruct SumfacCells {"),
        (SF, "    sm.sz[i] = a.sz[i];\n    sm.dz[i] = a.dz[i];", "    ;"),
        (SF, "sm.sz[", "sf_ct<T>(0)["), (SF, "sm.dz[", "sf_ct<T>(1)[")],
    # the metric entries not read from shared memory (constants): what
    # the metric's shared-memory loads cost
    "sf_no_metric_reads": [
        (SF, "        const T g00 = sm.g[0][qp][b], g01 = sm.g[1][qp][b],\n"
             "                g02 = sm.g[2][qp][b], g11 = sm.g[3][qp][b],\n"
             "                g12 = sm.g[4][qp][b], g22 = sm.g[5][qp][b];",
         "        const T g00 = T(1.5), g01 = T(0.25), g02 = T(0.125), "
         "g11 = T(1.25), g12 = T(0.0625), g22 = T(1.125);")],
    # no lattice gather (B5, B6, B1): the inputs are constants
    "sf_nogather": [
        (SF, "          const size_t node = cell_node<P>(gr, cell0 + bb, k, "
             "a.mask, &m[j]);\n          v[j] = a.io.d[c * static_cast<size_t>"
             "(gr.n_nodes()) + node];",
         "          m[j] = T(1);\n          v[j] = T(0.25) * (k % 7);")],
    # no update4b gather (B2): the inputs are constants, nothing written
    "sf_no_update": [
        (SF, "          const int cell = cell0 + bb;\n          v[j] = "
             "cell_input<T, P, true>(",
         "          const int cell = cell0 + bb;\n          v[j] = T(0.25) * "
         "(k % 7);\n          if (false) cell_input<T, P, true>(")],
    # the metric rebuild (B4, B1, B2) replaced by a diagonal metric from the
    # pds row (its loads stay): what the adjugate chain costs
    "sf_no_rebuild": [
        (SF, _SF_METRIC, "      gm[0] = gm[3] = gm[5] = pq[0] + T(1);\n"
         "      gm[1] = gm[2] = gm[4] = T(0);\n")],
    # the rebuild's pds row read word by word, not by 16-byte loads
    "sf_pds_scalar": [
        (SF, "      load_pds_row(a.pds + qp * 24, pq);",
         "#pragma unroll\n      for (int k = 0; k < 24; ++k) pq[k] = "
         "__ldg(a.pds + qp * 24 + k);")],
    # the rebuild's coefficients held in registers across the q-points
    "sf_c24_regs": [
        (SF, "    __syncthreads();  // the coefficients\n",
         "    __syncthreads();  // the coefficients\n    T cr[24];\n"
         "#pragma unroll\n    for (int k = 0; k < 24; ++k) cr[k] = "
         "sm.c24[k][b];\n"),
        (SF, _SF_METRIC, "      onthefly_metric(pq, cr, __ldg(a.w3 + qp), "
         "gm);\n")],
    # the rebuild after component 0's x pass, not in the prologue
    "sf_rebuild_late": [
        (SF, "  if constexpr (REBUILD) {\n    // while component 0's input "
             "arrives: G at this thread's own slots\n    // (qz, col, b), read "
             "only by it\n    __syncthreads();  // the coefficients\n"
             + _SF_REBUILD, ""),
        (SF, _SF_WAIT,
         "    if (c == 0 && REBUILD) {\n" + _SF_REBUILD.replace("    ", "  ")
         .replace("\n  }\n", "\n    }\n") + _SF_WAIT)],
}

_SF_STAMP = "    sf_stamp({k});\n"
SF_STAMPS = {"sf_stamps": [
    (SF, "namespace bp4 {\n",
     "namespace bp4 {\n__device__ long long g_sfprof[16384][16];\n"
     "__device__ __forceinline__ void sf_stamp(int k) {\n"
     "  if (threadIdx.x == 0) g_sfprof[blockIdx.x][k] = clock64();\n}\n"),
    (SF, "  const int b = tid % BC, col = tid / BC;\n",
     "  const int b = tid % BC, col = tid / BC;\n  sf_stamp(0);\n  if (tid == 0) "
     "{ unsigned id; asm(\"mov.u32 %0, %%smid;\" : \"=r\"(id)); "
     "g_sfprof[blockIdx.x][15] = id; }\n"),
    (SF, "  for (int c = 0; c < kComps; ++c) {\n    __syncthreads();\n",
     "  for (int c = 0; c < kComps; ++c) {\n    __syncthreads();\n"
     + _SF_STAMP.format(k="1 + 4 * c")),
    # the rebuilt metric's end in the prologue
    (SF, _SF_REBUILD, _SF_REBUILD[:-4] + "    __syncthreads();\n"
     + _SF_STAMP.format(k=14) + "  }\n"),
    (SF, _SF_WAIT, _SF_WAIT + _SF_STAMP.format(k="2 + 4 * c")),
    (SF, "nlive);\n    __syncthreads();\n",
     "nlive);\n    __syncthreads();\n" + _SF_STAMP.format(k="3 + 4 * c")),
    (SF, "        sm.x[1][kz][ky][qx][b] = vd;\n      }\n    }\n"
         "    __syncthreads();\n",
     "        sm.x[1][kz][ky][qx][b] = vd;\n      }\n    }\n"
     "    __syncthreads();\n" + _SF_STAMP.format(k="4 + 4 * c")),
    (SF, "      in.store(sm);\n    }\n  }\n}",
     "      in.store(sm);\n    }\n  }\n  __syncthreads();\n"
     + _SF_STAMP.format(k=13) + "}"),
    # each source has its own copy of the stamps: B3/B4 (laplace_apply.cu)
    # and B1/B2 (cg_fused.cu) are read by their own entries
    ("csrc/laplace_apply.cu", "int bp4_apply_batched(",
     "int bp4_sfprof_read(void* dst, int n) {\n  return cudaMemcpyFromSymbol("
     "dst, bp4::g_sfprof, n * 16 * sizeof(long long));\n}\n\n"
     "int bp4_apply_batched("),
    ("csrc/cg_fused.cu", "int bp4_partials_len(",
     "int bp4_sfprof_read_fused(void* dst, int n) {\n  return "
     "cudaMemcpyFromSymbol(dst, bp4::g_sfprof, n * 16 * sizeof(long long));"
     "\n}\n\nint bp4_partials_len("),
]}

_SETUP = r'''
import ctypes, json, numpy as np, torch
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import _build, cg_fused_kernel as fk
from mf_data_locality_tpu_torch.utils import timing
dev = torch.device("cuda")
pb = bp4.build(13, 4, torch.float32, "split2m", factor="twostage",
               metric="onthefly", windowing="pieces", device=dev)
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


_TIME_SUMFAC = r'''
import json, torch
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.utils import timing
dev = torch.device("cuda")
out = {}
for dtype in (torch.float32, torch.float64):
    op = bp4.build(13, 4, dtype, "highest", factor="dense",
                   metric="precomputed", windowing="reshape", device=dev).op
    gen = torch.Generator(device=dev).manual_seed(3)
    u = (torch.randn((3,) + op.n_nodes_axis, generator=gen, device=dev,
                     dtype=dtype) * op.mask).contiguous()
    ul = la.to_cell_batches(u, 4).contiguous()
    for name, fn in (("B3", lambda: la.apply_local_batched_g(op, ul)),
                     ("B5", lambda: la.apply_lattice_pieces(op, u)),
                     ("B6", lambda: la.apply_lattice_zslab(op, u))):
        out[f"{name} {str(dtype)[6:]}"] = timing.time_per_call(
            fn, dev, inner=50, repeats=5) * 1e3
print(json.dumps(out))
'''


_READ_SF_STAMPS = r'''
import ctypes, numpy as np, torch
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import _build, cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.utils import timing
dev = torch.device("cuda")
lib = _build.load()
for reader in (lib.bp4_sfprof_read, lib.bp4_sfprof_read_fused):
    reader.argtypes = [ctypes.c_void_p, ctypes.c_int]
ops = {m: bp4.build(13, 4, torch.float32, "highest", factor="dense",
                    metric=m, windowing="reshape", device=dev).op
       for m in ("precomputed", "onthefly")}
pb = bp4.build(13, 4, torch.float32, "highest", factor="twostage",
               metric="onthefly", windowing="pieces", device=dev)
opf = pb.op
gen = torch.Generator(device=dev).manual_seed(3)
x, g, d, h = [(torch.randn((3,) + opf.n_nodes_axis, generator=gen, device=dev)
               * opf.mask).contiguous() for _ in range(4)]
ul = la.to_cell_batches(d, 4).contiguous()
prec = pb.inv_diag.reshape((1,) + opf.n_nodes_axis).contiguous()
scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6], device=dev)
work = fk.Workspace(opf)
bufs = tuple(torch.empty_like(t) for t in (x, g, d, h, scal))
# (first stamp, last stamp, phase); stamp 14 ends the rebuilt metric
streamed = [(0, 1, "prologue (tables, metric issued, input 0)")]
rebuilt = [(0, 14, "prologue: tables, coefficients, input 0 issued, "
                   "metric rebuilt"), (14, 1, "prologue: input 0 stored")]
edges = []
for c in range(3):
    edges += [(1 + 4 * c, 2 + 4 * c,
               f"component {c}: x pass" + (" (+ metric wait)" if c == 0
                                           else "")),
              (2 + 4 * c, 3 + 4 * c, f"component {c}: y, z passes, apply"),
              (3 + 4 * c, 4 + 4 * c, f"component {c}: backward y pass"),
              (4 + 4 * c, 5 + 4 * c if c < 2 else 13,
               f"component {c}: backward x pass, output, next input")]
for label, fn, reader in (
        ("B3", lambda: la.apply_local_batched_g(ops["precomputed"], ul),
         lib.bp4_sfprof_read),
        ("B4", lambda: la.apply_local_batched_onthefly(ops["onthefly"], ul),
         lib.bp4_sfprof_read),
        ("B1", lambda: fk.matvec(opf, d, work=work),
         lib.bp4_sfprof_read_fused),
        ("B2", lambda: fk.fused_cg_iteration(opf, x, g, d, h, scal, prec,
                                             out=bufs, work=work),
         lib.bp4_sfprof_read_fused)):
    ms = timing.time_per_call(fn, dev, inner=20, repeats=3) * 1e3
    fn()
    torch.cuda.synchronize()
    nb = opf.n_cells // 8
    buf = np.zeros((nb, 16), np.int64)
    assert reader(buf.ctypes.data, nb) == 0
    print(f"{label} f32 highest:")
    for i, j, name in (rebuilt if buf[:, 14].all() else streamed) + edges:
        col = buf[:, j] - buf[:, i]
        print(f"  {name:58s} mean {col.mean():8.0f} cycles, "
              f"max {col.max():7d}")
    total = buf[:, 13] - buf[:, 0]
    conc = []
    for sm in np.unique(buf[:, 15]):
        rows = buf[buf[:, 15] == sm]
        span = rows[:, 13].max() - rows[:, 0].min()
        conc.append(((rows[:, 13] - rows[:, 0]).sum() / span, len(rows),
                     span))
    conc = np.array(conc)
    wave = np.argsort(np.argsort(buf[:, 0])) < 3 * len(conc)
    print(f"  block total mean {total.mean():.0f} cycles, max {total.max()}; "
          f"{nb} blocks on {len(conc)} SMs, {conc[:, 1].mean():.2f} a SM; "
          f"blocks in flight a SM (mean) {conc[:, 0].mean():.2f}; SM span "
          f"mean {conc[:, 2].mean():.0f} cycles; prologue of the first wave "
          f"{(buf[wave, 1] - buf[wave, 0]).mean():.0f}, of the rest "
          f"{(buf[~wave, 1] - buf[~wave, 0]).mean():.0f} cycles; kernel "
          f"{ms:.4f} ms (timed, without stamps between)")
'''


_TIME_REBUILT = r'''
import json, torch
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.utils import timing
dev = torch.device("cuda")
out = {}
for dtype in (torch.float32, torch.float64):
    tag = str(dtype)[6:]
    pb = bp4.build(13, 4, dtype, "highest", factor="twostage",
                   metric="onthefly", windowing="pieces", device=dev)
    op = pb.op
    gen = torch.Generator(device=dev).manual_seed(2)
    x, g, d, h = [(torch.randn((3,) + op.n_nodes_axis, generator=gen,
                               device=dev, dtype=dtype) * op.mask).contiguous()
                  for _ in range(4)]
    prec = pb.inv_diag.reshape((1,) + op.n_nodes_axis).contiguous()
    scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6],
                        dtype=dtype, device=dev)
    o, work = torch.empty_like(d), fk.Workspace(op)
    bufs = tuple(torch.empty_like(t) for t in (x, g, d, h, scal))
    out[f"B1 {tag}"] = timing.time_per_call(
        lambda: fk.matvec(op, d, out=o, work=work), dev, inner=20,
        repeats=5) * 1e3
    out[f"B2 {tag}"] = timing.time_per_call(
        lambda: fk.fused_cg_iteration(op, x, g, d, h, scal, prec, out=bufs,
                                      work=work), dev, inner=20,
        repeats=5) * 1e3
    opo = bp4.build(13, 4, dtype, "highest", factor="dense",
                    metric="onthefly", windowing="reshape", device=dev).op
    ul = la.to_cell_batches(d, 4).contiguous()
    out[f"B4 {tag}"] = timing.time_per_call(
        lambda: la.apply_local_batched_onthefly(opo, ul), dev, inner=20,
        repeats=5) * 1e3
    del pb, op, opo, x, g, d, h, prec, o, work, bufs, ul
    torch.cuda.empty_cache()
print(json.dumps(out))
'''


_TIME_PATHS = r'''
import json, torch
from mf_data_locality_tpu_torch import benchmark
dev = torch.device("cuda")
out = {}
for label, kw in (("onthefly", dict(solver="merged", metric="onthefly")),
                  ("fused highest", dict(solver="fused", precision="highest",
                                         factor="twostage", metric="onthefly",
                                         windowing="pieces"))):
    r = benchmark.run_one(4, 13, device=dev, **kw)
    out[f"{label} time/it"] = r.time_per_it * 1e3
    out[f"{label} time/matvec"] = r.time_per_matvec * 1e3
print(json.dumps(out))
'''


_TIME_DENSE = r'''
import json, torch
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.utils import timing
dev = torch.device("cuda")
out = {}
for p, s in ((4, 13), (2, 16)):
    for precision, metric in (("split2m", "precomputed"),
                              ("split2m", "onthefly"),
                              ("highest", "precomputed")):
        pb = bp4.build(s, p, torch.float32, precision, factor="dense",
                       metric=metric, windowing="pieces", device=dev)
        op = pb.op
        gen = torch.Generator(device=dev).manual_seed(2)
        x, g, d, h = [(torch.randn((3,) + op.n_nodes_axis, generator=gen,
                                   device=dev) * op.mask).contiguous()
                      for _ in range(4)]
        prec = pb.inv_diag.reshape((1,) + op.n_nodes_axis).contiguous()
        scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6],
                            device=dev)
        o, work = torch.empty_like(d), fk.Workspace(op)
        bufs = tuple(torch.empty_like(t) for t in (x, g, d, h, scal))
        tag = f"p{p} {precision} {metric}"
        out[f"B1 {tag}"] = timing.time_per_call(
            lambda: fk.matvec(op, d, out=o, work=work), dev, inner=20,
            repeats=5) * 1e3
        out[f"B2 {tag}"] = timing.time_per_call(
            lambda: fk.fused_cg_iteration(op, x, g, d, h, scal, prec,
                                          out=bufs, work=work), dev,
            inner=20, repeats=5) * 1e3
        if metric == "precomputed" and precision == "split2m":
            out[f"B5 {tag}"] = timing.time_per_call(
                lambda: la.apply_lattice_pieces(op, d), dev, inner=20,
                repeats=5) * 1e3
        del pb, op, x, g, d, h, prec, o, work, bufs
        torch.cuda.empty_cache()
print(json.dumps(out))
'''


# B2's PX row gather with the storage of P or x fixed at compile time in
# place of the warp-uniform flags (``px``)
_GATHER_P = "pv[k] = load_px(io.prec, node, io.prec_bf16);"
_GATHER_X = "if (owner[k]) xv[k] = load_px(io.x, idx[k], io.x_bf16);"
_STORE_X = "set_x2<PX>(io, idx[k],"
PX = {
    "px_base": [],
    "ct_p": [(CM, _GATHER_P, "pv[k] = load_px(io.prec, node, true);"),
             (CM, _GATHER_X, "if (owner[k]) xv[k] = __ldg(io.x + idx[k]);"),
             (CM, _STORE_X, "set_x2<false>(io, idx[k],")],
    "ct_x": [(CM, _GATHER_P, "pv[k] = __ldg(io.prec + node);"),
             (CM, _GATHER_X, "if (owner[k]) xv[k] = load_px(io.x, idx[k], "
                             "true);"),
             (CM, _STORE_X, "[&](size_t i_, float v_) { store_px(io.x2, i_, "
                            "v_, true); }(idx[k],")],
}

_TIME_PX = r'''
import json, os, torch
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import laplace_cuda
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.utils import profiling
dev = torch.device("cuda")
op = laplace_cuda.make_operator(
    DofLayout(BoxMesh.from_s(13), 4), torch.float32, "split2m",
    factor="twostage", metric="onthefly", device=dev, windowing="pieces")
gen = torch.Generator(device=dev).manual_seed(1)
shape = (3,) + op.n_nodes_axis
x, g, d, h = [(torch.randn(shape, generator=gen, device=dev) * op.mask)
              .contiguous() for _ in range(4)]
prec = ((torch.rand((1,) + op.n_nodes_axis, generator=gen, device=dev)
         + 0.5) * op.mask).contiguous()
scal = torch.tensor([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6], device=dev)
work = fk.Workspace(op)
name = os.path.basename(os.getcwd())
cases = {"ct_p": ("P_bf16",), "ct_x": ("x_bf16",)}.get(
    name, ("f32", "P_bf16", "x_bf16"))
out = {}
for case, xx, pp in (("f32", x, prec), ("P_bf16", x, prec.bfloat16()),
                     ("x_bf16", x.bfloat16(), prec)):
    if case not in cases:
        continue
    o = tuple(torch.empty_like(t) for t in (xx, g, d, h, scal))
    rows, _ = profiling.kernel_breakdown(
        lambda: [fk.fused_cg_iteration(op, xx, g, d, h, scal, pp, out=o,
                                       work=work) for _ in range(30)], dev)
    out[case] = [sec / calls * 1e3 for k, calls, sec in rows
                 if "cells_mma" in k][0]
print(json.dumps(out))
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


def build_all(variants: dict, kernel: str = "cells_mma_kernelILi4ELb1E"
              ) -> dict[str, Path]:
    """Copy, patch and build every variant at once; return the built ones
    and print the ptxas resource line of ``kernel`` (a mangled-name
    fragment) in each."""
    return build_roots({name: _copy(name, p) for name, p in variants.items()},
                       kernel)


def build_roots(roots: dict[str, Path], kernel: str) -> dict[str, Path]:
    """Build the package under every root (a directory holding it) at once;
    return the built ones and print the ptxas lines of ``kernel``."""
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
                    kernel in line:
                entry = line.split("'")[1] if "'" in line else kernel
                print(f"{name} {entry[:60]}: " + " | ".join(
                    s.split("ptxas info    : ")[-1].strip()
                    for s in lines[i + 1:i + 4]))
    return built


def time_in_turns(built: dict[str, Path], code: str) -> dict[str, list]:
    """Run ``code`` (prints one JSON line) in every built variant, every
    variant and then every variant in reverse order; the rows of each."""
    names = list(built)
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            r = _run(built[name], code)
            if r.returncode:
                print(f"{name}: run failed\n{r.stderr[-2000:]}")
                continue
            times[name].append(json.loads(r.stdout.splitlines()[-1]))
    return times


def _print_min(times: dict[str, list], width: int) -> None:
    """Each variant's minimum of every timed key over its runs."""
    for name, rows in times.items():
        if rows:
            print(f"{name:{width}s} " + "  ".join(
                f"{k} {min(r[k] for r in rows):.4f}" for k in rows[0])
                + " ms")


def main(argv: list[str] | None = None) -> None:
    which = (argv if argv is not None else sys.argv[1:]) or ["ablate"]
    sf_names = [w for w in which if w in SUMFAC]
    # other trees first: they run first and last (A, B, B, A)
    others = {Path(w).name: Path(w).resolve() for w in which
              if Path(w).is_dir()}
    for mode, code in (("rebuilt", _TIME_REBUILT), ("sumfac", _TIME_SUMFAC),
                       ("paths", _TIME_PATHS), ("dense", _TIME_DENSE)):
        if mode in which:
            names = sf_names or (["sf_base"] if others or mode != "sumfac"
                                 else list(SUMFAC))
            roots = dict(others)
            roots.update({n: _copy(n, SUMFAC[n]) for n in names})
            _print_min(time_in_turns(build_roots(roots, SF_KERNEL), code), 20)
    if "sfstamps" in which:
        for name, root in build_all(SF_STAMPS, SF_KERNEL).items():
            r = _run(root, _READ_SF_STAMPS)
            print(f"{name}:\n{r.stdout}{r.stderr[-2000:]}")
    if "stamps" in which:
        for name, root in build_all(STAMPS).items():
            r = _run(root, _READ_STAMPS)
            print(f"{name}:\n{r.stdout}{r.stderr[-2000:]}")
    if "px" in which:
        _print_min(time_in_turns(build_all(PX, "cells_mma_kernelILi4ELb1E"),
                                 _TIME_PX), 10)
    if "ablate" in which:
        times = time_in_turns(build_all(ABLATE), _TIME)
        for name, rows in times.items():
            if rows:
                print(f"{name:12s} B1 {min(t['b1_ms'] for t in rows):.4f} ms"
                      f"  B2 {min(t['b2_ms'] for t in rows):.4f} ms  "
                      f"(each run: "
                      f"{[round(t['b1_ms'], 4) for t in rows]} / "
                      f"{[round(t['b2_ms'], 4) for t in rows]})")


if __name__ == "__main__":
    main()
