// The f32 tensor-core cell pass of the matvec (B1) and the fused CG
// iteration (B2) (sm_90a, mma.sync m16n8k16, bf16 x bf16 products, f32
// accumulation) at the rungs split2m, split3 and bf16; cg_fused.cu's
// assemble and finalize passes follow it unchanged.
//
// Replaces, under precision "split2m" (and "split3", "bf16"), the cell work
// of the TPU kernels of
// mf_data_locality_tpu/ops/cg_fused_kernel.py:
//   B1  piece_vmult -> _matvec_kernel          (pallas_call :1116)
//   B2  fused_cg_iteration -> _fused_cg_kernel (pallas_call :1476)
// for the twostage + onthefly configuration at p=4: the metric rebuilt by
// the adjj chain (the JAX auto-dispatch's) or by jtj (COFACTOR).  Degrees
// 5..11, and p=4 with the streamed metric, run on cell_mma_hd.cuh.
// "highest" (f32, f64) runs on the CUDA cores (apply_sumfac.cuh): bf16
// products cannot give exact f32 or f64.
//
// split2m (_prestack :86-99, _mm_pre :328-355) is by definition bf16 x bf16
// products with f32 accumulation: the 2D matrices M rounded once to bf16,
// the streamed operand (uS, uD forward, t backward) split into hi =
// bf16(x) and lo = bf16(x - hi), K-stacked as [Mh | Mh] [xh; xl].  The
// rung is the template parameter NP (mma.cuh): split3 adds xh Ml beside
// each pair, from Ml's tables, which a split3 block copies to shared
// memory after the rest (18.4 KB more at p=4: 102 KB a block, still two
// blocks an SM); bf16 keeps xh Mh only.  The split3 and bf16
// instantiations read d and h in bf16 where the state is (io.bf16).
//
// What one block computes: a tile of 16 consecutive cells (the m16 rows),
// one warp per component (and a fourth that helps with the gather and the
// metric), in the transposed form with rows = cells, plane by plane (qz),
// as _operator_block's twostage branch (:583-651):
//   z stage   uS, uD (16, (ky,kx)) = sum_kz Sz|Dz[qz,kz] u[kz], f32 FMA,
//             unrounded, at the thread's own A-fragment entries, split
//             hi/lo into the fragments: uS and uD never go to memory
//   forward   [gx | gy] (16, 2 q^2) = [uSh | uSl] . [Mxy^T; Mxy^T],
//             gz (16, q^2) = [uDh | uDl] . [Mz^T; Mz^T], in chunks of 16
//             q-points: six n8 tiles (x, y, z x two halves), so one thread
//             holds gx, gy and gz of the same (cell, q-point)
//   metric    G of a plane, rebuilt once per (cell, q-point) by the
//             whole block into shared memory (adjj or jtj chain, exact
//             f32), read
//             by the three component warps; plane qz + 1's is built while
//             plane qz's is read (two buffers, one barrier a plane)
//   apply     t = G [gx, gy, gz] on the accumulators and split hi/lo: the
//             accumulator layout is the backward's A fragment, t never
//             leaves registers
//   backward  w1 (16, (ky,kx)) = [t0h|t0l] [Mx; Mx] + [t1h|t1l] [My; My],
//             w2 = [t2h|t2l] [Mz; Mz]
//   z back    v[kz] += Sz[qz,kz] w1 + Dz[qz,kz] w2, f32, in registers
//             across the planes (qz = 0, 1, ... in order)
//   output    v staged through the warp's input rows in shared memory, then
//             written masked and coalesced to the cell-local scratch
//             (C, n_cells, (P+1)^3) that cg_fused.cu's assemble pass reads.
// No atomics; every sum has a fixed order, so results repeat bit for bit.
//
// Tables: the 2D matrices in bf16, rounded once on the host, each
// direction's q^2 rows zero-padded to Q2P (36 -> 48 at p=4) and the (P+1)^2
// columns to P12P (25 -> 32), packed as the B-operand fragments the warps
// load (laplace_cuda.mma_tables(..., "twostage")): the forward's (B =
// Mh^T) and the backward's (B = Mh), 9 KB each at p=4, copied to shared
// memory by every block.  Padded columns of u and q-points of the metric
// are zeros; a ragged last tile computes on zeros and stores nothing past
// n_cells.  The gather (B2: with update4b) of a tile inside one x row of
// cells loads each (c, z, y) node row once, 65 contiguous floats at p=4
// (gather_row_tile); a tile that crosses rows or the end gathers per cell.
//
// Bound (p=4, s=13, 8192 cells, per apply): the 2D stage is 3 components x
// 6 planes x 10,800 FMA x 2 stream parts per cell, 3.2e9 bf16 FLOP, 3.2
// us at 989 TFLOP/s; the f32 work on the CUDA cores (z stages 9,000, metric
// apply 5,832, metric rebuild ~24,800 FMA per cell) is ~3.3e8 FMA, 9.7 us
// at 67 TFLOP/s; B1's d read and h written are 13.9 MB, 4.1 us at 3.35
// TB/s (B2: 55 MB, 16.5 us).  The f32 CUDA-core work sets B1's bound.
//
// What bounded the design this replaces (a CUDA-core pass with bf16 stream
// parts, one 256-thread block per cell; 0.425 ms for B1 at p=4 s=13 on an
// H100 80GB HBM3 at 700 W): its forward loop issued 5 shared loads per 3
// FMAs and its backward 2 per FMA, capping it near 15% of the f32 peak; the
// split2m products ran as f32 FMAs on the CUDA cores; and every block paid
// a fixed cost per cell: 10.8 KB of 2D matrices reloaded from L2, 4
// barriers, a metric rebuild with 216 of 256 threads busy, backward loops
// of 450 items over 256 threads.
//
// Budget (p=4): 128 threads a block, the three component warps and a fourth
// that shares the gather and the metric rebuild (registers are allocated
// as for 128 threads even to a 96-thread block); shared memory 83.4 KB a
// block (tables 18.4 KB, u/v 32.3 KB, two metric planes 30.7 KB,
// coefficients, cell coordinates and z factors 2.0 KB), so two blocks
// (eight warps) fit an SM; ptxas gives ~242 registers and no spill under
// __launch_bounds__(128, 2) (v takes 80, w1/w2 32, the A fragments 32, the
// forward accumulators 24).  Three 96-thread blocks an SM (one metric
// buffer, a cap of 168 registers) spilled and ran slower.  Row strides of
// u (LDU) and the metric (LDG) are 8 mod 16 words, so the float2 loads of a
// half warp hit distinct banks.  Where the time goes (PERF.md, from
// utils/variants.py): a quarter of a block's cycles in the prologue
// (tables, gather), 60% in the six planes, of which the metric rebuild,
// latency-bound at eight warps an SM, takes about half; the tensor cores
// are far from busy.

#pragma once

#include "bp4_operator.cuh"
#include "mma.cuh"

namespace bp4 {

constexpr int kTileCells = 16;               // cells per tile: the m16 rows
// one warp per component, and a fourth for the gather and the metric
// rebuild: a 96-thread block holds the registers of 128 threads anyway
constexpr int kCellMmaThreads = 32 * (kComps + 1);

template <int P>
struct CellMmaShape {
  using S = Shape<P>;
  static constexpr int Q2P = (S::Q2 + 15) / 16 * 16;    // q-points a plane
  static constexpr int P12P = (S::P12 + 15) / 16 * 16;  // (ky, kx) columns
  static constexpr int QC = Q2P / 16;  // q-point chunks of a plane
  static constexpr int KF = P12P / 16;  // k16 steps of the forward
  static constexpr int KB = 3 * QC;     // k16 steps of the backward
  static constexpr int NF = 3 * Q2P / 8;  // n8 tiles of the forward
  static constexpr int NB = P12P / 8;     // n8 tiles of the backward
  static constexpr int LDU = S::P1 * P12P + 8;       // u/v words a cell
  static constexpr int LDG = (S::Q2 + 7) / 16 * 16 + 8;  // metric words a cell
  static constexpr int LDC = 25;                     // coefficients a cell
  static constexpr int TF = NF * KF * 32;  // uint2 fragments, forward table
  static constexpr int TB = NB * KB * 32;  // backward table
  static_assert(LDG >= S::Q2 && LDG % 2 == 0 && LDU % 16 == 8 &&
                    LDG % 16 == 8 && (TF + TB) % 2 == 0,
                "strides and tables of the tensor-core cell pass");
};

template <int P>
struct CellMmaSmem {
  using S = Shape<P>;
  using Ms = CellMmaShape<P>;
  uint2 mf[Ms::TF];  // forward fragments (B = Mh^T); mb follows contiguously
  uint2 mb[Ms::TB];  // backward fragments (B = Mh)
  float u[kComps][kTileCells][Ms::LDU];  // input (kz, (ky,kx)); v at the end
  float g[2][6][kTileCells][Ms::LDG];    // metric of two qz planes
  float c24[kTileCells][Ms::LDC];
  int cc[kTileCells][3];  // cell coordinates (cz, cy, cx)
  float sz[S::Q * S::P1];
  float dz[S::Q * S::P1];
};

// Ml's fragment tables (split3), forward then backward, after the rest.
template <int P>
struct CellMmaSmemSplit3 : CellMmaSmem<P> {
  alignas(16) uint2 ml[CellMmaShape<P>::TF + CellMmaShape<P>::TB];
};
template <int P, int NP>
using CellMmaSmemFor =
    std::conditional_t<rung_of(NP) == 3, CellMmaSmemSplit3<P>, CellMmaSmem<P>>;

// The input of a tile inside one x row of cells (every tile when 16
// divides ncx): its (c, kz, ky) node rows are runs of 16 P + 1 contiguous
// nodes, each loaded once, in batches whose loads all issue before the
// batch's first store, and written to the one or two cells that hold it.
// The owner of a node (it writes B2's x', g', d') is the cell it is local
// node kx < P of, or the tile's last cell when that ends the x row, as in
// cell_input.  FLEX: d and h may be bf16 (io.bf16), and PX: P and x
// (io.prec_bf16, io.x_bf16), as in cell_input.
template <int P, bool FUSED, bool FLEX, bool PX = false>
__device__ void gather_row_tile(CellMmaSmem<P>& sm, const CellIo<float>& io,
                                const float (&sc)[4], const Grid& gr,
                                int cell0) {
  using S = Shape<P>;
  constexpr int P1 = S::P1, P12P = CellMmaShape<P>::P12P;
  constexpr int ROW = kTileCells * P + 1;
  constexpr int ITEMS = kComps * P1 * P1 * ROW;
  constexpr int BATCH = FUSED ? 10 : 20;
  const int cx0 = cell0 % gr.ncx, cy = (cell0 / gr.ncx) % gr.ncy,
            cz = cell0 / (gr.ncx * gr.ncy);
  const size_t n_nodes = gr.n_nodes();
  for (int i0 = threadIdx.x; i0 < ITEMS; i0 += BATCH * kCellMmaThreads) {
    float dv[BATCH], gv[BATCH], hv[BATCH], pv[BATCH], xv[BATCH];
    size_t idx[BATCH];
    bool owner[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * kCellMmaThreads;
      const int ox = i % ROW, row = i / ROW;  // row = (c, kz, ky)
      const int b = min(ox / P, kTileCells - 1), kx = ox - P * b;
      const int c = row / (P1 * P1), kz = (row / P1) % P1, ky = row % P1;
      const size_t node = (static_cast<size_t>(cz * P + kz) * gr.ny +
                           cy * P + ky) * gr.nx + cx0 * P + ox;
      idx[k] = c * n_nodes + node;
      owner[k] = (kz < P || cz == gr.ncz - 1) &&
                 (ky < P || cy == gr.ncy - 1) &&
                 (kx < P || cx0 + b == gr.ncx - 1);
      if (i < ITEMS) {
        if constexpr (FLEX)
          dv[k] = ldg_flex(io.d, idx[k], io.bf16);
        else
          dv[k] = __ldg(io.d + idx[k]);
        if constexpr (FUSED) {
          gv[k] = __ldg(io.g + idx[k]);
          if constexpr (FLEX)
            hv[k] = ldg_flex(io.h, idx[k], io.bf16);
          else
            hv[k] = __ldg(io.h + idx[k]);
          if constexpr (PX) {
            pv[k] = load_px(io.prec, node, io.prec_bf16);
            if (owner[k]) xv[k] = load_px(io.x, idx[k], io.x_bf16);
          } else {
            pv[k] = __ldg(io.prec + node);
            if (owner[k]) xv[k] = __ldg(io.x + idx[k]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * kCellMmaThreads;
      if (i >= ITEMS) break;
      const int ox = i % ROW, row = i / ROW;
      const int b = min(ox / P, kTileCells - 1), kx = ox - P * b;
      const int c = row / (P1 * P1), kz = (row / P1) % P1, ky = row % P1;
      float val = dv[k];
      if constexpr (FUSED) {
        const float gn = gv[k] + sc[0] * hv[k];
        val = sc[1] * dv[k] - pv[k] * gn;
        if constexpr (FLEX) val = round_flex(val, io.bf16);
        if (owner[k]) {
          set_x2<PX>(io, idx[k],
                     xv[k] + sc[2] * dv[k] + sc[3] * (pv[k] * gv[k]));
          io.g2[idx[k]] = gn;
          if constexpr (FLEX)
            store_flex(io.d2, idx[k], val, io.bf16);
          else
            io.d2[idx[k]] = val;
        }
      }
      if (!interior(gr, cz * P + kz, cy * P + ky, cx0 * P + ox)) val = 0.f;
      const int l = kz * P12P + ky * P1;
      sm.u[c][b][l + kx] = val;
      if (kx == 0 && b > 0) sm.u[c][b - 1][l + P] = val;
    }
  }
}

// The input of any other tile (ragged, or crossing a row of cells): per
// (cell, local node), kx fastest, then the tile's cells, then (c, kz, ky).
template <int P, bool FUSED, bool FLEX, bool PX = false>
__device__ void gather_cells(CellMmaSmem<P>& sm, const CellIo<float>& io,
                             const float (&sc)[4], const Grid& gr, int cell0) {
  using S = Shape<P>;
  constexpr int P1 = S::P1, P12 = S::P12, P12P = CellMmaShape<P>::P12P;
  const int nc = gr.n_cells();
  for (int i = threadIdx.x; i < kComps * P12 * kTileCells * P1;
       i += kCellMmaThreads) {
    const int kx = i % P1, b = (i / P1) % kTileCells;
    const int row = i / (P1 * kTileCells);  // (c, kz, ky)
    const int c = row / P12, kz = (row / P1) % P1, ky = row % P1;
    const int cell = cell0 + b;
    float val = 0.f;
    if (cell < nc) {
      const int cx = cell % gr.ncx, cy = (cell / gr.ncx) % gr.ncy,
                cz = cell / (gr.ncx * gr.ncy);
      val = cell_input<float, P, FUSED, FLEX, PX>(io, sc, gr, c, cz, cy, cx,
                                                  kz, ky, kx);
    }
    sm.u[c][b][kz * P12P + ky * P1 + kx] = val;
  }
}

// The metric entries of plane qz at the tile's cells into g (the padded
// q-points of g are zeroed once by the caller; cells past the end have zero
// coefficients, hence a zero metric): item (q2, b), cells fastest.
template <int P, int COFACTOR>
__device__ void metric_plane(float (&g)[6][kTileCells][CellMmaShape<P>::LDG],
                             const float (&c24)[kTileCells][CellMmaShape<P>::LDC],
                             const OpTables<float>& tb, int qz) {
  constexpr int Q2 = Shape<P>::Q2;
  for (int i = threadIdx.x; i < Q2 * kTileCells; i += kCellMmaThreads) {
    const int b = i % kTileCells, q2 = i / kTileCells, qp = qz * Q2 + q2;
    const float4* row = reinterpret_cast<const float4*>(tb.pds + qp * 24);
    float pq[24], gm[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float4 r = __ldg(row + k);
      pq[4 * k] = r.x;
      pq[4 * k + 1] = r.y;
      pq[4 * k + 2] = r.z;
      pq[4 * k + 3] = r.w;
    }
    onthefly_metric<1, COFACTOR>(pq, c24[b], __ldg(tb.w3 + qp), gm);
#pragma unroll
    for (int e = 0; e < 6; ++e) g[e][b][q2] = gm[e];
  }
}

// tb.mats: the two fragment tables, forward then backward, TF + TB uint2
// (split3: Ml's two follow).  NP: the rung's products a tile (mma.cuh).
// PX: B2 with P or x in bf16 (io.prec_bf16, io.x_bf16).
template <int P, bool FUSED, int COFACTOR, int NP, bool PX = false>
__global__ void __launch_bounds__(kCellMmaThreads, 2)
    cells_mma_kernel(OpTables<float> tb, Grid gr, CellIo<float> io,
                     float* __restrict__ cells) {
  using S = Shape<P>;
  using Ms = CellMmaShape<P>;
  constexpr int P1 = S::P1, P12 = S::P12, P13 = S::P13, Q2 = S::Q2;
  constexpr int P12P = Ms::P12P, LDU = Ms::LDU, LDG = Ms::LDG;
  // the bf16 state: the bf16 rung's, and the storage instantiations'
  constexpr bool FLEX = rung_of(NP) == 1 || (NP & kSbState) != 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<CellMmaSmemFor<P, NP>*>(smem_raw);
  const int tid = threadIdx.x;
  const int nc = gr.n_cells();
  const int cell0 = blockIdx.x * kTileCells;

  // tables (all loads issue before the first store), z factors, the
  // tile's coefficients and cell coordinates (zero past the end)
  {
    constexpr int NT = (Ms::TF + Ms::TB) / 2;  // uint4
    constexpr int PER = (NT + kCellMmaThreads - 1) / kCellMmaThreads;
    const uint4* tsrc = reinterpret_cast<const uint4*>(tb.mats);
    uint4* tdst = reinterpret_cast<uint4*>(sm.mf);
    uint4 t[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (tid + k * kCellMmaThreads < NT)
        t[k] = __ldg(tsrc + tid + k * kCellMmaThreads);
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (tid + k * kCellMmaThreads < NT) tdst[tid + k * kCellMmaThreads] = t[k];
    if constexpr (rung_of(NP) == 3) {  // Ml's tables, the same way
      uint4* ldst = reinterpret_cast<uint4*>(sm.ml);
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (tid + k * kCellMmaThreads < NT)
          t[k] = __ldg(tsrc + NT + tid + k * kCellMmaThreads);
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (tid + k * kCellMmaThreads < NT)
          ldst[tid + k * kCellMmaThreads] = t[k];
    }
  }
  for (int i = tid; i < S::Q * P1; i += blockDim.x) {
    sm.sz[i] = tb.sz[i];
    sm.dz[i] = tb.dz[i];
  }
  for (int i = tid; i < kTileCells * 24; i += blockDim.x) {
    const int b = i / 24, cell = cell0 + b;
    sm.c24[b][i % 24] = cell < nc ? tb.coeffs[cell * 24 + i % 24] : 0.f;
  }
  if (tid < kTileCells) {
    const int cell = cell0 + tid;
    sm.cc[tid][0] = cell / (gr.ncx * gr.ncy);
    sm.cc[tid][1] = (cell / gr.ncx) % gr.ncy;
    sm.cc[tid][2] = cell % gr.ncx;
  }
  // padded q-points of the metric and (ky, kx) columns of u are zero
  constexpr int GPAD = LDG - Q2;
  for (int i = tid; i < 2 * 6 * kTileCells * GPAD; i += blockDim.x)
    (&sm.g[0][0][0][0])[i / GPAD * LDG + Q2 + i % GPAD] = 0.f;
  constexpr int NPAD = P12P - P12;
  for (int i = tid; i < kComps * kTileCells * P1 * NPAD; i += blockDim.x) {
    const int row = i / NPAD;  // (c, b, kz)
    sm.u[row / (kTileCells * P1)][(row / P1) % kTileCells]
        [(row % P1) * P12P + P12 + i % NPAD] = 0.f;
  }
  // the input at the tile's nodes; B2's update4b runs here
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (FUSED) {
#pragma unroll
    for (int k = 0; k < 4; ++k) sc[k] = io.scal[k];
  }
  if (cell0 + kTileCells <= nc && cell0 % gr.ncx + kTileCells <= gr.ncx)
    gather_row_tile<P, FUSED, FLEX, PX>(sm, io, sc, gr, cell0);
  else
    gather_cells<P, FUSED, FLEX, PX>(sm, io, sc, gr, cell0);

  const int warp = tid / 32, lane = tid % 32;
  const int c = warp;                     // this warp's component
  const int gq = lane / 4, t4 = lane % 4;  // fragment row group, column pair
  float v[P1][Ms::NB][4] = {};

  __syncthreads();  // coefficients ready
  metric_plane<P, COFACTOR>(sm.g[0], sm.c24, tb, 0);
  for (int qz = 0; qz < S::Q; ++qz) {
    // plane qz's metric and the inputs are ready, and every warp is done
    // with plane qz - 1, whose buffer now takes plane qz + 1's metric
    __syncthreads();
    if (qz + 1 < S::Q)
      metric_plane<P, COFACTOR>(sm.g[(qz + 1) & 1], sm.c24, tb, qz + 1);
    if (warp == kComps) continue;  // the fourth warp only rebuilds metrics
    const auto& gpl = sm.g[qz & 1];
    const float* uc = &sm.u[c][0][0];

    // z stage at this thread's A-fragment entries: register r4 of k16 step
    // ks holds cell gq + 8 (r4 & 1), columns 16 ks + 8 (r4 >> 1) + 2 t4 + {0, 1}
    uint32_t ash[Ms::KF][4], asl[Ms::KF][4], adh[Ms::KF][4], adl[Ms::KF][4];
#pragma unroll
    for (int ks = 0; ks < Ms::KF; ++ks)
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const float* up = uc + (gq + 8 * (r4 & 1)) * LDU + 16 * ks +
                          8 * (r4 >> 1) + 2 * t4;
        float2 s, d;
#pragma unroll
        for (int kz = 0; kz < P1; ++kz) {
          const float2 x = *reinterpret_cast<const float2*>(up + kz * P12P);
          const float a = sm.sz[qz * P1 + kz], bz = sm.dz[qz * P1 + kz];
          if (kz == 0) {
            s = make_float2(x.x * a, x.y * a);
            d = make_float2(x.x * bz, x.y * bz);
          } else {
            s = make_float2(fmaf(x.x, a, s.x), fmaf(x.y, a, s.y));
            d = make_float2(fmaf(x.x, bz, d.x), fmaf(x.y, bz, d.y));
          }
        }
        stream_parts<rung_of(NP)>(s.x, s.y, ash[ks][r4], asl[ks][r4]);
        stream_parts<rung_of(NP)>(d.x, d.y, adh[ks][r4], adl[ks][r4]);
      }

    float w1[Ms::NB][4] = {}, w2[Ms::NB][4] = {};
#pragma unroll
    for (int j = 0; j < Ms::QC; ++j) {
      // forward: tile [e][h] = direction e, q-points 16 j + 8 h .. + 7
      float ga[3][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < Ms::KF; ++ks)
#pragma unroll
        for (int e = 0; e < 3; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int nt = e * (Ms::Q2P / 8) + 2 * j + h;
            const uint2 bf = sm.mf[(nt * Ms::KF + ks) * 32 + lane];
            if (e < 2) {
              mma_bf16(ga[e][h], ash[ks], bf);
              if constexpr (rung_of(NP) != 1) mma_bf16(ga[e][h], asl[ks], bf);
            } else {
              mma_bf16(ga[e][h], adh[ks], bf);
              if constexpr (rung_of(NP) != 1) mma_bf16(ga[e][h], adl[ks], bf);
            }
            if constexpr (rung_of(NP) == 3) {
              const uint2 bl = sm.ml[(nt * Ms::KF + ks) * 32 + lane];
              if (e < 2)
                mma_bf16(ga[e][h], ash[ks], bl);
              else
                mma_bf16(ga[e][h], adh[ks], bl);
            }
          }

      // metric apply at this thread's (cell, q-point) entries, split; the
      // result is the backward's A fragment: register 2 h + r holds cells
      // gq + 8 r, q-points 16 j + 8 h + 2 t4 + {0, 1}
      uint32_t th[3][4], tl[3][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q2 = 16 * j + 8 * h + 2 * t4;
          const int b = gq + 8 * r;
          float2 G[6];
#pragma unroll
          for (int e = 0; e < 6; ++e)
            G[e] = q2 < LDG ? *reinterpret_cast<const float2*>(&gpl[e][b][q2])
                            : make_float2(0.f, 0.f);
          float tv[3][2];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float gx = ga[0][h][2 * r + e2], gy = ga[1][h][2 * r + e2],
                        gz = ga[2][h][2 * r + e2];
            const float g00 = e2 ? G[0].y : G[0].x, g01 = e2 ? G[1].y : G[1].x,
                        g02 = e2 ? G[2].y : G[2].x, g11 = e2 ? G[3].y : G[3].x,
                        g12 = e2 ? G[4].y : G[4].x, g22 = e2 ? G[5].y : G[5].x;
            tv[0][e2] = g00 * gx + g01 * gy + g02 * gz;
            tv[1][e2] = g01 * gx + g11 * gy + g12 * gz;
            tv[2][e2] = g02 * gx + g12 * gy + g22 * gz;
          }
#pragma unroll
          for (int e = 0; e < 3; ++e)
            stream_parts<rung_of(NP)>(tv[e][0], tv[e][1], th[e][2 * h + r],
                             tl[e][2 * h + r]);
        }

      // backward over chunk j of each direction's q-points
#pragma unroll
      for (int nt = 0; nt < Ms::NB; ++nt) {
        const uint2* bn = sm.mb + (nt * Ms::KB + j) * 32 + lane;
        const uint2 bx = bn[0], by = bn[Ms::QC * 32], bz = bn[2 * Ms::QC * 32];
        mma_bf16(w1[nt], th[0], bx);
        if constexpr (rung_of(NP) != 1) mma_bf16(w1[nt], tl[0], bx);
        mma_bf16(w1[nt], th[1], by);
        if constexpr (rung_of(NP) != 1) mma_bf16(w1[nt], tl[1], by);
        mma_bf16(w2[nt], th[2], bz);
        if constexpr (rung_of(NP) != 1) mma_bf16(w2[nt], tl[2], bz);
        if constexpr (rung_of(NP) == 3) {
          const uint2* bl = sm.ml + Ms::TF + (nt * Ms::KB + j) * 32 + lane;
          mma_bf16(w1[nt], th[0], bl[0]);
          mma_bf16(w1[nt], th[1], bl[Ms::QC * 32]);
          mma_bf16(w2[nt], th[2], bl[2 * Ms::QC * 32]);
        }
      }
    }

    // backward z stage: w1[nt][2 r + e2] is cell gq + 8 r, column 8 nt +
    // 2 t4 + e2
#pragma unroll
    for (int kz = 0; kz < P1; ++kz) {
      const float a = sm.sz[qz * P1 + kz], bz = sm.dz[qz * P1 + kz];
#pragma unroll
      for (int nt = 0; nt < Ms::NB; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[kz][nt][i] = fmaf(w2[nt][i], bz, fmaf(w1[nt][i], a, v[kz][nt][i]));
    }
  }

  // v into this warp's input rows, then out masked, 16 cells contiguous
  if (warp == kComps) return;
  __syncwarp();
  float* vc = &sm.u[c][0][0];
#pragma unroll
  for (int kz = 0; kz < P1; ++kz)
#pragma unroll
    for (int nt = 0; nt < Ms::NB; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(vc + (gq + 8 * r) * LDU + kz * P12P +
                                   8 * nt + 2 * t4) =
            make_float2(v[kz][nt][2 * r], v[kz][nt][2 * r + 1]);
  __syncwarp();
  const int n_live = min(kTileCells, nc - cell0);
#pragma unroll 4
  for (int b = 0; b < kTileCells; ++b) {
    if (b >= n_live) break;
    const int* cc = sm.cc[b];
    float* dst = cells + (static_cast<size_t>(c) * nc + cell0 + b) * P13;
#pragma unroll
    for (int k = 0; k < (P13 + 31) / 32; ++k) {
      const int l = lane + 32 * k, kz = l / P12, k2 = l % P12;
      if (l < P13)
        dst[l] = interior(gr, cc[0] * P + kz, cc[1] * P + k2 / P1,
                          cc[2] * P + k2 % P1)
                     ? vc[b * LDU + kz * P12P + k2]
                     : 0.f;
    }
  }
}

template <int P, bool FUSED, int COFACTOR, int NP, bool PX = false>
cudaError_t launch_cells_mma_here(const OpTables<float>& tb, const Grid& gr,
                                  const CellIo<float>& io, float* cells,
                                  cudaStream_t st) {
  using Sm = CellMmaSmemFor<P, NP>;
  auto kern = cells_mma_kernel<P, FUSED, COFACTOR, NP, PX>;
  // above 48 KB a block's shared memory must be requested explicitly
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Sm));
  if (attr != cudaSuccess) return attr;
  const int blocks = (gr.n_cells() + kTileCells - 1) / kTileCells;
  kern<<<blocks, kCellMmaThreads, sizeof(Sm), st>>>(tb, gr, io, cells);
  return cudaGetLastError();
}

// The pass of one configuration: split2m (NP = 2) is instantiated where it
// is called (cg_fused.cu), split3 and bf16 in mma_rungs.cu.
template <int P, bool FUSED, int COFACTOR, int NP, bool PX = false>
cudaError_t launch_cells_mma(const OpTables<float>& tb, const Grid& gr,
                             const CellIo<float>& io, float* cells,
                             cudaStream_t st) {
  return launch_cells_mma_here<P, FUSED, COFACTOR, NP, PX>(tb, gr, io, cells,
                                                           st);
}

#define BP4_CELL_MMA_SIGNATURE(FUSED, COFACTOR, NP, PX)                   \
  template <>                                                             \
  cudaError_t launch_cells_mma<4, FUSED, COFACTOR, NP, PX>(               \
      const OpTables<float>& tb, const Grid& gr, const CellIo<float>& io, \
      float* cells, cudaStream_t st)
#define BP4_CELL_MMA_DECLARE1(FUSED, COFACTOR, NP, PX) \
  BP4_CELL_MMA_SIGNATURE(FUSED, COFACTOR, NP, PX);
#define BP4_CELL_MMA_DEFINE1(FUSED, COFACTOR, NP, PX)                        \
  BP4_CELL_MMA_SIGNATURE(FUSED, COFACTOR, NP, PX) {                          \
    return launch_cells_mma_here<4, FUSED, COFACTOR, NP, PX>(tb, gr, io,    \
                                                             cells, st);    \
  }
// B1, B2 x the rebuilt metric's chains, at p=4; B2 also with P or x in bf16
#define BP4_CELL_MMA_RUNG(NP, M)                                          \
  M(false, kAdjj, NP, false) M(false, kJtj, NP, false)                    \
  M(true, kAdjj, NP, false) M(true, kJtj, NP, false)                      \
  M(true, kAdjj, NP, true) M(true, kJtj, NP, true)

BP4_CELL_MMA_RUNG(1, BP4_CELL_MMA_DECLARE1)
BP4_CELL_MMA_RUNG(3, BP4_CELL_MMA_DECLARE1)

// the storage instantiations (mma_sb.cu): the bf16 state (kSbState) at
// split2m and split3, the bf16 rung's reading it by io.bf16 already; B2's
// in its P/x form (PX: P and x at f32 or in bf16 by io.prec_bf16 and
// io.x_bf16, with both 0 bitwise the form without it)
#define BP4_CELL_MMA_SB(NP, M)                                \
  M(false, kAdjj, NP, false) M(false, kJtj, NP, false)        \
  M(true, kAdjj, NP, true) M(true, kJtj, NP, true)
BP4_CELL_MMA_SB(6, BP4_CELL_MMA_DECLARE1)
BP4_CELL_MMA_SB(7, BP4_CELL_MMA_DECLARE1)

}  // namespace bp4
