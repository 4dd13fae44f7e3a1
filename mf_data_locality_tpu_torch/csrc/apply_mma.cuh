// The f32 tensor-core cell pass of the dense factorization (sm_90a,
// mma.sync m16n8k16, bf16 x bf16 products, f32 accumulation): v = sum_e
// M_e^T G_ef M_f u per cell, on cell batches (B3) and on the lattice (B5,
// B6, B1, B2; the assemble pass follows in laplace_apply.cu and
// cg_fused.cu), at the rungs split2m, split3 and bf16.
//
// Replaces, under precision "split2m" (and "split3", "bf16"), the TPU
// kernels
//   B3  laplace_pallas.py   _kernel_g          :479  (pallas_call :1023)
//   B6  laplace_pallas.py   _kernel_g_zslab    :576  (pallas_call :664)
//   B5  laplace_pallas.py   _kernel_g_pieces   :845  (pallas_call :947)
//   B1  cg_fused_kernel.py  _matvec_kernel           (pallas_call :1116)
//   B2  cg_fused_kernel.py  _fused_cg_kernel         (pallas_call :1476)
// of mf_data_locality_tpu/ops/, B1 and B2 in the dense factorization (the
// JAX auto-dispatch's fused configuration under split2m at p=1..3).  The
// "highest" and f64 rungs run the sum-factorized pass (apply_sumfac.cuh):
// bf16 products cannot give exact f32 or f64.
//
// split2m (laplace_pallas._mm :447-463) is by definition bf16 x bf16
// products with f32 accumulation: M rounded once to bf16, the streamed
// operand (u forward, t backward) split into hi = bf16(x) and lo =
// bf16(x - hi), K-stacked as [Mh | Mh] [xh; xl].  That is what the tensor
// cores compute.  The rung is the template parameter NP, the products a
// tile (mma.cuh): split3 (NP = 3, _mm :422-446) adds xh Ml beside each
// pair, Ml = bf16(M - Mh) from a second pair of tables; bf16 (NP = 1)
// keeps only xh Mh.  The split3 and bf16 instantiations also read the
// streamed metric in bf16 (x.metric_bf16), the bf16 one B1/B2's d and h in
// bf16 (the bf16 state, x.io.bf16), both upcast at the load; split2m's
// reads f32 only, and its code is what it was before the other rungs came.
// Storage flags above the products a tile (NP = rung | kSbState |
// kSbMetric, bp4_operator.cuh; the products rung_of(NP)): kSbState, built
// at every rung, reads u (B3, B5, B6, B1) or d and h (B2) in bf16 by
// io.bf16 and stores B3's output rounded to bf16 (the bf16 state under any
// rung: a bf16 stream's lo part is zero, so its products add exact zeros,
// which the kernel does not skip); kSbMetric (split2m) reads the streamed
// metric in bf16, fixed at compile time.  Their instantiations are built
// in mma_sb.cu, one object a rung.
//
// What one warp computes: one component of a tile of 16 cells, in the
// transposed form with rows = cells (P13 nodes, R = 3 Q3 gradient rows):
//   forward   g^T (16, R)   = [uh | ul] (16, 2 P13) . [Mh^T; Mh^T]
//   apply     t = G [gx, gy, gz] in f32, on the accumulators
//   backward  v^T (16, P13) = [th | tl] (16, 2 R) . [Mh; Mh]
// The warp walks the q-points in chunks of 16.  A chunk's forward is six
// n8 tiles (3 directions x 2 halves), so one thread holds gx, gy and gz of
// the same (cell, q-point) and the metric apply needs no exchange.  Its
// result in the accumulator layout is the backward's A fragment (the
// accumulator-to-operand reuse of attention kernels): t never leaves
// registers, and each warp accumulates its whole v^T over the chunks in a
// fixed order, with no reduction across warps and no atomics.  A block is
// kMmaGroups cell tiles x 3 components, one warp each; its warps read the
// same M fragments, which L1 then serves.
//
// Tables: M in bf16, rounded once on the host, zero-padded to P13P nodes
// and Q3P q-points per direction (multiples of 16), stored in the order of
// the B-operand fragments the warps load, 8 bytes a lane and 256 coalesced
// bytes a fragment (laplace_cuda.mma_tables): one table for the forward
// (B = Mh^T), one for the backward (B = Mh), 172 KB each at p=4, read
// through L1 from L2; under split3 Ml's two tables follow them (the
// forward's 2 * 3 Q3P P13P bf16 after mf, the backward's as far after mb).  Budget of shared memory: only u's hi and lo parts,
// in bf16 (52 KB a block at p=4), so two blocks (12 warps) fit an SM with
// the register cap of __launch_bounds__.  Padded nodes and cells past the
// end are zeros in shared memory, the metric is zero at padded q-points
// and cells (never read), and a ragged last tile stores nothing past
// n_cells.
//
// Bound (p=4, s=13, 8192 cells): 2 x 2 x 3 x 648 x 125 x 8192 = 7.96e9
// FMAs, 1.6e10 FLOP (1.7e10 with the padding), take ~17 us at the 989
// TFLOP/s dense bf16 peak; u, v and the f32 metric are ~67 MB, ~22 us at
// ~3 TB/s; the M fragments are 344 KB per block of 32 cells, 88 MB from L2
// if L1 serves a block's six warps, 528 MB if not.  Measured on an H100
// 80GB HBM3 at 700 W: 0.169 ms, so 100 TFLOP/s (10% of the peak) and 0.4
// TB/s of DRAM; neither peak bounds it.  Latency does, at 12 warps per SM
// with dependent mma chains (16 deep in the forward), and the fragment
// reads from L2 (3.1 TB/s if L1 serves none).  The cap of 168 registers
// that fits two blocks an SM spills 100 bytes at p=4; one block an SM at
// 255 registers ran 10% slower, one or four cell tiles a block 4-9%.
//
// Input form (FORM, bp4_operator.cuh): kCellBatch (B3), kLattice (B5, B6,
// B1: the gather times the mask), kLatticeUpdate (B2: update4b's d' from
// cell_input, the owner cell writing x', g', d'; the four scalars staged
// once a block).  Metric source (REBUILD): streamed, each thread reading G
// at its own (cell, q-point) entries from global memory; or rebuilt from
// the block's 24 coefficients a cell, staged in shared memory: before each
// chunk of 16 q-points the block's threads rebuild G at the chunk's 16 x 32
// (q-point, cell) slots once (onthefly_metric, as apply_sumfac.cuh does;
// by adjj, or by jtj in the instantiations with kJtjChain)
// into one of two shared buffers, and one barrier a chunk hands them to
// the six warps (double-buffered, so the next chunk's rebuild cannot
// overwrite what a slower warp still reads).  A rebuild per warp would
// repeat it for the three components and hold J and the adjugate in the
// registers beside v's accumulators.  Padded q-points get G = 0, as the JAX
// _pad_row_blocks guard gives them.  Rows of the buffer are 36 words, so
// the warp's reads (t4 selects the q-point pair, g the cell) fall into 32
// banks.  The two buffers and the coefficients add 30.7 KB to a block's
// shared memory (83 KB at p=4: still two blocks an SM).
//
// The CUDA-core design this replaces (apply_kernel with the stream split,
// 1.56 ms at p=4 s=13 on an H100 80GB HBM3 at 700 W) was bound by
// occupancy (f32 stream parts of u and t, 148 KB of shared memory, one
// 256-thread block per SM), by 7.96e9 f32 FMAs on the CUDA cores (~15% of
// their peak), by rounding every f32 M entry to bf16 at each use, and by a
// backward loop of 375 items over 256 threads.

#pragma once

#include "bp4_operator.cuh"
#include "mma.cuh"

namespace bp4 {

constexpr int kMmaCells = 16;  // cells per warp tile: the m16 rows
constexpr int kMmaGroups = 2;  // cell tiles per block
constexpr int kMmaBlockCells = kMmaCells * kMmaGroups;
constexpr int kMmaThreads = 32 * kComps * kMmaGroups;

// SH: the shape flags (bp4_operator.cuh), read by apply_mma_hd.cuh, which
// runs the dense pass at every degree for the shapes beyond BP4's.
template <int P, int SH = 0>
struct MmaShape {
  using S = Shape<P, SH>;
  static constexpr int P13P = (S::P13 + 15) / 16 * 16;  // nodes, padded
  static constexpr int Q3P = (S::Q3 + 15) / 16 * 16;    // q-points a direction
  static constexpr int RP = 3 * Q3P;                    // gradient rows
  static constexpr int QC = Q3P / 16;                   // q-point chunks
  static constexpr int LDU = P13P + 8;  // u row stride: no bank conflicts
};

constexpr int kMmaGLd = 36;  // row stride of the rebuilt metric's buffer

// What the pass reads beyond the fragment tables, the streamed metric and
// its input: the rebuild's tables and update4b's vectors (B2).
struct MmaFusedArgs {
  const float* pds;     // (Q3, 24)
  const float* w3;      // (Q3,)
  const float* coeffs;  // (24, n_cells), the cell fastest
  CellIo<float> io;     // kLatticeUpdate: update4b's vectors and scalars;
                        // io.bf16: B1/B2's d and h in bf16 (NP == 1)
  int metric_bf16 = 0;  // the streamed metric in bf16 (NP != 2)
};

template <bool REBUILD>
struct MmaExtraSmem {
  float sc[4];  // kLatticeUpdate: alpha, beta, c1, aob
};
template <>
struct MmaExtraSmem<true> {
  float sc[4];
  float g[2][6][16][kMmaGLd];      // a chunk's G, entries 00 .. 22, two buffers
  float c24[24][kMmaBlockCells];   // the block's coefficients
};

template <int P, bool REBUILD>
struct MmaSmem {
  // hi and lo parts of the input per (cell tile, component): (cell, node)
  __nv_bfloat16 u[kMmaGroups][kComps][2][kMmaCells][MmaShape<P>::LDU];
  MmaExtraSmem<REBUILD> x;
};

// G at q-points 16 j .. 16 j + 15 of the block's cells, rebuilt from the
// staged coefficients by the chain COFACTOR; zero at padded q-points and
// cells past the end.
template <int P, int COFACTOR>
__device__ __forceinline__ void rebuild_metric_chunk(
    float (&g)[6][16][kMmaGLd], const float (&c24)[24][kMmaBlockCells],
    const MmaFusedArgs& x, int j) {
  for (int i = threadIdx.x; i < 16 * kMmaBlockCells; i += blockDim.x) {
    const int b = i % kMmaBlockCells, ql = i / kMmaBlockCells;
    const int qp = 16 * j + ql;
    float gm[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (qp < Shape<P>::Q3) {
      float pq[24];
      load_pds_row(x.pds + qp * 24, pq);
      onthefly_metric<kMmaBlockCells, COFACTOR>(pq, &c24[0][b],
                                                __ldg(x.w3 + qp), gm);
    }
#pragma unroll
    for (int e = 0; e < 6; ++e) g[e][ql][b] = gm[e];
  }
}

// mf, mb: the forward and backward fragment tables, fragment (n8 tile nt,
// k16 step ks) at (nt * K / 16 + ks) * 32 + lane.  FORM kCellBatch (B3): u
// and out are cell batches (C P13, n_cells); kLattice (B5, B6, B1): u is
// the lattice, gathered times the mask, and out the masked cell-local
// values (C, n_cells, P13); kLatticeUpdate (B2): as kLattice, the input
// update4b's d' (x.io).  REBUILD: G from x.coeffs by the chain
// chain_of(NP) (kJtjChain: jtj, else adjj), gmetric unused.  NP: the
// rung's products a tile (mma.cuh) and the flags.
template <int P, int FORM, bool REBUILD, int NP>
__global__ void __launch_bounds__(kMmaThreads, 2)
    apply_mma_kernel(const uint2* __restrict__ mf, const uint2* __restrict__ mb,
                     const float* __restrict__ gmetric, Grid gr,
                     const float* __restrict__ mask,
                     const float* __restrict__ u, float* __restrict__ out,
                     MmaFusedArgs x) {
  using S = Shape<P>;
  using Ms = MmaShape<P>;
  constexpr int P13 = S::P13, Q3 = S::Q3, P13P = Ms::P13P, Q3P = Ms::Q3P;
  constexpr int KF = P13P / 16, KB = Ms::RP / 16, NB = P13P / 8;
  // split3: Ml's tables, this far after Mh's (laplace_cuda.mma_tables)
  constexpr int ML = 2 * 3 * Q3P * P13P / 4;
  constexpr int kNP = rung_of(NP);  // the products a tile
  constexpr bool kBfState = (NP & kSbState) != 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<MmaSmem<P, REBUILD>*>(smem_raw);
  const int nc = gr.n_cells();
  const size_t n_nodes = gr.n_nodes();
  // the block form: the cells [gr.cbeg, gr.cend) (the layer-range form)
  const int cend = is_block(FORM) ? gr.cend : nc;
  const int cell0 = (is_block(FORM) ? gr.cbeg : 0) +
                    blockIdx.x * kMmaBlockCells;
  const int tid = threadIdx.x;

  if constexpr (is_update(FORM)) {
    if (tid < 4) sm.x.sc[tid] = x.io.scal[tid];
    __syncthreads();
  }
  if constexpr (REBUILD) {
    // the cells' coefficients (zero past the end: a zero metric)
    for (int i = tid; i < 24 * kMmaBlockCells; i += blockDim.x) {
      const int b = i % kMmaBlockCells;
      sm.x.c24[i / kMmaBlockCells][b] =
          cell0 + b < cend
              ? x.coeffs[static_cast<size_t>(i / kMmaBlockCells) * nc + cell0 + b]
              : 0.f;
    }
  }
  // input stream parts; padded nodes and cells past the end are zero
  for (int i = tid; i < kComps * P13P * kMmaBlockCells; i += blockDim.x) {
    const int b = i % kMmaBlockCells, k = (i / kMmaBlockCells) % P13P,
              c = i / (kMmaBlockCells * P13P);
    const int cell = cell0 + b;
    float val = 0.f;
    if (k < P13 && cell < cend) {
      if constexpr (FORM == kLattice) {
        float m;
        const size_t node = cell_node<P>(gr, cell, k, mask, &m);
        if constexpr (kNP != 1 && !kBfState)
          val = u[c * n_nodes + node] * m;
        else
          val = load_flex(u, c * n_nodes + node, x.io.bf16) * m;
      } else if constexpr (is_update(FORM)) {
        val = cell_input<float, P, true, kNP == 1 || kBfState,
                         FORM == kLatticeUpdatePx, is_block(FORM)>(
            x.io, sm.x.sc, gr, c, cell / (gr.ncx * gr.ncy),
            (cell / gr.ncx) % gr.ncy, cell % gr.ncx, k / S::P12,
            (k / S::P1) % S::P1, k % S::P1);
      } else if constexpr (kBfState) {
        val = load_flex(u, static_cast<size_t>(c * P13 + k) * nc + cell,
                        x.io.bf16);
      } else {
        val = u[static_cast<size_t>(c * P13 + k) * nc + cell];
      }
    }
    const __nv_bfloat16 hi = __float2bfloat16_rn(val);
    auto& parts = sm.u[b / kMmaCells][c];
    parts[0][b % kMmaCells][k] = hi;
    if constexpr (kNP != 1)
      parts[1][b % kMmaCells][k] =
          __float2bfloat16_rn(val - __bfloat162float(hi));
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int c = warp % kComps;
  const int g = lane / 4, t4 = lane % 4;  // fragment row group, column pair
  const int tile0 = cell0 + (warp / kComps) * kMmaCells;
  const auto& us = sm.u[warp / kComps][c];

  float v[NB][4] = {};
  for (int j = 0; j < Ms::QC; ++j) {
    if constexpr (REBUILD) {
      rebuild_metric_chunk<P, chain_of(NP)>(sm.x.g[j % 2], sm.x.c24, x, j);
      __syncthreads();
    }
    // forward: g^T at q-points 16 j .. 16 j + 15, tile [d][h] = direction d,
    // q-points 16 j + 8 h .. + 7
    float ga[3][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KF; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const __nv_bfloat16* r0 = &us[n][g][ks * 16 + 2 * t4];
        const __nv_bfloat16* r1 = &us[n][g + 8][ks * 16 + 2 * t4];
        a[n][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[n][1] = *reinterpret_cast<const uint32_t*>(r1);
        a[n][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        a[n][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
      }
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nt = d * (Q3P / 8) + 2 * j + h;
          const uint2 bf = __ldg(mf + (nt * KF + ks) * 32 + lane);
          mma_bf16(ga[d][h], a[0], bf);
          if constexpr (kNP != 1) mma_bf16(ga[d][h], a[1], bf);
          if constexpr (kNP == 3)
            mma_bf16(ga[d][h], a[0], __ldg(mf + ML + (nt * KF + ks) * 32 + lane));
        }
    }

    // metric apply at this thread's (cell, q-point) entries; split, the
    // result is the backward's A fragment: register 2 h + r holds cells
    // g + 8 r, columns 8 h + 2 t4 + {0, 1} of the chunk
    uint32_t th[3][4], tl[3][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int cell = tile0 + g + 8 * r;
        float tv[3][2];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int ql = 8 * h + 2 * t4 + e2, qp = 16 * j + ql;
          const bool live = qp < Q3 && cell < cend;
          float G[6];
#pragma unroll
          for (int e = 0; e < 6; ++e) {
            if constexpr (REBUILD)
              G[e] = sm.x.g[j % 2][e][ql][cell - cell0];
            else if constexpr ((NP & kSbMetric) != 0)
              G[e] = live ? metric_ldg<NP>(
                                gmetric,
                                static_cast<size_t>(e * Q3 + qp) * nc + cell)
                          : 0.f;
            else if constexpr (kNP == 2)
              G[e] = live ? __ldg(gmetric + static_cast<size_t>(e * Q3 + qp) * nc + cell)
                          : 0.f;
            else
              G[e] = live ? ldg_flex(gmetric,
                                     static_cast<size_t>(e * Q3 + qp) * nc + cell,
                                     x.metric_bf16)
                          : 0.f;
          }
          const float gx = ga[0][h][2 * r + e2], gy = ga[1][h][2 * r + e2],
                      gz = ga[2][h][2 * r + e2];
          tv[0][e2] = G[0] * gx + G[1] * gy + G[2] * gz;
          tv[1][e2] = G[1] * gx + G[3] * gy + G[4] * gz;
          tv[2][e2] = G[2] * gx + G[4] * gy + G[5] * gz;
        }
#pragma unroll
        for (int e = 0; e < 3; ++e)
          stream_parts<kNP>(tv[e][0], tv[e][1], th[e][2 * h + r],
                           tl[e][2 * h + r]);
      }

    // backward: v^T += [th | tl] . [Mh; Mh] over gradient rows e Q3P + 16 j
#pragma unroll
    for (int e = 0; e < 3; ++e)
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        const uint2 bb = __ldg(mb + (nt * KB + e * Ms::QC + j) * 32 + lane);
        mma_bf16(v[nt], th[e], bb);
        if constexpr (kNP != 1) mma_bf16(v[nt], tl[e], bb);
        if constexpr (kNP == 3)
          mma_bf16(v[nt], th[e],
                   __ldg(mb + ML + (nt * KB + e * Ms::QC + j) * 32 + lane));
      }
  }

  // v[nt][2 r + e2] is cell tile0 + g + 8 r, node 8 nt + 2 t4 + e2
#pragma unroll
  for (int nt = 0; nt < NB; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cell = tile0 + g + 8 * (i / 2), k = nt * 8 + 2 * t4 + i % 2;
      if (cell >= cend || k >= P13) continue;
      if constexpr (FORM != kCellBatch) {
        float m;
        cell_node<P, is_block(FORM)>(gr, cell, k, mask, &m);
        out[(static_cast<size_t>(c) * nc + cell) * P13 + k] = v[nt][i] * m;
      } else if constexpr (kBfState) {
        store_flex(out, static_cast<size_t>(c * P13 + k) * nc + cell,
                   v[nt][i], x.io.bf16);
      } else {
        out[static_cast<size_t>(c * P13 + k) * nc + cell] = v[nt][i];
      }
    }
}

template <int P, int FORM, bool REBUILD, int NP>
cudaError_t launch_mma_here(const void* mf, const void* mb,
                            const float* gmetric, const Grid& gr,
                            const float* mask, const float* u, float* out,
                            const MmaFusedArgs& x, cudaStream_t st) {
  using Sm = MmaSmem<P, REBUILD>;
  auto kern = apply_mma_kernel<P, FORM, REBUILD, NP>;
  // above 48 KB a block's shared memory must be requested explicitly
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Sm));
  if (attr != cudaSuccess) return attr;
  const int n = is_block(FORM) ? gr.cend - gr.cbeg : gr.n_cells();
  if (n <= 0) return cudaSuccess;  // an empty range of the block form
  kern<<<(n + kMmaBlockCells - 1) / kMmaBlockCells, kMmaThreads, sizeof(Sm),
         st>>>(
      static_cast<const uint2*>(mf), static_cast<const uint2*>(mb), gmetric,
      gr, mask, u, out, x);
  return cudaGetLastError();
}

// The pass of one configuration: split2m (NP = 2) is instantiated where it
// is called (cg_fused.cu, laplace_apply.cu), split3 and bf16 in
// mma_rungs.cu, built once per rung (-DBP4_RUNG=3, 1) in parallel with the
// other sources.
template <int P, int FORM, bool REBUILD, int NP>
cudaError_t launch_mma(const void* mf, const void* mb, const float* gmetric,
                       const Grid& gr, const float* mask, const float* u,
                       float* out, const MmaFusedArgs& x, cudaStream_t st) {
  return launch_mma_here<P, FORM, REBUILD, NP>(mf, mb, gmetric, gr, mask, u,
                                               out, x, st);
}

#define BP4_MMA_SIGNATURE(P, FORM, REBUILD, NP)                              \
  template <>                                                                \
  cudaError_t launch_mma<P, FORM, REBUILD, NP>(                              \
      const void* mf, const void* mb, const float* gmetric, const Grid& gr,  \
      const float* mask, const float* u, float* out, const MmaFusedArgs& x, \
      cudaStream_t st)
#define BP4_MMA_DECLARE1(P, FORM, REBUILD, NP) \
  BP4_MMA_SIGNATURE(P, FORM, REBUILD, NP);
#define BP4_MMA_DEFINE1(P, FORM, REBUILD, NP)                                 \
  BP4_MMA_SIGNATURE(P, FORM, REBUILD, NP) {                                   \
    return launch_mma_here<P, FORM, REBUILD, NP>(mf, mb, gmetric, gr, mask, u, \
                                                 out, x, st);                  \
  }
// the forms and metric sources of B3 (cell batch), B5/B6/B1 (lattice,
// streamed), B1 (rebuilt), B2 (update4b, streamed or rebuilt; also with P
// or x in bf16, and in the block form)
#define BP4_MMA_CONFIGS(P, NP, M)                                     \
  M(P, kCellBatch, false, NP) M(P, kLattice, false, NP)               \
  M(P, kLattice, true, NP) M(P, kLatticeUpdate, false, NP)            \
  M(P, kLatticeUpdate, true, NP) M(P, kLatticeUpdatePx, false, NP)    \
  M(P, kLatticeUpdatePx, true, NP)                                    \
  M(P, kLatticeUpdateBlock, false, NP)                                \
  M(P, kLatticeUpdateBlock, true, NP)
#define BP4_MMA_RUNG(NP, M)                                           \
  BP4_MMA_CONFIGS(1, NP, M) BP4_MMA_CONFIGS(2, NP, M)                 \
  BP4_MMA_CONFIGS(3, NP, M) BP4_MMA_CONFIGS(4, NP, M)

BP4_MMA_RUNG(1, BP4_MMA_DECLARE1)
BP4_MMA_RUNG(3, BP4_MMA_DECLARE1)

// The storage instantiations (mma_sb.cu, one object a rung): the bf16
// state (kSbState) in B3's cell-batch form at every rung, in the lattice
// and update4b forms at split2m and split3 (the bf16 rung's read it by
// io.bf16 already); under split2m also with the bf16 metric (kSbMetric),
// but in B2's block form (no distributed path streams a bf16 metric).
// B2's update4b is its P/x form (kLatticeUpdatePx: P and x at f32 or in
// bf16 by io.prec_bf16 and io.x_bf16, with both 0 bitwise the update
// form).
#define BP4_MMA_SB_STATE(P, NP, M)                                        \
  M(P, kCellBatch, false, NP) M(P, kLattice, false, NP)                   \
  M(P, kLattice, true, NP) M(P, kLatticeUpdatePx, false, NP)              \
  M(P, kLatticeUpdatePx, true, NP) M(P, kLatticeUpdateBlock, false, NP)   \
  M(P, kLatticeUpdateBlock, true, NP)
#define BP4_MMA_SB_METRIC(P, NP, M)                                   \
  M(P, kCellBatch, false, NP) M(P, kLattice, false, NP)               \
  M(P, kLatticeUpdatePx, false, NP)
// rung 1 | 4, 2 | 4, 2 | 12, 3 | 4 at degree P
#define BP4_MMA_SB_RUNG1(P, M) M(P, kCellBatch, false, 5)
#define BP4_MMA_SB_RUNG2(P, M) \
  BP4_MMA_SB_STATE(P, 6, M) BP4_MMA_SB_METRIC(P, 14, M)
#define BP4_MMA_SB_RUNG3(P, M) BP4_MMA_SB_STATE(P, 7, M)
#define BP4_MMA_SB_LO(R, M)                                          \
  BP4_CAT(BP4_MMA_SB_RUNG, R)(1, M) BP4_CAT(BP4_MMA_SB_RUNG, R)(2, M) \
  BP4_CAT(BP4_MMA_SB_RUNG, R)(3, M) BP4_CAT(BP4_MMA_SB_RUNG, R)(4, M)
static_assert(kSbState == 4 && kSbMetric == 8, "BP4_MMA_SB_RUNG*");
BP4_MMA_SB_LO(1, BP4_MMA_DECLARE1)
BP4_MMA_SB_LO(2, BP4_MMA_DECLARE1)
BP4_MMA_SB_LO(3, BP4_MMA_DECLARE1)

// The metric rebuilt by the jtj chain (NP | kJtjChain): B1 (lattice) and
// B2 (update4b, and with P or x in bf16) at every rung (at p <= 4 in
// mma_jtj.cu, from p=5 beside the rung's adjj forms in apply_mma_pNN.cu,
// whose gather and backward passes they share), and with the bf16 state
// (kSbState) at split2m and split3 as the adjj forms have it (mma_sb.cu,
// apply_mma_sb.cu), B2's in its P/x form; not B2's block form (the
// distributed solvers run adjj).
#define BP4_MMA_JTJ_CONFIGS(P, NP, M)                                 \
  M(P, kLattice, true, NP) M(P, kLatticeUpdate, true, NP)             \
  M(P, kLatticeUpdatePx, true, NP)
#define BP4_MMA_JTJ_SB(P, NP, M) \
  M(P, kLattice, true, NP) M(P, kLatticeUpdatePx, true, NP)
// rung 1 | 16, 2 | 16, 3 | 16 at degree P; the storage forms 2 | 4 | 16
// and 3 | 4 | 16
#define BP4_MMA_JTJ_RUNG(P, R, M) BP4_MMA_JTJ_CONFIGS(P, (R) | kJtjChain, M)
#define BP4_MMA_JTJ_SB_RUNG1(P, M)
#define BP4_MMA_JTJ_SB_RUNG2(P, M) BP4_MMA_JTJ_SB(P, 22, M)
#define BP4_MMA_JTJ_SB_RUNG3(P, M) BP4_MMA_JTJ_SB(P, 23, M)
#define BP4_MMA_JTJ_DECLARE(P, M)                                      \
  BP4_MMA_JTJ_CONFIGS(P, 17, M) BP4_MMA_JTJ_CONFIGS(P, 18, M)          \
  BP4_MMA_JTJ_CONFIGS(P, 19, M) BP4_MMA_JTJ_SB_RUNG2(P, M)             \
  BP4_MMA_JTJ_SB_RUNG3(P, M)
static_assert(kJtjChain == 16, "BP4_MMA_JTJ_*");
BP4_MMA_JTJ_DECLARE(1, BP4_MMA_DECLARE1)
BP4_MMA_JTJ_DECLARE(2, BP4_MMA_DECLARE1)
BP4_MMA_JTJ_DECLARE(3, BP4_MMA_DECLARE1)
BP4_MMA_JTJ_DECLARE(4, BP4_MMA_DECLARE1)

}  // namespace bp4
