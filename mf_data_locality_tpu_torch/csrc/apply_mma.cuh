// The f32 split2m cell pass of the apply family on Hopper's tensor cores
// (sm_90a, mma.sync m16n8k16, bf16 x bf16 products, f32 accumulation):
// v = sum_e M_e^T G_ef M_f u per cell, on cell batches (B3) and on the
// lattice (B5, B6; the assemble pass follows in laplace_apply.cu).
//
// Replaces, under precision "split2m", the TPU kernels of
// mf_data_locality_tpu/ops/laplace_pallas.py:
//   B3  _kernel_g          :479  (pallas_call :1023)
//   B6  _kernel_g_zslab    :576  (pallas_call :664)
//   B5  _kernel_g_pieces   :845  (pallas_call :947)
// The "highest" and f64 rungs stay on apply_kernel (laplace_apply.cu):
// bf16 products cannot give exact f32 or f64.
//
// split2m (laplace_pallas._mm :447-463) is by definition bf16 x bf16
// products with f32 accumulation: M rounded once to bf16, the streamed
// operand (u forward, t backward) split into hi = bf16(x) and lo =
// bf16(x - hi), K-stacked as [Mh | Mh] [xh; xl].  That is what the tensor
// cores compute.
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
// through L1 from L2.  Budget of shared memory: only u's hi and lo parts,
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

template <int P>
struct MmaShape {
  using S = Shape<P>;
  static constexpr int P13P = (S::P13 + 15) / 16 * 16;  // nodes, padded
  static constexpr int Q3P = (S::Q3 + 15) / 16 * 16;    // q-points a direction
  static constexpr int RP = 3 * Q3P;                    // gradient rows
  static constexpr int QC = Q3P / 16;                   // q-point chunks
  static constexpr int LDU = P13P + 8;  // u row stride: no bank conflicts
};

template <int P>
struct MmaSmem {
  // hi and lo parts of the input per (cell tile, component): (cell, node)
  __nv_bfloat16 u[kMmaGroups][kComps][2][kMmaCells][MmaShape<P>::LDU];
};

// mf, mb: the forward and backward fragment tables, fragment (n8 tile nt,
// k16 step ks) at (nt * K / 16 + ks) * 32 + lane.  LATTICE false (B3): u
// and out are cell batches (C P13, n_cells); true (B5/B6): u is the
// lattice, gathered times the mask, and out the masked cell-local values
// (C, n_cells, P13).
template <int P, bool LATTICE>
__global__ void __launch_bounds__(kMmaThreads, 2)
    apply_mma_kernel(const uint2* __restrict__ mf, const uint2* __restrict__ mb,
                     const float* __restrict__ gmetric, Grid gr,
                     const float* __restrict__ mask,
                     const float* __restrict__ u, float* __restrict__ out) {
  using S = Shape<P>;
  using Ms = MmaShape<P>;
  constexpr int P13 = S::P13, Q3 = S::Q3, P13P = Ms::P13P, Q3P = Ms::Q3P;
  constexpr int KF = P13P / 16, KB = Ms::RP / 16, NB = P13P / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<MmaSmem<P>*>(smem_raw);
  const int nc = gr.n_cells();
  const size_t n_nodes = gr.n_nodes();
  const int cell0 = blockIdx.x * kMmaBlockCells;
  const int tid = threadIdx.x;

  // input stream parts; padded nodes and cells past the end are zero
  for (int i = tid; i < kComps * P13P * kMmaBlockCells; i += blockDim.x) {
    const int b = i % kMmaBlockCells, k = (i / kMmaBlockCells) % P13P,
              c = i / (kMmaBlockCells * P13P);
    const int cell = cell0 + b;
    float val = 0.f;
    if (k < P13 && cell < nc) {
      if constexpr (LATTICE) {
        float m;
        const size_t node = cell_node<P>(gr, cell, k, mask, &m);
        val = u[c * n_nodes + node] * m;
      } else {
        val = u[static_cast<size_t>(c * P13 + k) * nc + cell];
      }
    }
    const __nv_bfloat16 hi = __float2bfloat16_rn(val);
    auto& parts = sm.u[b / kMmaCells][c];
    parts[0][b % kMmaCells][k] = hi;
    parts[1][b % kMmaCells][k] = __float2bfloat16_rn(val - __bfloat162float(hi));
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int c = warp % kComps;
  const int g = lane / 4, t4 = lane % 4;  // fragment row group, column pair
  const int tile0 = cell0 + (warp / kComps) * kMmaCells;
  const auto& us = sm.u[warp / kComps][c];

  float v[NB][4] = {};
  for (int j = 0; j < Ms::QC; ++j) {
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
          mma_bf16(ga[d][h], a[1], bf);
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
          const int qp = 16 * j + 8 * h + 2 * t4 + e2;
          const bool live = qp < Q3 && cell < nc;
          float G[6];
#pragma unroll
          for (int e = 0; e < 6; ++e)
            G[e] = live ? __ldg(gmetric + static_cast<size_t>(e * Q3 + qp) * nc + cell)
                        : 0.f;
          const float gx = ga[0][h][2 * r + e2], gy = ga[1][h][2 * r + e2],
                      gz = ga[2][h][2 * r + e2];
          tv[0][e2] = G[0] * gx + G[1] * gy + G[2] * gz;
          tv[1][e2] = G[1] * gx + G[3] * gy + G[4] * gz;
          tv[2][e2] = G[2] * gx + G[4] * gy + G[5] * gz;
        }
#pragma unroll
        for (int e = 0; e < 3; ++e)
          split_pair(tv[e][0], tv[e][1], th[e][2 * h + r], tl[e][2 * h + r]);
      }

    // backward: v^T += [th | tl] . [Mh; Mh] over gradient rows e Q3P + 16 j
#pragma unroll
    for (int e = 0; e < 3; ++e)
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        const uint2 bb = __ldg(mb + (nt * KB + e * Ms::QC + j) * 32 + lane);
        mma_bf16(v[nt], th[e], bb);
        mma_bf16(v[nt], tl[e], bb);
      }
  }

  // v[nt][2 r + e2] is cell tile0 + g + 8 r, node 8 nt + 2 t4 + e2
#pragma unroll
  for (int nt = 0; nt < NB; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cell = tile0 + g + 8 * (i / 2), k = nt * 8 + 2 * t4 + i % 2;
      if (cell >= nc || k >= P13) continue;
      if constexpr (LATTICE) {
        float m;
        cell_node<P>(gr, cell, k, mask, &m);
        out[(static_cast<size_t>(c) * nc + cell) * P13 + k] = v[nt][i] * m;
      } else {
        out[static_cast<size_t>(c * P13 + k) * nc + cell] = v[nt][i];
      }
    }
}

template <int P, bool LATTICE>
cudaError_t launch_mma(const void* mf, const void* mb, const float* gmetric,
                       const Grid& gr, const float* mask, const float* u,
                       float* out, cudaStream_t st) {
  auto kern = apply_mma_kernel<P, LATTICE>;
  // above 48 KB a block's shared memory must be requested explicitly
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(MmaSmem<P>));
  if (attr != cudaSuccess) return attr;
  const int blocks = (gr.n_cells() + kMmaBlockCells - 1) / kMmaBlockCells;
  kern<<<blocks, kMmaThreads, sizeof(MmaSmem<P>), st>>>(
      static_cast<const uint2*>(mf), static_cast<const uint2*>(mb), gmetric,
      gr, mask, u, out);
  return cudaGetLastError();
}

}  // namespace bp4
