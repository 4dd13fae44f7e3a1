// The f32 tensor-core cell pass of the matvec (B1) and the fused CG
// iteration (B2) at degrees 1..3 and 5..11 (and at 4 with the streamed
// metric) (sm_90a, mma.sync m16n8k16, bf16 x bf16 products, f32
// accumulation), at the rungs split2m, split3 and bf16; cg_fused.cu's
// assemble and finalize passes follow it unchanged.
//
// Replaces, under precision "split2m" (and "split3", "bf16"), the cell work
// of the TPU kernels of
// mf_data_locality_tpu/ops/cg_fused_kernel.py:
//   B1  piece_vmult -> _matvec_kernel          (pallas_call :1116)
//   B2  fused_cg_iteration -> _fused_cg_kernel (pallas_call :1476)
// in the twostage configurations: the metric rebuilt per (cell, q-point)
// from the 24 trilinear coefficients by the adjj or the jtj chain (the JAX
// auto-dispatch's twostage + onthefly + jtj from p=5), or streamed.  At
// p=1..3 only an explicit --factor twostage reaches it (the JAX resolvers
// pick dense there).  At the shapes beyond BP4's (shapes.cuh: one
// component, Q = P + 1; NP's shape flags) it runs at every degree, p=4
// included: a block is one component of 8 cells and C the grid's y, so
// one component keeps the layout; an odd Q (Q = P + 1 at even P) pads its
// last plane pair with the zero plane, as at P = 1, 3.
//
// It computes what cell_mma.cuh computes at p=4 (_operator_block's
// twostage branch, :583-651, under _prestack / _mm_pre's split2m): the z
// stages in f32, unrounded; the 2D matrices [Dx2d; Dy2d; S2d] rounded once
// to bf16; the streamed operand split into hi = bf16(x) and lo = bf16(x -
// hi), K-stacked as [Mh | Mh] [xh; xl]; the metric in exact f32 (the TPU's
// Jacobian is a split3 product, bp4_operator.cuh).  The rung is the
// template parameter NP (mma.cuh): split3 adds xh Ml beside each pair (Ml's
// tables follow Mh's, read the same way), bf16 keeps xh Mh only; their
// instantiations read the streamed metric in bf16 where it is stored so
// (tb.metric_bf16), the bf16 one B1/B2's d and h too (io.bf16).
// cell_mma.cuh's pass cannot reach p=5: it keeps v (P1 x (P+1)^2 per 16
// cells) in registers across the planes, 144 a thread at p=5 beside its
// ~242 at p=4, and its u/v tile and two fragment copies of the tables
// outgrow shared memory by p=8 and p=11.
//
// Layout: one warp is one block, and one (component, 8-cell) task; the 16
// rows of an m16 tile are (plane, cell) pairs, two q-planes (qz = 2 pt,
// 2 pt + 1) of the 8 cells, so both rows a thread holds (gq, gq + 8)
// belong to its cell gq.  Per plane pair pt:
//   z stage   uS, uD (16 rows, (ky,kx)) = sum_kz Sz|Dz[qz,kz] u[kz], f32 FMA
//             at the thread's own A-fragment entries, split hi/lo into the
//             fragments, which go to the thread's own slots in shared
//             memory (lane-private: read back by the same lane only)
//   forward   per chunk of 16 q-points: [gx | gy] = [uSh | uSl] [Mxy^T;
//             Mxy^T], gz = [uDh | uDl] [Mz^T; Mz^T], six n8 tiles, so a
//             thread holds gx, gy, gz of the same 8 (row, q-point) entries
//   metric    G at those entries, computed by the thread itself: rebuilt
//             (onthefly_metric, exact f32) or loaded (the 8 cells of a
//             q-point are one 32-byte sector of the cell-fastest stream)
//   apply     t = G [gx, gy, gz] on the accumulators, split hi/lo: the
//             backward's A fragments, to the thread's own slots
//   backward  per pair of n8 column tiles: w1 = [t0h|t0l] [Mx; Mx] +
//             [t1h|t1l] [My; My], w2 = [t2h|t2l] [Mz; Mz] over all q-points
//   z back    v[kz] += Sz[qz,kz] w1 + Dz[qz,kz] w2 in shared memory; the
//             thread owns its (cell, column) entries of v, so no two
//             threads touch one, and the planes add in order qz = 0, 1, ..
//   output    v written masked to the cell-local scratch (C, n_cells,
//             (P+1)^3) that cg_fused.cu's assemble pass reads.
// No atomics; every sum has a fixed order, so results repeat bit for bit.
// Padding: the (ky, kx) columns past (P+1)^2 of u are zero, q-points past
// q^2 have zero table rows and G = 0, the plane past Q (odd Q) has zero z
// factors, cells past n_cells have zero input and G = 0 and store nothing.
// At p=1..3 the tiles are mostly padding ((p+1)^2 = 4, 9, 16 columns in
// one k16 step, q^2 = 9, 16, 25 q-points in one or two chunks): the same
// code, one k16 step of the forward and n8 tile pair of the backward.
//
// Tables: laplace_cuda.mma_tables(..., "twostage") (the same packing as at
// p=4), read through L1 from global memory: the two copies are 37-304 KB
// at p=5..11, past what shared memory holds beside the tile (split3: twice
// that, Ml's after Mh's).
//
// Bound: the 2D stage's products (3 components x Q planes x 2 q^2 (p+1)^2
// x 2 stream parts a cell, as at p=4) run at the tensor cores' bf16 rate,
// the z stages, the metric apply and the rebuild on the CUDA cores; at p=6
// s=12 and p=8 s=11 the f32 work sets B1's bound and the bytes B2's
// (chip_smoke.bound).  The design is a first, right one: one warp a block,
// its shared memory (u and v in f32, the lane-private fragments) 38 KB at
// p=5, 89 KB at p=8 and 162 KB at p=11, so 5 to 1 warps an SM; the metric
// is rebuilt once per component (three times a q-point), and the tables
// come from L1/L2.  PERF.md gives its times.

#pragma once

#include "bp4_operator.cuh"
#include "mma.cuh"

namespace bp4 {

constexpr int kHdCells = 8;    // cells of a warp's task
constexpr int kHdThreads = 32;  // one warp a block

template <int P, int SH = 0>
struct CellMmaHdShape {
  using S = Shape<P, SH>;
  static constexpr int Q2P = (S::Q2 + 15) / 16 * 16;    // q-points a plane
  static constexpr int P12P = (S::P12 + 15) / 16 * 16;  // (ky, kx) columns
  static constexpr int QC = Q2P / 16;   // q-point chunks: backward k16 steps
  static constexpr int KF = P12P / 16;  // k16 steps of the forward
  static constexpr int KB = 3 * QC;     // backward k16 steps, three directions
  static constexpr int NB = P12P / 8;   // n8 tiles of the backward
  static constexpr int NPAIR = (S::Q + 1) / 2;  // plane pairs (row tiles)
  static constexpr int LDU = S::P1 * P12P + 8;  // u/v words a cell
  static constexpr int TF = 3 * Q2P / 8 * KF * 32;  // uint2, forward table
  static_assert(LDU % 16 == 8 && NB % 2 == 0,
                "strides and tiles of the tensor-core cell pass");
};

template <int P, int SH = 0>
struct CellMmaHdSmem {
  using S = Shape<P, SH>;
  using Hs = CellMmaHdShape<P, SH>;
  // lane-private fragments: the z stage's (uS hi, uS lo, uD hi, uD lo) per
  // k16 step, and the metric apply's (hi, lo) per direction and chunk
  uint4 a[Hs::KF][4][kHdThreads];
  uint4 t[3][Hs::QC][2][kHdThreads];
  float u[kHdCells][Hs::LDU];  // input (kz, (ky,kx)), padded columns zero
  float v[kHdCells][Hs::LDU];  // output, summed over the planes
  float c24[kHdCells][25];     // coefficients (rebuilt metric)
  float sz[(S::Q + 1) * S::P1];  // z factors, and a zero plane past Q
  float dz[(S::Q + 1) * S::P1];
};

// G at q-point (qz, q2) of `cell`, zero past the plane's q^2 q-points, past
// Q planes and past the last cell (its coefficients are zero).  FLEX: the
// streamed metric is f32 (0), f32 or bf16 by tb.metric_bf16 (1), bf16 (2).
template <int P, bool REBUILD, int COFACTOR, int FLEX, int SH = 0>
__device__ __forceinline__ void hd_metric(const OpTables<float>& tb,
                                          const float* c24, int nc, int cell,
                                          int qz, int q2, float (&g)[6]) {
  using S = Shape<P, SH>;
  if (qz >= S::Q || q2 >= S::Q2) {
#pragma unroll
    for (int e = 0; e < 6; ++e) g[e] = 0.f;
    return;
  }
  const int qp = qz * S::Q2 + q2;
  if constexpr (REBUILD) {
    float pq[24];
    load_pds_row(tb.pds + qp * 24, pq);
    onthefly_metric<1, COFACTOR>(pq, c24, __ldg(tb.w3 + qp), g);
  } else {
    const bool live = cell < nc;
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const size_t i = static_cast<size_t>(e * S::Q3 + qp) * nc + cell;
      if constexpr (FLEX == 2)
        g[e] = live ? metric_ldg<kSbMetric>(tb.gmetric, i) : 0.f;
      else if constexpr (FLEX == 1)
        g[e] = live ? ldg_flex(tb.gmetric, i, tb.metric_bf16) : 0.f;
      else
        g[e] = live ? __ldg(tb.gmetric + i) : 0.f;
    }
  }
}

// tb.mats: the two fragment tables, forward then backward; tb.coeffs:
// (n_cells, 24) (rebuilt); tb.gmetric: (6 Q3, n_cells) (streamed).
// blockIdx.x: the 8-cell group, blockIdx.y: the component.  NP: the rung's
// products a tile (mma.cuh); split3's Ml tables follow Mh's.
template <int P, bool FUSED, bool REBUILD, int COFACTOR, int NP,
          bool PX = false>
__global__ void __launch_bounds__(kHdThreads)
    cells_mma_hd_kernel(OpTables<float> tb, Grid gr, CellIo<float> io,
                        float* __restrict__ cells) {
  constexpr int SH = NP & kShMask;
  using S = Shape<P, SH>;
  using Hs = CellMmaHdShape<P, SH>;
  constexpr int P1 = S::P1, P12 = S::P12, P13 = S::P13, Q = S::Q;
  constexpr int P12P = Hs::P12P, KF = Hs::KF, QC = Hs::QC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<CellMmaHdSmem<P, SH>*>(smem_raw);
  const int lane = threadIdx.x;
  const int c = blockIdx.y;
  const int nc = gr.n_cells();
  const int cell0 = blockIdx.x * kHdCells;
  // the bf16 state (the bf16 rung's, and the storage instantiations')
  constexpr bool FLEX_STATE = rung_of(NP) == 1 || (NP & kSbState) != 0;
  // the metric: 2 bf16 (kSbMetric), 1 f32 or bf16 by tb.metric_bf16, 0 f32
  constexpr int FLEX_METRIC =
      (NP & kSbMetric) ? 2 : rung_of(NP) != 2 ? 1 : 0;
  const uint2* mf = reinterpret_cast<const uint2*>(tb.mats);
  const uint2* mb = mf + Hs::TF;
  const uint2* mfl = mf + 2 * Hs::TF;  // split3's Ml (TF = TB)
  const uint2* mbl = mb + 2 * Hs::TF;

  // z factors (a zero plane past Q), coefficients (zero past the end),
  // v = 0, the padded columns of u zero
  for (int i = lane; i < (Q + 1) * P1; i += kHdThreads) {
    sm.sz[i] = i < Q * P1 ? __ldg(tb.sz + i) : 0.f;
    sm.dz[i] = i < Q * P1 ? __ldg(tb.dz + i) : 0.f;
  }
  if constexpr (REBUILD) {
    for (int i = lane; i < kHdCells * 24; i += kHdThreads) {
      const int b = i / 24, cell = cell0 + b;
      sm.c24[b][i % 24] = cell < nc ? __ldg(tb.coeffs + cell * 24 + i % 24)
                                    : 0.f;
    }
  }
  for (int i = lane; i < kHdCells * Hs::LDU; i += kHdThreads)
    (&sm.v[0][0])[i] = 0.f;
  if constexpr (P12P > P12) {
    constexpr int NPAD = P12P - P12;
    for (int i = lane; i < kHdCells * P1 * NPAD; i += kHdThreads) {
      const int row = i / NPAD;  // (b, kz)
      sm.u[row / P1][(row % P1) * P12P + P12 + i % NPAD] = 0.f;
    }
  }
  // the input at the cells' nodes, kx fastest, then the cell (the node
  // rows of neighbouring cells are neighbours in memory), then (kz, ky);
  // B2's update4b runs here, the owner cell writing x', g', d'
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (FUSED) {
#pragma unroll
    for (int k = 0; k < 4; ++k) sc[k] = io.scal[k];
  }
  for (int i = lane; i < kHdCells * P13; i += kHdThreads) {
    const int kx = i % P1, b = (i / P1) % kHdCells;
    const int row = i / (P1 * kHdCells), kz = row / P1, ky = row % P1;
    const int cell = cell0 + b;
    float val = 0.f;
    if (cell < nc) {
      const int cx = cell % gr.ncx, cy = (cell / gr.ncx) % gr.ncy,
                cz = cell / (gr.ncx * gr.ncy);
      val = cell_input<float, P, FUSED, FLEX_STATE, PX>(io, sc, gr, c, cz, cy,
                                                        cx, kz, ky, kx);
    }
    sm.u[b][kz * P12P + ky * P1 + kx] = val;
  }
  __syncwarp();

  const int gq = lane / 4, t4 = lane % 4;  // fragment row group, column pair
  const int b = gq;                        // this thread's cell
  const float* ub = sm.u[b];
  float* vb = sm.v[b];
  const int cell = cell0 + b;

  for (int pt = 0; pt < Hs::NPAIR; ++pt) {
    const int qz0 = 2 * pt;
    const float* s0 = sm.sz + qz0 * P1;  // plane qz0 + 1 follows
    const float* d0 = sm.dz + qz0 * P1;

    // z stage: register r4 of k16 step ks holds row gq + 8 (r4 & 1) (plane
    // qz0 + (r4 & 1)), columns 16 ks + 8 (r4 >> 1) + 2 t4 + {0, 1}
    for (int ks = 0; ks < KF; ++ks) {
      uint32_t r[4][4];  // [uS hi, uS lo, uD hi, uD lo][r4]
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        const float* up = ub + 16 * ks + 8 * hc + 2 * t4;
        float2 s[2], d[2];
#pragma unroll
        for (int kz = 0; kz < P1; ++kz) {
          const float2 x = *reinterpret_cast<const float2*>(up + kz * P12P);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float a = s0[h * P1 + kz], bz = d0[h * P1 + kz];
            if (kz == 0) {
              s[h] = make_float2(x.x * a, x.y * a);
              d[h] = make_float2(x.x * bz, x.y * bz);
            } else {
              s[h] = make_float2(fmaf(x.x, a, s[h].x), fmaf(x.y, a, s[h].y));
              d[h] = make_float2(fmaf(x.x, bz, d[h].x), fmaf(x.y, bz, d[h].y));
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          stream_parts<rung_of(NP)>(s[h].x, s[h].y, r[0][2 * hc + h],
                           r[1][2 * hc + h]);
          stream_parts<rung_of(NP)>(d[h].x, d[h].y, r[2][2 * hc + h],
                           r[3][2 * hc + h]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sm.a[ks][k][lane] = make_uint4(r[k][0], r[k][1], r[k][2], r[k][3]);
    }

    // forward, metric and its apply, per chunk j of 16 q-points
    for (int j = 0; j < QC; ++j) {
      float ga[3][2][4] = {};
      for (int ks = 0; ks < KF; ++ks) {
        uint32_t af[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint4 x = sm.a[ks][k][lane];
          af[k][0] = x.x;
          af[k][1] = x.y;
          af[k][2] = x.z;
          af[k][3] = x.w;
        }
#pragma unroll
        for (int e = 0; e < 3; ++e)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int nt = e * (Hs::Q2P / 8) + 2 * j + hh;
            const uint2 bf = __ldg(mf + (nt * KF + ks) * 32 + lane);
            mma_bf16(ga[e][hh], af[e < 2 ? 0 : 2], bf);
            if constexpr (rung_of(NP) != 1) mma_bf16(ga[e][hh], af[e < 2 ? 1 : 3], bf);
            if constexpr (rung_of(NP) == 3)
              mma_bf16(ga[e][hh], af[e < 2 ? 0 : 2],
                       __ldg(mfl + (nt * KF + ks) * 32 + lane));
          }
      }
      // accumulator 2 r + e2 of n8 half hh: row gq + 8 r (plane qz0 + r),
      // q-point 16 j + 8 hh + 2 t4 + e2; as the backward's A fragment it is
      // register 2 hh + r of k16 step j
      uint32_t th[3][4], tl[3][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float tv[3][2];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            float G[6];
            hd_metric<P, REBUILD, COFACTOR, FLEX_METRIC, SH>(
                tb, sm.c24[b], nc, cell, qz0 + r, 16 * j + 8 * hh + 2 * t4 + e2,
                G);
            const float gx = ga[0][hh][2 * r + e2], gy = ga[1][hh][2 * r + e2],
                        gz = ga[2][hh][2 * r + e2];
            tv[0][e2] = G[0] * gx + G[1] * gy + G[2] * gz;
            tv[1][e2] = G[1] * gx + G[3] * gy + G[4] * gz;
            tv[2][e2] = G[2] * gx + G[4] * gy + G[5] * gz;
          }
#pragma unroll
          for (int e = 0; e < 3; ++e)
            stream_parts<rung_of(NP)>(tv[e][0], tv[e][1], th[e][2 * hh + r],
                             tl[e][2 * hh + r]);
        }
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        sm.t[e][j][0][lane] = make_uint4(th[e][0], th[e][1], th[e][2], th[e][3]);
        sm.t[e][j][1][lane] = make_uint4(tl[e][0], tl[e][1], tl[e][2], tl[e][3]);
      }
    }

    // backward and z back, per pair of n8 column tiles: w[g][2 r + e2] is
    // row gq + 8 r (plane qz0 + r), column 8 (n0 + g) + 2 t4 + e2
    for (int n0 = 0; n0 < Hs::NB; n0 += 2) {
      float w1[2][4] = {}, w2[2][4] = {};
      for (int kb = 0; kb < QC; ++kb) {
        uint32_t tf[3][2][4];
#pragma unroll
        for (int e = 0; e < 3; ++e)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const uint4 x = sm.t[e][kb][k][lane];
            tf[e][k][0] = x.x;
            tf[e][k][1] = x.y;
            tf[e][k][2] = x.z;
            tf[e][k][3] = x.w;
          }
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const uint2* bn = mb + ((n0 + g) * Hs::KB + kb) * 32 + lane;
          const uint2 bx = __ldg(bn), by = __ldg(bn + QC * 32),
                      bz = __ldg(bn + 2 * QC * 32);
          mma_bf16(w1[g], tf[0][0], bx);
          if constexpr (rung_of(NP) != 1) mma_bf16(w1[g], tf[0][1], bx);
          mma_bf16(w1[g], tf[1][0], by);
          if constexpr (rung_of(NP) != 1) mma_bf16(w1[g], tf[1][1], by);
          mma_bf16(w2[g], tf[2][0], bz);
          if constexpr (rung_of(NP) != 1) mma_bf16(w2[g], tf[2][1], bz);
          if constexpr (rung_of(NP) == 3) {
            const uint2* bl = mbl + ((n0 + g) * Hs::KB + kb) * 32 + lane;
            mma_bf16(w1[g], tf[0][0], __ldg(bl));
            mma_bf16(w1[g], tf[1][0], __ldg(bl + QC * 32));
            mma_bf16(w2[g], tf[2][0], __ldg(bl + 2 * QC * 32));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (qz0 + r >= Q) break;  // the padded plane of odd Q
#pragma unroll
        for (int kz = 0; kz < P1; ++kz) {
          const float a = s0[r * P1 + kz], bz = d0[r * P1 + kz];
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            float2* vp = reinterpret_cast<float2*>(vb + kz * P12P +
                                                    8 * (n0 + g) + 2 * t4);
            float2 x = *vp;
            x.x = fmaf(w2[g][2 * r], bz, fmaf(w1[g][2 * r], a, x.x));
            x.y = fmaf(w2[g][2 * r + 1], bz, fmaf(w1[g][2 * r + 1], a, x.y));
            *vp = x;
          }
        }
      }
    }
  }

  // v out, masked, the cells one after another
  __syncwarp();
  const int n_live = min(kHdCells, nc - cell0);
  for (int bb = 0; bb < n_live; ++bb) {
    const int cl = cell0 + bb;
    const int cx = cl % gr.ncx, cy = (cl / gr.ncx) % gr.ncy,
              cz = cl / (gr.ncx * gr.ncy);
    float* dst = cells + (static_cast<size_t>(c) * nc + cl) * P13;
    for (int l = lane; l < P13; l += kHdThreads) {
      const int kz = l / P12, k2 = l % P12;
      dst[l] = interior(gr, cz * P + kz, cy * P + k2 / P1, cx * P + k2 % P1)
                   ? sm.v[bb][kz * P12P + k2]
                   : 0.f;
    }
  }
}

template <int P, bool FUSED, bool REBUILD, int COFACTOR, int NP,
          bool PX = false>
cudaError_t launch_cells_mma_hd_here(const OpTables<float>& tb, const Grid& gr,
                                     const CellIo<float>& io, float* cells,
                                     cudaStream_t st) {
  auto kern = cells_mma_hd_kernel<P, FUSED, REBUILD, COFACTOR, NP, PX>;
  using Sm = CellMmaHdSmem<P, NP & kShMask>;
  // above 48 KB a block's shared memory must be requested explicitly
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Sm));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((gr.n_cells() + kHdCells - 1) / kHdCells,
                  Shape<P, NP>::C);
  kern<<<grid, kHdThreads, sizeof(Sm), st>>>(tb, gr, io, cells);
  return cudaGetLastError();
}

// The pass of one configuration: degree 4 (the streamed metric) is
// instantiated where it is called (cg_fused.cu) under split2m and in
// mma_rungs.cu under split3 and bf16, degrees 1..3 and 5..11 in one source
// a degree and rung (cell_mma_p01.cu .. cell_mma_p03.cu, cell_mma_p05.cu
// .. cell_mma_p11.cu, each built once per rung, -DBP4_RUNG=n:
// BP4_CELL_MMA_HD_DEGREE), compiled in parallel with the others.
template <int P, bool FUSED, bool REBUILD, int COFACTOR, int NP,
          bool PX = false>
cudaError_t launch_cells_mma_hd(const OpTables<float>& tb, const Grid& gr,
                                const CellIo<float>& io, float* cells,
                                cudaStream_t st) {
  return launch_cells_mma_hd_here<P, FUSED, REBUILD, COFACTOR, NP, PX>(
      tb, gr, io, cells, st);
}

#define BP4_CELL_MMA_HD_SIGNATURE(P, FUSED, REBUILD, COFACTOR, NP, PX)    \
  template <>                                                             \
  cudaError_t launch_cells_mma_hd<P, FUSED, REBUILD, COFACTOR, NP, PX>(   \
      const OpTables<float>& tb, const Grid& gr, const CellIo<float>& io, \
      float* cells, cudaStream_t st)
#define BP4_CELL_MMA_HD_DECLARE1(P, FUSED, REBUILD, COFACTOR, NP, PX) \
  BP4_CELL_MMA_HD_SIGNATURE(P, FUSED, REBUILD, COFACTOR, NP, PX);
#define BP4_CELL_MMA_HD_DEFINE1(P, FUSED, REBUILD, COFACTOR, NP, PX)      \
  BP4_CELL_MMA_HD_SIGNATURE(P, FUSED, REBUILD, COFACTOR, NP, PX) {        \
    return launch_cells_mma_hd_here<P, FUSED, REBUILD, COFACTOR, NP, PX>( \
        tb, gr, io, cells, st);                                           \
  }
// B1, B2 x the metric streamed, rebuilt by adjj, rebuilt by jtj; B2 also
// with P or x in bf16
#define BP4_CELL_MMA_HD_CONFIGS(P, NP, M)                                   \
  M(P, false, false, kAdjj, NP, false) M(P, false, true, kAdjj, NP, false)  \
  M(P, false, true, kJtj, NP, false) M(P, true, false, kAdjj, NP, false)    \
  M(P, true, true, kAdjj, NP, false) M(P, true, true, kJtj, NP, false)      \
  M(P, true, false, kAdjj, NP, true) M(P, true, true, kAdjj, NP, true)      \
  M(P, true, true, kJtj, NP, true)
#define BP4_CELL_MMA_HD_DECLARE(P)                            \
  BP4_CELL_MMA_HD_CONFIGS(P, 1, BP4_CELL_MMA_HD_DECLARE1)     \
  BP4_CELL_MMA_HD_CONFIGS(P, 2, BP4_CELL_MMA_HD_DECLARE1)     \
  BP4_CELL_MMA_HD_CONFIGS(P, 3, BP4_CELL_MMA_HD_DECLARE1)
// the definitions of degree P's configurations at one rung, in its source
#define BP4_CELL_MMA_HD_DEGREE(P, NP) \
  BP4_CELL_MMA_HD_CONFIGS(P, NP, BP4_CELL_MMA_HD_DEFINE1)
// degree 4, the streamed metric, under split3 and bf16 (mma_rungs.cu)
#define BP4_CELL_MMA_HD_P4(NP, M)                                   \
  M(4, false, false, kAdjj, NP, false) M(4, true, false, kAdjj, NP, false) \
  M(4, true, false, kAdjj, NP, true)

BP4_CELL_MMA_HD_DECLARE(1)
BP4_CELL_MMA_HD_DECLARE(2)
BP4_CELL_MMA_HD_DECLARE(3)
BP4_CELL_MMA_HD_DECLARE(5)
BP4_CELL_MMA_HD_DECLARE(6)
BP4_CELL_MMA_HD_DECLARE(7)
BP4_CELL_MMA_HD_DECLARE(8)
BP4_CELL_MMA_HD_DECLARE(9)
BP4_CELL_MMA_HD_DECLARE(10)
BP4_CELL_MMA_HD_DECLARE(11)
BP4_CELL_MMA_HD_P4(1, BP4_CELL_MMA_HD_DECLARE1)
BP4_CELL_MMA_HD_P4(3, BP4_CELL_MMA_HD_DECLARE1)

// the storage instantiations: the bf16 state (kSbState) at split2m and
// split3 (the bf16 rung's read it by io.bf16 already), the bf16 metric
// (kSbMetric) with it at split2m; p=4 in mma_sb.cu, 1..3 and 5..11 in
// cell_mma_sb.cu, one object a degree and rung
#define BP4_CELL_MMA_HD_SB_STATE(P, NP, M)                                 \
  M(P, false, false, kAdjj, NP, false) M(P, false, true, kAdjj, NP, false) \
  M(P, false, true, kJtj, NP, false) M(P, true, false, kAdjj, NP, false)   \
  M(P, true, true, kAdjj, NP, false) M(P, true, true, kJtj, NP, false)
#define BP4_CELL_MMA_HD_SB_RUNG1(P, M)
#define BP4_CELL_MMA_HD_SB_RUNG2(P, M)                                   \
  BP4_CELL_MMA_HD_SB_STATE(P, 6, M)                                      \
  M(P, false, false, kAdjj, 14, false) M(P, true, false, kAdjj, 14, false)
#define BP4_CELL_MMA_HD_SB_RUNG3(P, M) BP4_CELL_MMA_HD_SB_STATE(P, 7, M)
#define BP4_CELL_MMA_HD_SB_P4(NP, M)                                     \
  M(4, false, false, kAdjj, NP, false) M(4, true, false, kAdjj, NP, false)
#define BP4_CELL_MMA_HD_SB_P4_RUNG1(M)
#define BP4_CELL_MMA_HD_SB_P4_RUNG2(M) \
  BP4_CELL_MMA_HD_SB_P4(6, M) BP4_CELL_MMA_HD_SB_P4(14, M)
#define BP4_CELL_MMA_HD_SB_P4_RUNG3(M) BP4_CELL_MMA_HD_SB_P4(7, M)
#define BP4_CELL_MMA_HD_SB_DECLARE(P)                 \
  BP4_CELL_MMA_HD_SB_RUNG2(P, BP4_CELL_MMA_HD_DECLARE1) \
  BP4_CELL_MMA_HD_SB_RUNG3(P, BP4_CELL_MMA_HD_DECLARE1)
BP4_CELL_MMA_HD_SB_P4_RUNG2(BP4_CELL_MMA_HD_DECLARE1)
BP4_CELL_MMA_HD_SB_P4_RUNG3(BP4_CELL_MMA_HD_DECLARE1)
BP4_CELL_MMA_HD_SB_DECLARE(1)
BP4_CELL_MMA_HD_SB_DECLARE(2)
BP4_CELL_MMA_HD_SB_DECLARE(3)
BP4_CELL_MMA_HD_SB_DECLARE(5)
BP4_CELL_MMA_HD_SB_DECLARE(6)
BP4_CELL_MMA_HD_SB_DECLARE(7)
BP4_CELL_MMA_HD_SB_DECLARE(8)
BP4_CELL_MMA_HD_SB_DECLARE(9)
BP4_CELL_MMA_HD_SB_DECLARE(10)
BP4_CELL_MMA_HD_SB_DECLARE(11)

}  // namespace bp4
