// The f32 tensor-core cell pass of the dense factorization at degrees
// 5..11 (sm_90a, mma.sync m16n8k16, bf16 x bf16 products, f32
// accumulation): v = sum_e M_e^T G_ef M_f u per cell, on cell batches (B3)
// and on the lattice (B5, B6, B1, B2; the assemble pass follows in
// laplace_apply.cu and cg_fused.cu), at the rungs split2m, split3 and
// bf16.
//
// Replaces, under precision "split2m" (and "split3", "bf16") at p >= 5, the
// TPU kernels
//   B3  laplace_pallas.py   _kernel_g          :479  (pallas_call :1023)
//   B6  laplace_pallas.py   _kernel_g_zslab    :576  (pallas_call :664)
//   B5  laplace_pallas.py   _kernel_g_pieces   :845  (pallas_call :947)
//   B1  cg_fused_kernel.py  _matvec_kernel           (pallas_call :1116)
//   B2  cg_fused_kernel.py  _fused_cg_kernel         (pallas_call :1476)
// of mf_data_locality_tpu/ops/, B1 and B2 in the dense factorization.
//
// It computes apply_mma.cuh's product set (its notes, :19-30): M rounded
// once to bf16 (the host's fragment tables, laplace_cuda.mma_tables), the
// streamed operand split into hi = bf16(x) and lo = bf16(x - hi), xh Mh +
// xl Mh under split2m, + xh Ml under split3 (Ml's tables after Mh's), xh Mh
// only under bf16, all accumulated in f32; t = G [gx, gy, gz] in f32 and
// split there, once.  The same forms (FORM, bp4_operator.cuh) and metric
// sources (REBUILD: adjj, or jtj with kJtjChain, from the coefficients)
// as apply_mma.cuh.
//
// At the shapes beyond BP4's (shapes.cuh: one component, Q = P + 1; NP's
// shape flags) it is the split2m dense pass at every degree, p <= 4 too:
// C only counts its rows, forward warps and backward tasks, so one
// component keeps every tile, while apply_mma.cuh's warps are the three
// components of a tile.
//
// apply_mma.cuh cannot be instantiated past p=4: one warp keeps the whole
// v^T of 16 cells in registers (P13P / 2 a thread: 112 at p=5, 864 at
// p=11) and a block holds u's hi and lo parts in shared memory (89 KB at
// p=5, 667 KB at p=11), and each 32-cell block would read the whole table
// (0.47 MB at p=5, 22.9 MB at p=11) from L2.  Here the work is what it is,
// two GEMMs with the metric apply between them, tiled in cells and in the
// output dimension:
//
//   gather    one thread per (component, node, cell): the input at the
//             cell's node (B3 the cell batch; B5, B6, B1 the lattice times
//             the mask; B2 update4b's d', whose owner cell writes x', g',
//             d', as apply_mma.cuh's staging loop does), split hi/lo and
//             stored in the order of the forward's A fragments;
//   forward   g^T (rows = (component, cell), 3 Q3P) = [uh | ul] [Mh^T;
//             Mh^T], K = P13P: a block is the three components of 32 cells
//             (a warp each: two m16 tiles) at one chunk of 16 q-points in
//             the three directions (six n8 tiles), so a thread holds gx,
//             gy and gz of the same (cell, q-point); the block stages G of
//             its 32 cells x 16 q-points once in shared memory (loaded, or
//             rebuilt from the coefficients) for its three warps; t = G g
//             on the accumulators, split hi/lo, stored in the order of the
//             backward's A fragments (the accumulator layout of two n8
//             tiles is one k16 A fragment);
//   backward  v^T (rows, P13P) = [th | tl] [Mh; Mh], K = 3 Q3P: a warp is
//             32 rows x 64 nodes (two m16 x eight n8 tiles), four warps a
//             block; v written masked to the cell-local scratch (C,
//             n_cells, P13) that the assemble pass reads, or to the cell
//             batch (B3).
// Every operand is read by 16-byte (A) and 8-byte (B) fragment loads, each
// warp's 512 or 256 coalesced bytes, through L1 from L2: no shared-memory
// staging of the tables, so blocks are small and many.  Every output
// element is summed by one thread in k order: no atomics, no split K,
// results repeat bit for bit.  The tensor cores' f32 accumulation is not
// rounded to nearest, and one chain over a long K (up to 6624 at p=11,
// 1242 mma steps under split3) drifts with its length: one chain over all
// of K measured 1.2e-5 of the result against the plain version at p=7
// under split3 (PERF.md).  So each chain runs kHdChunk k16 steps from zero
// and is added to the thread's f32 sum (rounded to nearest), in k order.
//
// Scratch (the caller's, dense_scratch_len): u's parts (NPART x 3 NCP x
// P13P bf16) and t's (NPART x 3 NCP x 3 Q3P), NCP = n_cells rounded up to
// 32, NPART = 1 (bf16) or 2: 74 MB at p=8 s=11 under split2m.  Padding:
// nodes past P13 and cells past n_cells are zero in u, q-points past Q3 and
// cells past n_cells get G = 0 (the JAX _pad_row_blocks guard), so their t
// is zero, and nothing is stored past P13 or n_cells.
//
// Bound: 2 NP x 3 x 3 Q3 P13 products a cell, e.g. at p=6 s=12 under
// split2m 2.7e10 FMAs, 54 us at the 989 TFLOP/s bf16 peak; t's scratch is
// written once and read once (75 MB each way, ~45 us at 3.35 TB/s) where
// the operation count bounds the function.  The tables: the forward reads
// Mh^T at one q-chunk per block (6 KF fragments, 1.5 KB each k16 step),
// the blocks of a chunk run together (blockIdx.x walks the cells) and
// share it in L2; the backward's warps read the whole Mh, up to 22.9 MB at
// p=11 (45.8 MB with split3's Ml), within the 50 MB L2.

#pragma once

#include "apply_mma.cuh"
#include "bp4_operator.cuh"
#include "mma.cuh"

namespace bp4 {

constexpr int kHdRowCells = 32;   // cells of a row tile: two m16 tiles
constexpr int kHdChunk = 8;       // k16 steps of one accumulation chain
constexpr int kHdBwdTiles = 8;    // n8 node tiles of a backward warp
constexpr int kHdBwdWarps = 4;
constexpr int kHdGatherThreads = 256;

// The scratch's layout at degree P and NP products a tile, for nc cells:
// row tiles (m16) of rows c NCP + cell, then the parts' A fragments.
template <int P, int NP>
struct DenseHdLayout {
  using Ms = MmaShape<P, NP & kShMask>;
  static constexpr int NPART = rung_of(NP) == 1 ? 1 : 2;
  static constexpr int KF = Ms::P13P / 16;  // forward k16 steps
  static constexpr int KB = Ms::RP / 16;    // backward k16 steps
  int ncp, mt;                              // padded cells, m16 row tiles
  __host__ __device__ explicit DenseHdLayout(int nc)
      : ncp((nc + kHdRowCells - 1) / kHdRowCells * kHdRowCells),
        mt(Shape<P, NP>::C * ncp / 16) {}
  // uint4 units: u's fragments, then t's
  __host__ __device__ size_t u_part() const {
    return static_cast<size_t>(mt) * KF * 32;
  }
  __host__ __device__ size_t t_part() const {
    return static_cast<size_t>(mt) * KB * 32;
  }
  __host__ __device__ size_t len() const {
    return NPART * (u_part() + t_part());
  }
};

// The position (bf16 units) of element (row r of m16 tile mt, column kk of
// k16 step ks) in the A fragments of a K-step table with ksteps steps:
// fragment (mt, ks), lane 4 (r % 8) + (kk % 8) / 2, register (r / 8) +
// 2 (kk / 8), half kk % 2.
__device__ __forceinline__ size_t a_frag_pos(int mt, int ks, int ksteps,
                                             int r, int kk) {
  const int lane = (r % 8) * 4 + (kk % 8) / 2;
  const int reg = r / 8 + 2 * (kk / 8);
  return ((static_cast<size_t>(mt) * ksteps + ks) * 32 + lane) * 8 + reg * 2 +
         kk % 2;
}

// The row tiles of B2's block form: the cells [x, y), x and y multiples of
// kHdRowCells, that hold the cells [gr.cbeg, gr.cend) (the layer-range
// form; a tile it shares with the range next to it is gathered, computed
// and read by each of the two launches, each writing only its own cells).
__host__ __device__ __forceinline__ int2 hd_rows(const Grid& gr) {
  return make_int2(gr.cbeg / kHdRowCells * kHdRowCells,
                   (gr.cend + kHdRowCells - 1) / kHdRowCells * kHdRowCells);
}

__device__ __forceinline__ void ld_frag(const uint4* p, uint32_t (&a)[4]) {
  const uint4 v = __ldg(p);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// The input's stream parts at every (component, node, cell), zero at
// padded nodes and cells, as the forward's A fragments (FORM: apply_mma.cuh's).
template <int P, int FORM, int NP>
__global__ void __launch_bounds__(kHdGatherThreads)
    dense_hd_gather_kernel(Grid gr, const float* __restrict__ mask,
                           const float* __restrict__ u, MmaFusedArgs x,
                           __nv_bfloat16* __restrict__ us) {
  using S = Shape<P, NP>;
  using L = DenseHdLayout<P, NP>;
  constexpr int P13 = S::P13, P13P = L::Ms::P13P;
  constexpr int kNP = rung_of(NP);
  constexpr bool kBfState = (NP & kSbState) != 0;
  const int nc = gr.n_cells();
  const L lay(nc);
  const size_t n_nodes = gr.n_nodes();
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the block form: the row tiles that hold the cells [gr.cbeg, gr.cend),
  // zero at their other cells (hd_rows)
  const int2 rows = is_block(FORM) ? hd_rows(gr) : make_int2(0, 0);
  const int ncr = is_block(FORM) ? rows.y - rows.x : lay.ncp;
  if (i >= static_cast<size_t>(S::C) * P13P * ncr) return;
  const int cell = rows.x + static_cast<int>(i % ncr);
  const int k = static_cast<int>((i / ncr) % P13P);
  const int c = static_cast<int>(i / (static_cast<size_t>(ncr) * P13P));
  const bool live = is_block(FORM) ? cell >= gr.cbeg && cell < gr.cend
                                   : cell < nc;
  float val = 0.f;
  if (k < P13 && live) {
    if constexpr (FORM == kLattice) {
      float m;
      const size_t node = cell_node<P>(gr, cell, k, mask, &m);
      if constexpr (kNP != 1 && !kBfState)
        val = u[c * n_nodes + node] * m;
      else
        val = load_flex(u, c * n_nodes + node, x.io.bf16) * m;
    } else if constexpr (is_update(FORM)) {
      const float sc[4] = {x.io.scal[0], x.io.scal[1], x.io.scal[2],
                           x.io.scal[3]};
      val = cell_input<float, P, true, kNP == 1 || kBfState,
                       FORM == kLatticeUpdatePx, is_block(FORM)>(
          x.io, sc, gr, c, cell / (gr.ncx * gr.ncy), (cell / gr.ncx) % gr.ncy,
          cell % gr.ncx, k / S::P12, (k / S::P1) % S::P1, k % S::P1);
    } else if constexpr (kBfState) {
      val = load_flex(u, static_cast<size_t>(c * P13 + k) * nc + cell,
                      x.io.bf16);
    } else {
      val = u[static_cast<size_t>(c * P13 + k) * nc + cell];
    }
  }
  const int row = c * lay.ncp + cell;
  const size_t pos = a_frag_pos(row / 16, k / 16, L::KF, row % 16, k % 16);
  const __nv_bfloat16 hi = __float2bfloat16_rn(val);
  us[pos] = hi;
  if constexpr (kNP != 1)
    us[lay.u_part() * 8 + pos] = __float2bfloat16_rn(val - __bfloat162float(hi));
}

// The forward and the metric apply of 32 cells (blockIdx.x) x 16 q-points
// (blockIdx.y) x 3 components (warps): mf the forward fragment table
// (fragment (n8 tile, k16 step) at (nt KF + ks) 32 + lane), u's and t's
// fragments in the scratch.  REBUILD: G from x.coeffs (24, n_cells) by
// chain_of(NP), else streamed (6 Q3, n_cells), in bf16 where
// x.metric_bf16 is set (NP != 2).  BLOCK: B2's block form, the row tiles
// of hd_rows, G = 0 at their cells outside [gr.cbeg, gr.cend).
template <int P, bool REBUILD, int NP, bool BLOCK = false>
__global__ void __launch_bounds__(32 * Shape<P, NP>::C, 1)
    dense_hd_forward_kernel(const uint2* __restrict__ mf,
                            const float* __restrict__ gmetric, Grid gr,
                            MmaFusedArgs x, const uint4* __restrict__ us,
                            uint4* __restrict__ ts) {
  using S = Shape<P, NP>;
  using Ms = MmaShape<P, NP & kShMask>;
  using L = DenseHdLayout<P, NP>;
  constexpr int Q3 = S::Q3, Q3P = Ms::Q3P, KF = L::KF, KB = L::KB;
  constexpr int kNP = rung_of(NP);
  // split3: Ml's forward table, this far after Mh's
  constexpr int ML = 2 * 3 * Q3P * Ms::P13P / 4;
  __shared__ float gs[6][16][kMmaGLd];  // G of the chunk: (entry, q, cell)
  __shared__ float c24[REBUILD ? 24 : 1][kHdRowCells];
  const int nc = gr.n_cells();
  const L lay(nc);
  const int cell0 = (BLOCK ? hd_rows(gr).x : 0) + blockIdx.x * kHdRowCells,
            j = blockIdx.y;
  // the cells whose G is computed: the range's (BLOCK), else the real ones
  const auto live = [&](int cell) {
    return BLOCK ? cell >= gr.cbeg && cell < gr.cend : cell < nc;
  };
  const int tid = threadIdx.x;

  if constexpr (REBUILD) {
    for (int i = tid; i < 24 * kHdRowCells; i += blockDim.x) {
      const int b = i % kHdRowCells, e = i / kHdRowCells;
      c24[e][b] = live(cell0 + b)
                      ? x.coeffs[static_cast<size_t>(e) * nc + cell0 + b]
                      : 0.f;
    }
    __syncthreads();
  }
  for (int i = tid; i < 16 * kHdRowCells; i += blockDim.x) {
    const int b = i % kHdRowCells, ql = i / kHdRowCells;
    const int qp = 16 * j + ql, cell = cell0 + b;
    float gm[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (qp < Q3 && live(cell)) {
      if constexpr (REBUILD) {
        float pq[24];
        load_pds_row(x.pds + qp * 24, pq);
        onthefly_metric<kHdRowCells, chain_of(NP)>(pq, &c24[0][b],
                                                   __ldg(x.w3 + qp), gm);
      } else {
#pragma unroll
        for (int e = 0; e < 6; ++e) {
          const size_t at = static_cast<size_t>(e * Q3 + qp) * nc + cell;
          if constexpr ((NP & kSbMetric) != 0)
            gm[e] = metric_ldg<NP>(gmetric, at);
          else
            gm[e] = NP == 2 ? __ldg(gmetric + at)
                            : ldg_flex(gmetric, at, x.metric_bf16);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 6; ++e) gs[e][ql][b] = gm[e];
  }
  __syncthreads();

  const int c = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int mt0 = (c * lay.ncp + cell0) / 16;
  float acc[2][3][2][4] = {};  // m16 tile, direction, n8 half
  for (int k0 = 0; k0 < KF; k0 += kHdChunk) {
    float part[2][3][2][4] = {};  // this chunk's chains
#pragma unroll 2
    for (int ks = k0; ks < min(k0 + kHdChunk, KF); ++ks) {
      uint32_t a[2][L::NPART][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < L::NPART; ++n)
          ld_frag(us + n * lay.u_part() +
                      (static_cast<size_t>(mt0 + m) * KF + ks) * 32 + lane,
                  a[m][n]);
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nt = d * (Q3P / 8) + 2 * j + h;
          const uint2 bf = __ldg(mf + (nt * KF + ks) * 32 + lane);
          uint2 bl{};
          if constexpr (kNP == 3)
            bl = __ldg(mf + ML + (nt * KF + ks) * 32 + lane);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(part[m][d][h], a[m][0], bf);
            if constexpr (kNP != 1) mma_bf16(part[m][d][h], a[m][1], bf);
            if constexpr (kNP == 3) mma_bf16(part[m][d][h], a[m][0], bl);
          }
        }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][d][h][i] += part[m][d][h][i];
  }

  // t = G g at this thread's (cell, q-point) entries, split: register
  // 2 h + r of direction e's A fragment holds cells g + 8 r, q-points
  // 8 h + 2 t4 + {0, 1} of the chunk (k16 step e Q3P / 16 + j)
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    uint32_t th[3][4], tl[3][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int b = 16 * m + g + 8 * r;
        float tv[3][2];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int ql = 8 * h + 2 * t4 + e2;
          float G[6];
#pragma unroll
          for (int e = 0; e < 6; ++e) G[e] = gs[e][ql][b];
          const float gx = acc[m][0][h][2 * r + e2],
                      gy = acc[m][1][h][2 * r + e2],
                      gz = acc[m][2][h][2 * r + e2];
          tv[0][e2] = G[0] * gx + G[1] * gy + G[2] * gz;
          tv[1][e2] = G[1] * gx + G[3] * gy + G[4] * gz;
          tv[2][e2] = G[2] * gx + G[4] * gy + G[5] * gz;
        }
#pragma unroll
        for (int e = 0; e < 3; ++e)
          stream_parts<kNP>(tv[e][0], tv[e][1], th[e][2 * h + r],
                            tl[e][2 * h + r]);
      }
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const size_t at =
          (static_cast<size_t>(mt0 + m) * KB + e * Ms::QC + j) * 32 + lane;
      ts[at] = make_uint4(th[e][0], th[e][1], th[e][2], th[e][3]);
      if constexpr (kNP != 1)
        ts[lay.t_part() + at] = make_uint4(tl[e][0], tl[e][1], tl[e][2],
                                           tl[e][3]);
    }
  }
}

// The backward: each warp (blockIdx.x, warp) is a task of 32 rows (a row
// tile) x kHdBwdTiles n8 node tiles, mb the backward fragment table
// (fragment (nt, ks) at (nt KB + ks) 32 + lane).  BATCH: out is the cell
// batch (C P13, n_cells) (B3), else the masked cell-local values (C,
// n_cells, P13), the mask the tensor's where one is given (B6), else the
// box's from the indices (BLOCK: B2's block form, a block's).
template <int P, bool BATCH, int NP, bool BLOCK = false>
__global__ void __launch_bounds__(32 * kHdBwdWarps, 1)
    dense_hd_backward_kernel(const uint2* __restrict__ mb, Grid gr,
                             const float* __restrict__ mask,
                             const uint4* __restrict__ ts,
                             float* __restrict__ out) {
  using S = Shape<P, NP>;
  using Ms = MmaShape<P, NP & kShMask>;
  using L = DenseHdLayout<P, NP>;
  constexpr int P13 = S::P13, KB = L::KB, NT = Ms::P13P / 8;
  constexpr int kNP = rung_of(NP);
  constexpr int NG = (NT + kHdBwdTiles - 1) / kHdBwdTiles;  // node groups
  // split3: Ml's backward table, this far after Mh's
  constexpr int ML = 2 * 3 * Ms::Q3P * Ms::P13P / 4;
  const int nc = gr.n_cells();
  const L lay(nc);
  const int task = blockIdx.x * kHdBwdWarps + threadIdx.x / 32;
  // BLOCK: the row tiles of hd_rows of each component
  const int2 rows = BLOCK ? hd_rows(gr) : make_int2(0, 0);
  const int nrt = (rows.y - rows.x) / kHdRowCells;
  // no barrier in this kernel
  if (task >= (BLOCK ? S::C * nrt * NG : lay.mt / 2 * NG)) return;
  const int mt0 = BLOCK ? ((task / NG / nrt) * lay.ncp + rows.x) / 16 +
                              2 * (task / NG % nrt)
                        : task / NG * 2;
  const int nt0 = task % NG * kHdBwdTiles;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  float v[2][kHdBwdTiles][4] = {};
  for (int k0 = 0; k0 < KB; k0 += kHdChunk) {
    float part[2][kHdBwdTiles][4] = {};  // this chunk's chains
#pragma unroll 2
    for (int ks = k0; ks < min(k0 + kHdChunk, KB); ++ks) {
      uint32_t a[2][L::NPART][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < L::NPART; ++n)
          ld_frag(ts + n * lay.t_part() +
                      (static_cast<size_t>(mt0 + m) * KB + ks) * 32 + lane,
                  a[m][n]);
#pragma unroll
      for (int n = 0; n < kHdBwdTiles; ++n) {
        const int nt = nt0 + n;
        if (nt >= NT) break;
        const uint2 bb = __ldg(mb + (nt * KB + ks) * 32 + lane);
        uint2 bl{};
        if constexpr (kNP == 3)
          bl = __ldg(mb + ML + (nt * KB + ks) * 32 + lane);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(part[m][n], a[m][0], bb);
          if constexpr (kNP != 1) mma_bf16(part[m][n], a[m][1], bb);
          if constexpr (kNP == 3) mma_bf16(part[m][n], a[m][0], bl);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < kHdBwdTiles; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[m][n][i] += part[m][n][i];
  }

  // v[m][n][2 r + e2] is row 16 (mt0 + m) + g + 8 r, node 8 (nt0 + n) +
  // 2 t4 + e2
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kHdBwdTiles; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * (mt0 + m) + g + 8 * (i / 2);
        const int c = row / lay.ncp, cell = row % lay.ncp;
        const int k = 8 * (nt0 + n) + 2 * t4 + i % 2;
        if (cell >= (BLOCK ? gr.cend : nc) || k >= P13) continue;
        if constexpr (BLOCK) {
          if (cell < gr.cbeg) continue;
        }
        if constexpr (BATCH && (NP & kSbState) != 0) {
          // B3 with the bf16 state: its output rounded where it is stored
          reinterpret_cast<__nv_bfloat16*>(
              out)[static_cast<size_t>(c * P13 + k) * nc + cell] =
              __float2bfloat16_rn(v[m][n][i]);
        } else if constexpr (BATCH) {
          out[static_cast<size_t>(c * P13 + k) * nc + cell] = v[m][n][i];
        } else {
          float mk;
          cell_node<P, BLOCK>(gr, cell, k, mask, &mk);
          out[(static_cast<size_t>(c) * nc + cell) * P13 + k] = v[m][n][i] * mk;
        }
      }
}

template <int P, int FORM, bool REBUILD, int NP>
cudaError_t launch_mma_hd_here(const void* mf, const void* mb,
                               const float* gmetric, const Grid& gr,
                               const float* mask, const float* u, float* out,
                               const MmaFusedArgs& x, void* scratch,
                               cudaStream_t st) {
  using L = DenseHdLayout<P, NP>;
  const int nc = gr.n_cells();
  const L lay(nc);
  auto us = static_cast<uint4*>(scratch);
  uint4* ts = us + L::NPART * lay.u_part();
  // the block form: the row tiles that hold its cells [cbeg, cend)
  const int2 rows = is_block(FORM) ? hd_rows(gr) : make_int2(0, lay.ncp);
  const int ncr = rows.y - rows.x;
  if (ncr <= 0) return cudaSuccess;  // an empty range of the block form
  using Ms = typename L::Ms;
  constexpr int C = Shape<P, NP>::C;
  const size_t n_in = static_cast<size_t>(C) * Ms::P13P * ncr;
  dense_hd_gather_kernel<P, FORM, NP & ~kJtjChain>
      <<<(n_in + kHdGatherThreads - 1) / kHdGatherThreads, kHdGatherThreads,
         0, st>>>(gr, mask, u, x, reinterpret_cast<__nv_bfloat16*>(us));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the storage flags each pass reads: the forward the metric's, the
  // backward in B3's form the state's (its bf16 store, where io.bf16 is
  // set), so that the other instantiations of a rung are shared
  constexpr int NPF = NP & ~kSbState;
  constexpr int NPR = rung_of(NP) | (NP & kShMask);  // the rung and shape
  constexpr int NPB = FORM == kCellBatch ? NP & ~kSbMetric : NPR;
  dense_hd_forward_kernel<P, REBUILD, NPF, is_block(FORM)>
      <<<dim3(ncr / kHdRowCells, Ms::QC), 32 * C, 0, st>>>(
          static_cast<const uint2*>(mf), gmetric, gr, x, us, ts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int NG = (Ms::P13P / 8 + kHdBwdTiles - 1) / kHdBwdTiles;
  const int tasks = C * (ncr / kHdRowCells) * NG;
  const int nb = (tasks + kHdBwdWarps - 1) / kHdBwdWarps;
  if constexpr (NPB != NPR) {
    if (!x.io.bf16) {  // B3's output at f32: the rung's own pass
      dense_hd_backward_kernel<P, true, NPR, false>
          <<<nb, 32 * kHdBwdWarps, 0, st>>>(static_cast<const uint2*>(mb), gr,
                                           mask, ts, out);
      return cudaGetLastError();
    }
  }
  dense_hd_backward_kernel<P, FORM == kCellBatch, NPB, is_block(FORM)>
      <<<nb, 32 * kHdBwdWarps, 0, st>>>(static_cast<const uint2*>(mb), gr,
                                       mask, ts, out);
  return cudaGetLastError();
}

// The scratch of launch_mma_hd at degree P under the rung with NP products
// a tile for n_cells cells, in 16-byte units.
template <int P, int NP>
size_t dense_hd_scratch_len(int n_cells) {
  return DenseHdLayout<P, NP>(n_cells).len();
}

// The pass of one configuration at degree P = 5..11 (apply_mma.cuh's
// launch_mma with the caller's scratch, dense_hd_scratch_len): every
// rung's instantiations in one source a degree (apply_mma_p05.cu ..
// apply_mma_p11.cu, each built once per rung, -DBP4_RUNG=n), compiled in
// parallel with the others.
template <int P, int FORM, bool REBUILD, int NP>
cudaError_t launch_mma_hd(const void* mf, const void* mb, const float* gmetric,
                          const Grid& gr, const float* mask, const float* u,
                          float* out, const MmaFusedArgs& x, void* scratch,
                          cudaStream_t st);

#define BP4_MMA_HD_SIGNATURE(P, FORM, REBUILD, NP)                           \
  template <>                                                                \
  cudaError_t launch_mma_hd<P, FORM, REBUILD, NP>(                           \
      const void* mf, const void* mb, const float* gmetric, const Grid& gr,  \
      const float* mask, const float* u, float* out, const MmaFusedArgs& x, \
      void* scratch, cudaStream_t st)
#define BP4_MMA_HD_DECLARE1(P, FORM, REBUILD, NP) \
  BP4_MMA_HD_SIGNATURE(P, FORM, REBUILD, NP);
#define BP4_MMA_HD_DEFINE1(P, FORM, REBUILD, NP)                           \
  BP4_MMA_HD_SIGNATURE(P, FORM, REBUILD, NP) {                             \
    return launch_mma_hd_here<P, FORM, REBUILD, NP>(mf, mb, gmetric, gr,   \
                                                    mask, u, out, x,       \
                                                    scratch, st);          \
  }
#define BP4_MMA_HD_DECLARE(P)             \
  BP4_MMA_CONFIGS(P, 1, BP4_MMA_HD_DECLARE1) \
  BP4_MMA_CONFIGS(P, 2, BP4_MMA_HD_DECLARE1) \
  BP4_MMA_CONFIGS(P, 3, BP4_MMA_HD_DECLARE1)
// the definitions of degree P's configurations at one rung, in its source,
// the metric rebuilt by jtj among them (apply_mma.cuh's BP4_MMA_JTJ_RUNG)
#define BP4_MMA_HD_DEGREE(P, NP)           \
  BP4_MMA_CONFIGS(P, NP, BP4_MMA_HD_DEFINE1) \
  BP4_MMA_JTJ_RUNG(P, NP, BP4_MMA_HD_DEFINE1)
// the storage instantiations (apply_mma.cuh's BP4_MMA_SB_RUNG*), in
// apply_mma_sb.cu, one object a degree and rung
#define BP4_MMA_HD_SB_DECLARE(P)                \
  BP4_MMA_SB_RUNG1(P, BP4_MMA_HD_DECLARE1)     \
  BP4_MMA_SB_RUNG2(P, BP4_MMA_HD_DECLARE1)     \
  BP4_MMA_SB_RUNG3(P, BP4_MMA_HD_DECLARE1)

BP4_MMA_HD_DECLARE(5)
BP4_MMA_HD_DECLARE(6)
BP4_MMA_HD_DECLARE(7)
BP4_MMA_HD_DECLARE(8)
BP4_MMA_HD_DECLARE(9)
BP4_MMA_HD_DECLARE(10)
BP4_MMA_HD_DECLARE(11)
BP4_MMA_HD_SB_DECLARE(5)
BP4_MMA_HD_SB_DECLARE(6)
BP4_MMA_HD_SB_DECLARE(7)
BP4_MMA_HD_SB_DECLARE(8)
BP4_MMA_HD_SB_DECLARE(9)
BP4_MMA_HD_SB_DECLARE(10)
BP4_MMA_HD_SB_DECLARE(11)
// the metric rebuilt by the jtj chain (apply_mma.cuh's BP4_MMA_JTJ_*), in
// apply_mma_pNN.cu and apply_mma_sb.cu
BP4_MMA_JTJ_DECLARE(5, BP4_MMA_HD_DECLARE1)
BP4_MMA_JTJ_DECLARE(6, BP4_MMA_HD_DECLARE1)
BP4_MMA_JTJ_DECLARE(7, BP4_MMA_HD_DECLARE1)
BP4_MMA_JTJ_DECLARE(8, BP4_MMA_HD_DECLARE1)
BP4_MMA_JTJ_DECLARE(9, BP4_MMA_HD_DECLARE1)
BP4_MMA_JTJ_DECLARE(10, BP4_MMA_HD_DECLARE1)
BP4_MMA_JTJ_DECLARE(11, BP4_MMA_HD_DECLARE1)

}  // namespace bp4
