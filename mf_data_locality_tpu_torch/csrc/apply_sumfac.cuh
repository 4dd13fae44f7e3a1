// The "highest" cell pass of the BP4 operator on Hopper's CUDA cores
// (sm_90a), f32 or f64: v = sum_e M_e^T G_ef M_f u per cell, by sum
// factorization, with the metric G streamed (B3, B5, B6; B1, B2 built with
// the precomputed metric) or rebuilt in the kernel from the cell's
// trilinear coefficients (B4; B1, B2 built on the fly), on cell batches
// (B3, B4) or on the lattice (B5, B6, B1, B2; the assemble pass of
// bp4_operator.cuh follows in laplace_apply.cu and cg_fused.cu).
//
// Replaces, under precision "highest" (f32 and f64; B4 on every rung), the
// TPU kernels of mf_data_locality_tpu/ops/:
//   B3  laplace_pallas.py  _kernel_g         :479   (pallas_call :1023)
//   B4  laplace_pallas.py  _kernel           :515   (pallas_call :1043)
//   B6  laplace_pallas.py  _kernel_g_zslab   :576   (pallas_call :664)
//   B5  laplace_pallas.py  _kernel_g_pieces  :845   (pallas_call :947)
//   B1  cg_fused_kernel.py _matvec_kernel           (pallas_call :1116)
//   B2  cg_fused_kernel.py _fused_cg_kernel         (pallas_call :1476)
// The f32 "split2m" rung of B3/B5/B6 runs on the tensor cores
// (apply_mma.cuh), and that of B1/B2 too (cell_mma.cuh): its rounding of
// the dense (B3-B6) or 2D (B1/B2) entries defines that function, and a
// factorized form does not reproduce it.  B4 is exact on every rung
// (_kernel runs at Precision.HIGHEST, :529), so this pass serves all of them.
//
// The TPU kernels multiply by the dense gradient matrices M_x = S (x) S (x) D,
// M_y = S (x) D (x) S, M_z = D (x) S (x) S ((z, y, x) order; S, D the (Q,
// P1) values and derivatives of the 1D basis at the Gauss points), because
// contractions of depth P1 waste the MXU (laplace_pallas.py:15-20); B1/B2
// contract z by S, D and then a dense 2D stage (twostage), or use the dense
// M as well (the JAX auto-dispatch's fused configuration under "highest" at
// p <= 4).  Exact f32 or f64
// on this card runs on the CUDA cores, where the FMA count is what binds, so
// this pass applies the 1D factors in x, y, z (p=4: ~5.0e4 FMAs a cell
// against the dense form's 4.9e5 and twostage's 1.4e5).  Under "highest" it
// is the same function summed in another order: it agrees with the dense
// and twostage plain versions within 1e-5 (f32) and 1e-12 (f64) relative.
//
//   forward   x pass   xs, xd     = S_x u, D_x u             (kz, ky, qx)
//             y pass   uss, uds, usd = S_y xs, D_y xs, S_y xd (kz, qy, qx)
//             z pass   gx, gy, gz = S_z usd, S_z uds, D_z uss (qz, qy, qx)
//   apply     t = G [gx, gy, gz], the 6 entries of the symmetric G
//   backward  the transposes in reverse order: z, then y, then x
//
// Layout: one block is BC cells (8 f32, 4 f64: one 32-byte sector of every
// cell-fastest row; from p=7 fewer, SumfacCells, so that the block's
// shared memory fits in 227 KB) times the Q^2 (qy, qx) columns of a cell,
// the cell the
// fastest thread index, so the metric or coefficients, the batched u and v
// are read and written a full sector per 8 (4) threads.  A thread owns one
// column and carries the z direction in registers ("2D threads, z in
// registers", as in GPU sum-factorization kernels); the x and y passes
// exchange through shared planes.  The forward z pass, the metric apply and
// the backward z pass are fused per qz, so gx, gy, gz never leave
// registers.  The block's metric (6 Q^3 BC words) sits in shared memory and
// serves the three components; S and D (2 Q P1 words) sit there too.  Thread
// (col, b) reads the metric only at its own (qz, col, b) slots.
//
// Metric source (REBUILD):
//   streamed  the 6 Q^3 words a cell, copied by cp.async while component
//             0's input arrives and its x pass runs;
//   rebuilt   the block's 24 BC coefficients (24 words a cell, in place of
//             1,296 at p=4) copied to shared memory; in the prologue, while
//             component 0's input arrives, each thread rebuilds G at its
//             own Q slots by onthefly_metric (J = pds . c24 in exact FMA at
//             the working type, then the chain a.cofactor: the adjugate,
//             G = w adj adj^T / det, or jtj; uniform over the block), once
//             per (cell, q-point) for the three components, as _kernel does
//             (laplace_pallas.py:558-560); the slots are thread-private, so
//             the rebuild needs only the coefficients' barrier.  The pds
//             row of a q-point is read by 16-byte loads that the BC threads
//             of a column share, a broadcast.  Placed after component 0's x
//             pass instead, the rebuild made the lattice forms spill and
//             ran slower (PERF.md, utils/variants.py).
//
// Storage (SB, bp4_operator.cuh), f32 only: kSbState, the state in bf16
// by io.bf16 (B3/B4 read u and write v in bf16; B5/B6/B1 read u, B2 d and
// h, and B2 stores d' rounded, the operator taking the rounded d'), the
// arithmetic f32; kSbMetric, the streamed metric in bf16, fixed at compile
// time: its words are upcast into shared memory by plain loads (cp.async
// copies 4, 8 or 16 bytes, not 2), so the copy no longer overlaps
// component 0's x pass.  SB = 0 is the pass as it was; the SB
// instantiations are built in sumfac_sb.cu, one object a degree.
//
// Shape (SB's kShC1, kShQ1, bp4_operator.cuh): one component (CEED BP3)
// and Q = P + 1; the same code, the component loop and the q extents
// constants of the instantiation.  Every shape fits the layout above:
// Q = P + 1 needs less shared memory than BP4's Q = P + 2, one component
// as much (the block holds one component's input at a time).
//
// Input forms (FORM, bp4_operator.cuh): kCellBatch (B3, B4); kLattice (B5,
// B6, B1; B6 masks by the mask tensor, B5 and B1 by the box's Dirichlet
// mask from the indices); kLatticeUpdate (B2, the four scalars staged once
// a block).
// With the cell the fastest index, a warp's gather reads P-strided nodes
// that neighbouring threads complete, so it touches about one sector per 8
// words.  The masked cell-local result is staged in shared memory and
// stored as one contiguous run of BC P13 words a component, then the
// fixed-order assemble pass sums each node: no atomics, two calls bitwise
// equal.
//
// Bound (p=4, s=13, 8192 cells): 50,472 FMAs a cell (per component forward
// 1,500 + 2,700 + 3,240, the same backward, x3, plus 27 Q^3 for the metric
// apply), 4.1e8 FMAs, 12.3 us at the 67 TFLOP/s f32 peak; the bytes of B3,
// the metric (6 Q^3 words a cell) plus u and v, 67 MB in f32, 20.0 us at
// 3.35 TB/s: B3/B5/B6 are bound by bytes.  A rebuilt metric adds 117 Q^3 =
// 25,272 FMAs a cell and takes 1,272 words a cell off the bytes: B4 (25 MB
// in f32) is bound by its operations, 18.5 us (f64 37 us); B1 (14 MB) by
// its operations too, B2 (55 MB) by its bytes, 16.5 us.  The measured times
// and what holds them are in PERF.md.
//
// Degrees 5..11: p=5, 6 keep the layout (one 118-179 KB block an SM); from
// p=7 BC halves (f32 4 at p=7, 8; 2 at p=9..11) and one block of 121-400
// threads runs an SM, so these degrees are latency-bound (PERF.md: 10-26%
// of the bound at p=6 and p=8).

#pragma once

#include <cuda_pipeline.h>

#include "bp4_operator.cuh"

namespace bp4 {

constexpr size_t kSmemBlock = 232448;  // shared memory a block may use
constexpr size_t kSmemSm = 233472;     // an SM's, 1 KB of it a block's own

// Cells a block: 8 f32 (4 f64), one 32-byte sector of every cell-fastest
// row, halved from p=7 on until the block's shared memory (SumfacSmem with
// the coefficients) fits in kSmemBlock: f32 4 at p=7, 8; 2 at p=9..11 (f64
// half as many).
template <typename T, int P, int SH = 0>
constexpr size_t sumfac_bytes(int bc) {
  using S = Shape<P, SH>;
  return sizeof(T) *
         (static_cast<size_t>(bc) * (6 * S::Q3 + 2 * S::P12 * S::Q +
                                     3 * S::P1 * S::Q2 + S::P13 + 24) +
          2 * S::Q * S::P1 + 4);
}
template <typename T, int P, int SH = 0>
constexpr int sumfac_cells() {
  int bc = 32 / static_cast<int>(sizeof(T));
  while (bc > 1 && sumfac_bytes<T, P, SH>(bc) > kSmemBlock) bc /= 2;
  return bc;
}
template <typename T, int P, int SH = 0>
struct SumfacCells {
  static constexpr int N = sumfac_cells<T, P, SH>();
  static_assert(sumfac_bytes<T, P, SH>(N) <= kSmemBlock, "no layout fits");
};

// What the pass reads and writes, device pointers at the working type T.
template <typename T>
struct SumfacArgs {
  const T* sz;       // S (Q, P1)
  const T* dz;       // D (Q, P1)
  const T* gmetric;  // streamed: (6 Q3, n_cells), entries 00 01 02 11 12 22
  const T* pds;      // rebuilt: (Q3, 24), d(monomial k)/d(u_e) at e*8 + k
  const T* w3;       // rebuilt: (Q3,)
  const T* coeffs;   // rebuilt: (24, n_cells), coordinate d's monomial k at
                     // row d*8 + k
  const T* mask;     // B6's mask tensor; null: the box's mask from the indices
  CellIo<T> io;      // io.d the input; kLatticeUpdate: update4b's vectors
  T* out;
  int cofactor;      // rebuilt: the inversion chain, kAdjj or kJtj
};

template <typename T, int P, bool REBUILD, int SH = 0>
struct SumfacSmem {
  using S = Shape<P, SH>;
  static constexpr int BC = SumfacCells<T, P, SH>::N;
  static constexpr int kThreads = S::Q2 * BC;
  T g[6][S::Q3][BC];               // the block's metric, entries 00 .. 22
  T x[2][S::P1][S::P1][S::Q][BC];  // x-direction partials (S, D): (kz, ky, qx)
  T w[3][S::P1][S::Q2][BC];        // backward z pass: (kz, qy qx); lattice
                                   // forms: then the output, (cell, node)
  T u[S::P13][BC];                 // one component's input
  T sz[S::Q * S::P1];              // S (Q, P1)
  T dz[S::Q * S::P1];              // D (Q, P1)
  T c24[REBUILD ? 24 : 1][BC];     // rebuilt: the cells' coefficients
  T sc[4];                         // kLatticeUpdate: alpha, beta, c1, aob
  // input elements a thread loads for one component
  static constexpr int PER = (S::P13 * BC + kThreads - 1) / kThreads;
};

// One component's input elements of this thread, i = tid + j kThreads =
// node k BC + cell: the values and (kLattice) their mask, multiplied at the
// store into shared memory.  The cell-batch form loads the next
// component's input ahead, so that the loads' latency overlaps the passes
// between; the lattice forms load it just before the store, because their
// values and masks held across the passes spill under the three blocks an
// SM and ran slower (PERF.md).
template <typename T, int P, bool REBUILD, int FORM, int SB = 0>
struct SumfacInput {
  using Sm = SumfacSmem<T, P, REBUILD, SB & kShMask>;
  static constexpr bool kMasked = FORM == kLattice;
  T v[Sm::PER];
  T m[kMasked ? Sm::PER : 1];

  __device__ __forceinline__ void load(const Grid& gr, const SumfacArgs<T>& a,
                                       const Sm& sm, int c, int cell0,
                                       int nlive) {
    using S = Shape<P, SB>;
    constexpr int BC = Sm::BC, P13 = S::P13;
    const int nc = gr.n_cells();
#pragma unroll
    for (int j = 0; j < Sm::PER; ++j) {
      const int i = threadIdx.x + j * Sm::kThreads, bb = i % BC, k = i / BC;
      const bool live = i < P13 * BC && bb < nlive;  // past the end: zeros
      v[j] = T(0);
      if constexpr (FORM == kLattice) {
        m[j] = T(0);
        if (live) {
          const size_t node = cell_node<P>(gr, cell0 + bb, k, a.mask, &m[j]);
          const size_t at = c * static_cast<size_t>(gr.n_nodes()) + node;
          if constexpr ((SB & kSbState) != 0)
            v[j] = load_flex(a.io.d, at, a.io.bf16);
          else
            v[j] = a.io.d[at];
        }
      } else if constexpr (is_update(FORM)) {
        if (live) {
          const int cell = cell0 + bb;
          v[j] = cell_input<T, P, true, (SB & kSbState) != 0,
                            FORM == kLatticeUpdatePx, is_block(FORM)>(
              a.io, sm.sc, gr, c, cell / (gr.ncx * gr.ncy),
              (cell / gr.ncx) % gr.ncy, cell % gr.ncx, k / S::P12,
              (k / S::P1) % S::P1, k % S::P1);
        }
      } else if (live) {
        const size_t at = static_cast<size_t>(c * P13 + k) * nc + cell0 + bb;
        if constexpr ((SB & kSbState) != 0)
          v[j] = load_flex(a.io.d, at, a.io.bf16);
        else
          v[j] = a.io.d[at];
      }
    }
  }

  __device__ __forceinline__ void store(Sm& sm) const {
#pragma unroll
    for (int j = 0; j < Sm::PER; ++j) {
      const int i = threadIdx.x + j * Sm::kThreads;
      if (i < Shape<P, SB>::P13 * Sm::BC)
        (&sm.u[0][0])[i] = kMasked ? v[j] * m[j] : v[j];
    }
  }
};

// Blocks an SM: three at p <= 4 (73.4 KB of shared memory each at p=4 with
// the rebuilt metric, 72.6 KB streamed), which cap a thread at 72
// registers in f32; from p=5 as many as the shared memory holds, one.
template <typename T, int P, bool REBUILD, int SH = 0>
constexpr int sumfac_blocks() {
  const size_t n = kSmemSm / (sizeof(SumfacSmem<T, P, REBUILD, SH>) + 1024);
  return n < 3 ? static_cast<int>(n) : 3;
}

template <typename T, int P, int FORM, bool REBUILD, int SB = 0>
__global__ void __launch_bounds__(
    SumfacSmem<T, P, REBUILD, SB & kShMask>::kThreads,
    sumfac_blocks<T, P, REBUILD, SB & kShMask>())
    apply_sumfac_kernel(SumfacArgs<T> a, Grid gr) {
  static_assert((SB & (kSbState | kSbMetric)) == 0 ||
                    std::is_same_v<T, float>,
                "bf16 storage: f32");
  using S = Shape<P, SB>;
  using Sm = SumfacSmem<T, P, REBUILD, SB & kShMask>;
  constexpr int BC = Sm::BC, NT = Sm::kThreads;
  constexpr int P1 = S::P1, Q = S::Q, Q2 = S::Q2, Q3 = S::Q3, P13 = S::P13;
  constexpr bool kAhead = FORM == kCellBatch;  // next component's input
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int nc = gr.n_cells();
  // the block form: the cells [gr.cbeg, gr.cend) (the layer-range form)
  const int cell0 = (is_block(FORM) ? gr.cbeg : 0) + blockIdx.x * BC;
  const int nlive = min(BC, (is_block(FORM) ? gr.cend : nc) - cell0);
  const int tid = threadIdx.x;
  const int b = tid % BC, col = tid / BC;

  for (int i = tid; i < Q * P1; i += NT) {
    sm.sz[i] = a.sz[i];
    sm.dz[i] = a.dz[i];
  }
  if constexpr (REBUILD) {
    // the cells' coefficients (zero past the end: a zero metric)
    for (int i = tid; i < 24 * BC; i += NT) {
      const int bb = i % BC;
      (&sm.c24[0][0])[i] =
          bb < nlive ? a.coeffs[static_cast<size_t>(i / BC) * nc + cell0 + bb]
                     : T(0);
    }
  } else if constexpr ((SB & kSbMetric) != 0) {
    // the block's bf16 metric, upcast into shared memory (zero past the
    // end); the first barrier below publishes it
    for (int i = tid; i < 6 * Q3 * BC; i += NT) {
      const int bb = i % BC;
      (&sm.g[0][0][0])[i] =
          bb < nlive ? metric_ldg<SB>(a.gmetric, static_cast<size_t>(i / BC) *
                                                     nc + cell0 + bb)
                     : T(0);
    }
  } else {
    // the block's metric, copied asynchronously (cp.async) while component
    // 0's input arrives and its x pass runs; cells past the end zero-filled
    for (int i = tid; i < 6 * Q3 * BC; i += NT) {
      const int bb = i % BC;
      __pipeline_memcpy_async(
          &sm.g[0][0][0] + i,
          a.gmetric + static_cast<size_t>(i / BC) * nc + cell0 +
              min(bb, nlive - 1),
          sizeof(T), bb < nlive ? 0 : sizeof(T));
    }
    __pipeline_commit();
  }
  if constexpr (is_update(FORM)) {
    if (tid < 4) sm.sc[tid] = a.io.scal[tid];
    __syncthreads();
  }
  SumfacInput<T, P, REBUILD, FORM, SB> in;
  in.load(gr, a, sm, 0, cell0, nlive);
  if constexpr (REBUILD) {
    // while component 0's input arrives: G at this thread's own slots
    // (qz, col, b), read only by it
    __syncthreads();  // the coefficients
    for (int qz = 0; qz < Q; ++qz) {
      const int qp = qz * Q2 + col;
      T pq[24], gm[6];
      load_pds_row(a.pds + qp * 24, pq);
      if (a.cofactor == kJtj)
        onthefly_metric<BC, kJtj>(pq, &sm.c24[0][b], __ldg(a.w3 + qp), gm);
      else
        onthefly_metric<BC>(pq, &sm.c24[0][b], __ldg(a.w3 + qp), gm);
#pragma unroll
      for (int e = 0; e < 6; ++e) sm.g[e][qp][b] = gm[e];
    }
  }
  in.store(sm);

  for (int c = 0; c < S::C; ++c) {
    __syncthreads();

    // x pass: thread (ky, qx)
    if (col < P1 * Q) {
      const int ky = col / Q, qx = col % Q;
      T s[P1], d[P1];
#pragma unroll
      for (int k = 0; k < P1; ++k) {
        s[k] = sm.sz[qx * P1 + k];
        d[k] = sm.dz[qx * P1 + k];
      }
#pragma unroll
      for (int kz = 0; kz < P1; ++kz) {
        T as = T(0), ad = T(0);
#pragma unroll
        for (int kx = 0; kx < P1; ++kx) {
          const T v = sm.u[(kz * P1 + ky) * P1 + kx][b];
          as = fma(s[kx], v, as);
          ad = fma(d[kx], v, ad);
        }
        sm.x[0][kz][ky][qx][b] = as;
        sm.x[1][kz][ky][qx][b] = ad;
      }
    }
    if constexpr (!REBUILD && (SB & kSbMetric) == 0) {
      if (c == 0) __pipeline_wait_prior(0);  // this thread's metric copies
    }
    __syncthreads();

    // y pass, then per qz plane: z pass, metric apply, backward z pass;
    // thread (qy, qx)
    {
      const int qy = col / Q, qx = col % Q;
      T uss[P1], uds[P1], usd[P1];
      {
        T s[P1], d[P1];
#pragma unroll
        for (int k = 0; k < P1; ++k) {
          s[k] = sm.sz[qy * P1 + k];
          d[k] = sm.dz[qy * P1 + k];
        }
#pragma unroll
        for (int kz = 0; kz < P1; ++kz) {
          T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll
          for (int ky = 0; ky < P1; ++ky) {
            const T xs = sm.x[0][kz][ky][qx][b], xd = sm.x[1][kz][ky][qx][b];
            a0 = fma(s[ky], xs, a0);
            a1 = fma(d[ky], xs, a1);
            a2 = fma(s[ky], xd, a2);
          }
          uss[kz] = a0;
          uds[kz] = a1;
          usd[kz] = a2;
        }
      }
      T wsd[P1], wds[P1], wss[P1];
#pragma unroll
      for (int kz = 0; kz < P1; ++kz) wsd[kz] = wds[kz] = wss[kz] = T(0);
#pragma unroll
      for (int qz = 0; qz < Q; ++qz) {
        T zs[P1], zd[P1];
#pragma unroll
        for (int k = 0; k < P1; ++k) {
          zs[k] = sm.sz[qz * P1 + k];
          zd[k] = sm.dz[qz * P1 + k];
        }
        T gx = T(0), gy = T(0), gz = T(0);
#pragma unroll
        for (int kz = 0; kz < P1; ++kz) {
          gx = fma(zs[kz], usd[kz], gx);
          gy = fma(zs[kz], uds[kz], gy);
          gz = fma(zd[kz], uss[kz], gz);
        }
        const int qp = qz * Q2 + col;
        const T g00 = sm.g[0][qp][b], g01 = sm.g[1][qp][b],
                g02 = sm.g[2][qp][b], g11 = sm.g[3][qp][b],
                g12 = sm.g[4][qp][b], g22 = sm.g[5][qp][b];
        const T tx = g00 * gx + g01 * gy + g02 * gz;
        const T ty = g01 * gx + g11 * gy + g12 * gz;
        const T tz = g02 * gx + g12 * gy + g22 * gz;
#pragma unroll
        for (int kz = 0; kz < P1; ++kz) {
          wsd[kz] = fma(zs[kz], tx, wsd[kz]);
          wds[kz] = fma(zs[kz], ty, wds[kz]);
          wss[kz] = fma(zd[kz], tz, wss[kz]);
        }
      }
#pragma unroll
      for (int kz = 0; kz < P1; ++kz) {
        sm.w[0][kz][col][b] = wsd[kz];
        sm.w[1][kz][col][b] = wds[kz];
        sm.w[2][kz][col][b] = wss[kz];
      }
    }
    if (kAhead && c + 1 < S::C) in.load(gr, a, sm, c + 1, cell0, nlive);
    __syncthreads();

    // backward y pass: thread (ky, qx)
    if (col < P1 * Q) {
      const int ky = col / Q, qx = col % Q;
      T s[Q], d[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        s[q] = sm.sz[q * P1 + ky];
        d[q] = sm.dz[q * P1 + ky];
      }
#pragma unroll
      for (int kz = 0; kz < P1; ++kz) {
        T vs = T(0), vd = T(0);
#pragma unroll
        for (int qy = 0; qy < Q; ++qy) {
          const int cq = qy * Q + qx;
          vs = fma(d[qy], sm.w[1][kz][cq][b], vs);
          vs = fma(s[qy], sm.w[2][kz][cq][b], vs);
          vd = fma(s[qy], sm.w[0][kz][cq][b], vd);
        }
        sm.x[0][kz][ky][qx][b] = vs;
        sm.x[1][kz][ky][qx][b] = vd;
      }
    }
    __syncthreads();

    // backward x pass and output: thread (ky, kx)
    T* stage = &sm.w[0][0][0][0];  // lattice forms: (cell, node)
    if (col < P1 * P1) {
      const int ky = col / P1, kx = col % P1;
      T s[Q], d[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        s[q] = sm.sz[q * P1 + kx];
        d[q] = sm.dz[q * P1 + kx];
      }
#pragma unroll
      for (int kz = 0; kz < P1; ++kz) {
        T v = T(0);
#pragma unroll
        for (int qx = 0; qx < Q; ++qx) {
          v = fma(s[qx], sm.x[0][kz][ky][qx][b], v);
          v = fma(d[qx], sm.x[1][kz][ky][qx][b], v);
        }
        const int k = (kz * P1 + ky) * P1 + kx;
        if constexpr (FORM != kCellBatch) {
          T m = T(0);
          if (b < nlive)
            cell_node<P, is_block(FORM)>(gr, cell0 + b, k, a.mask, &m);
          stage[b * P13 + k] = v * m;
        } else if (b < nlive) {
          const size_t at = static_cast<size_t>(c * P13 + k) * nc + cell0 + b;
          if constexpr ((SB & kSbState) != 0)
            store_flex(a.out, at, v, a.io.bf16);
          else
            a.out[at] = v;
        }
      }
    }
    if constexpr (FORM != kCellBatch) {
      __syncthreads();
      T* dst = a.out + (static_cast<size_t>(c) * nc + cell0) * P13;
      for (int i = tid; i < nlive * P13; i += NT) dst[i] = stage[i];
    }
    if (c + 1 < S::C) {  // sm.u was last read by the x pass
      if (!kAhead) in.load(gr, a, sm, c + 1, cell0, nlive);
      in.store(sm);
    }
  }
}

template <typename T, int P, int FORM, bool REBUILD, int SB = 0>
cudaError_t launch_sumfac_here(const SumfacArgs<T>& a, const Grid& gr,
                               cudaStream_t st) {
  using Sm = SumfacSmem<T, P, REBUILD, SB & kShMask>;
  auto kern = apply_sumfac_kernel<T, P, FORM, REBUILD, SB>;
  // above 48 KB a block's shared memory must be requested explicitly
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Sm));
  if (attr != cudaSuccess) return attr;
  const int n = is_block(FORM) ? gr.cend - gr.cbeg : gr.n_cells();
  if (n <= 0) return cudaSuccess;  // an empty range of the block form
  kern<<<(n + Sm::BC - 1) / Sm::BC, Sm::kThreads, sizeof(Sm), st>>>(a, gr);
  return cudaGetLastError();
}

// The pass of one form.  Degrees 1..4 are instantiated where they are
// called (laplace_apply.cu, cg_fused.cu); degrees 5..11, the largest
// unrolled instantiations, in one source a degree (sumfac_p05.cu ..
// sumfac_p11.cu, BP4_SUMFAC_DEGREE), which nvcc compiles in parallel with
// the others: the declarations below keep the callers from instantiating
// them.
template <typename T, int P, int FORM, bool REBUILD, int SB = 0>
cudaError_t launch_sumfac(const SumfacArgs<T>& a, const Grid& gr,
                          cudaStream_t st) {
  return launch_sumfac_here<T, P, FORM, REBUILD, SB>(a, gr, st);
}

#define BP4_SUMFAC_FORM_DECLARE(T, P, FORM, REBUILD)    \
  template <>                                           \
  cudaError_t launch_sumfac<T, P, FORM, REBUILD>(       \
      const SumfacArgs<T>& a, const Grid& gr, cudaStream_t st);
#define BP4_SUMFAC_FORM_DEFINE(T, P, FORM, REBUILD)                  \
  template <>                                                        \
  cudaError_t launch_sumfac<T, P, FORM, REBUILD>(                    \
      const SumfacArgs<T>& a, const Grid& gr, cudaStream_t st) {     \
    return launch_sumfac_here<T, P, FORM, REBUILD>(a, gr, st);       \
  }
#define BP4_SUMFAC_FORMS(P, M)                                          \
  M(float, P, kCellBatch, false) M(float, P, kCellBatch, true)          \
  M(float, P, kLattice, false) M(float, P, kLattice, true)              \
  M(float, P, kLatticeUpdate, false) M(float, P, kLatticeUpdate, true)  \
  M(float, P, kLatticeUpdatePx, false)                                  \
  M(float, P, kLatticeUpdatePx, true)                                   \
  M(float, P, kLatticeUpdateBlock, false)                               \
  M(float, P, kLatticeUpdateBlock, true)                                \
  M(double, P, kCellBatch, false) M(double, P, kCellBatch, true)        \
  M(double, P, kLattice, false) M(double, P, kLattice, true)            \
  M(double, P, kLatticeUpdate, false) M(double, P, kLatticeUpdate, true) \
  M(double, P, kLatticeUpdatePx, false)                                 \
  M(double, P, kLatticeUpdatePx, true)                                  \
  M(double, P, kLatticeUpdateBlock, false)                              \
  M(double, P, kLatticeUpdateBlock, true)
#define BP4_SUMFAC_DECLARE(P) BP4_SUMFAC_FORMS(P, BP4_SUMFAC_FORM_DECLARE)
// the definitions of degree P's forms, in its own source
#define BP4_SUMFAC_DEGREE(P) BP4_SUMFAC_FORMS(P, BP4_SUMFAC_FORM_DEFINE)

BP4_SUMFAC_DECLARE(5)
BP4_SUMFAC_DECLARE(6)
BP4_SUMFAC_DECLARE(7)
BP4_SUMFAC_DECLARE(8)
BP4_SUMFAC_DECLARE(9)
BP4_SUMFAC_DECLARE(10)
BP4_SUMFAC_DECLARE(11)

// The storage instantiations (SB) in sumfac_sb.cu at every degree, f32:
// the bf16 state in every form and metric source but B2's P/x one, and
// with it the bf16 metric where the metric is streamed, but in B2's block
// form (no distributed path streams a bf16 metric).
#define BP4_SUMFAC_SB_DECLARE1(T, P, FORM, REBUILD, SB) \
  template <>                                           \
  cudaError_t launch_sumfac<T, P, FORM, REBUILD, SB>(   \
      const SumfacArgs<T>& a, const Grid& gr, cudaStream_t st);
#define BP4_SUMFAC_SB_DEFINE1(T, P, FORM, REBUILD, SB)            \
  template <>                                                     \
  cudaError_t launch_sumfac<T, P, FORM, REBUILD, SB>(             \
      const SumfacArgs<T>& a, const Grid& gr, cudaStream_t st) {  \
    return launch_sumfac_here<T, P, FORM, REBUILD, SB>(a, gr, st); \
  }
#define BP4_SUMFAC_SB_FORMS(P, M)                                        \
  M(float, P, kCellBatch, false, 4) M(float, P, kCellBatch, true, 4)     \
  M(float, P, kLattice, false, 4) M(float, P, kLattice, true, 4)         \
  M(float, P, kLatticeUpdate, false, 4)                                  \
  M(float, P, kLatticeUpdate, true, 4)                                   \
  M(float, P, kLatticeUpdateBlock, false, 4)                             \
  M(float, P, kLatticeUpdateBlock, true, 4)                              \
  M(float, P, kCellBatch, false, 12) M(float, P, kLattice, false, 12)    \
  M(float, P, kLatticeUpdate, false, 12)
static_assert(kSbState == 4 && kSbMetric == 8, "BP4_SUMFAC_SB_FORMS");
BP4_SUMFAC_SB_FORMS(1, BP4_SUMFAC_SB_DECLARE1)
BP4_SUMFAC_SB_FORMS(2, BP4_SUMFAC_SB_DECLARE1)
BP4_SUMFAC_SB_FORMS(3, BP4_SUMFAC_SB_DECLARE1)
BP4_SUMFAC_SB_FORMS(4, BP4_SUMFAC_SB_DECLARE1)
BP4_SUMFAC_SB_FORMS(5, BP4_SUMFAC_SB_DECLARE1)
BP4_SUMFAC_SB_FORMS(6, BP4_SUMFAC_SB_DECLARE1)
BP4_SUMFAC_SB_FORMS(7, BP4_SUMFAC_SB_DECLARE1)
BP4_SUMFAC_SB_FORMS(8, BP4_SUMFAC_SB_DECLARE1)
BP4_SUMFAC_SB_FORMS(9, BP4_SUMFAC_SB_DECLARE1)
BP4_SUMFAC_SB_FORMS(10, BP4_SUMFAC_SB_DECLARE1)
BP4_SUMFAC_SB_FORMS(11, BP4_SUMFAC_SB_DECLARE1)

}  // namespace bp4
