// The "highest" cell pass of the precomputed-metric apply on Hopper's CUDA
// cores (sm_90a), f32 or f64: v = sum_e M_e^T G_ef M_f u per cell, by sum
// factorization, on cell batches (B3) and on the lattice (B5, B6; the
// assemble pass follows in laplace_apply.cu).
//
// Replaces, under precision "highest" (f32 and f64), the TPU kernels of
// mf_data_locality_tpu/ops/laplace_pallas.py:
//   B3  _kernel_g          :479  (pallas_call :1023)
//   B6  _kernel_g_zslab    :576  (pallas_call :664)
//   B5  _kernel_g_pieces   :845  (pallas_call :947)
// The f32 "split2m" rung runs on the tensor cores (apply_mma.cuh): its
// rounding of the dense entries defines that function, and a factorized
// form does not reproduce it.
//
// The TPU kernels multiply by the dense gradient matrices M_x = S (x) S (x) D,
// M_y = S (x) D (x) S, M_z = D (x) S (x) S ((z, y, x) order; S, D the (Q,
// P1) values and derivatives of the 1D basis at the Gauss points), because
// contractions of depth P1 waste the MXU (laplace_pallas.py:15-20).  Exact
// f32 or f64 on this card runs on the CUDA cores, where the FMA count is
// what binds, so this pass applies the 1D factors instead (p=4: ~5.0e4 FMAs
// a cell against the dense form's 4.9e5):
//
//   forward   x pass   xs, xd     = S_x u, D_x u             (kz, ky, qx)
//             y pass   uss, uds, usd = S_y xs, D_y xs, S_y xd (kz, qy, qx)
//             z pass   gx, gy, gz = S_z usd, S_z uds, D_z uss (qz, qy, qx)
//   apply     t = G [gx, gy, gz], the 6 streamed entries of the symmetric G
//   backward  the transposes in reverse order: z, then y, then x
//
// Layout: one block is BC cells (8 f32, 4 f64: one 32-byte sector of every
// streamed row) times the Q^2 (qy, qx) columns of a cell, the cell the
// fastest thread index, so the metric, the batched u and v are read and
// written a full sector per 8 (4) threads.  A thread owns one column and
// carries the z direction in registers ("2D threads, z in registers", as in
// GPU sum-factorization kernels); the x and y passes exchange through
// shared planes.  The forward z pass, the metric apply and the backward z
// pass are fused per qz, so gx, gy, gz never leave registers.  The block's
// metric (6 Q^3 BC words) is read once into shared memory and serves the
// three components; S and D (2 Q P1 words) sit in shared memory too.
//
// Lattice form (B5, B6): u is gathered by cell_node with the mask (B5 from
// the indices, B6 from the mask tensor), as apply_kernel did; with the cell
// the fastest index, a warp's gather reads P-strided nodes that neighbouring
// threads complete, so it touches about one sector per 8 words.  The masked
// cell-local result is staged in shared memory and stored as one contiguous
// run of BC P13 words a component, then the fixed-order assemble pass
// (bp4_operator.cuh) sums each node: no atomics, two calls bitwise equal.
//
// Bound (p=4, s=13, 8192 cells): 50,472 FMAs a cell (per component forward
// 1,500 + 2,700 + 3,240, the same backward, x3, plus 27 Q^3 for the metric
// apply), 4.1e8 FMAs, 12.3 us at the 67 TFLOP/s f32 peak; the bytes, the
// metric (6 Q^3 words a cell) plus u and v, 67 MB in f32, 20.0 us at 3.35
// TB/s.  So it is bound by bytes in f32 and f64 (40 us; 24 us of FP64
// FMAs).  The measured time and what holds it are in PERF.md.

#pragma once

#include <cuda_pipeline.h>

#include "bp4_operator.cuh"

namespace bp4 {

template <typename T>
struct SumfacCells {
  static constexpr int N = 8;
};
template <>
struct SumfacCells<double> {
  static constexpr int N = 4;
};

template <typename T, int P>
struct SumfacSmem {
  using S = Shape<P>;
  static constexpr int BC = SumfacCells<T>::N;
  static constexpr int kThreads = S::Q2 * BC;
  T g[6][S::Q3][BC];               // the block's metric, entries 00 .. 22
  T x[2][S::P1][S::P1][S::Q][BC];  // x-direction partials (S, D): (kz, ky, qx)
  T w[3][S::P1][S::Q2][BC];        // backward z pass: (kz, qy qx); lattice
                                   // form: then the output, (cell, node)
  T u[S::P13][BC];                 // one component's input
  T sz[S::Q * S::P1];              // S (Q, P1)
  T dz[S::Q * S::P1];              // D (Q, P1)
  // input elements a thread loads for one component
  static constexpr int PER = (S::P13 * BC + kThreads - 1) / kThreads;
};

// One component's input elements of this thread, i = tid + j kThreads =
// node k BC + cell: the values and (lattice) their mask, multiplied at the
// store into shared memory.  The cell-batch form loads the next
// component's input ahead, so that the loads' latency overlaps the passes
// between; the lattice form loads it just before the store, because its
// values and masks held across the passes spill under the three blocks an
// SM and ran slower (PERF.md).
template <typename T, int P, bool LATTICE>
struct SumfacInput {
  using Sm = SumfacSmem<T, P>;
  T v[Sm::PER];
  T m[LATTICE ? Sm::PER : 1];

  __device__ __forceinline__ void load(const Grid& gr, const T* mask,
                                       const T* u, int c, int cell0,
                                       int nlive) {
    constexpr int BC = Sm::BC, P13 = Shape<P>::P13;
    const int nc = gr.n_cells();
#pragma unroll
    for (int j = 0; j < Sm::PER; ++j) {
      const int i = threadIdx.x + j * Sm::kThreads, bb = i % BC, k = i / BC;
      const bool live = i < P13 * BC && bb < nlive;  // past the end: zeros
      v[j] = T(0);
      if constexpr (LATTICE) {
        m[j] = T(0);
        if (live) {
          const size_t node = cell_node<P>(gr, cell0 + bb, k, mask, &m[j]);
          v[j] = u[c * static_cast<size_t>(gr.n_nodes()) + node];
        }
      } else if (live) {
        v[j] = u[static_cast<size_t>(c * P13 + k) * nc + cell0 + bb];
      }
    }
  }

  __device__ __forceinline__ void store(Sm& sm) const {
#pragma unroll
    for (int j = 0; j < Sm::PER; ++j) {
      const int i = threadIdx.x + j * Sm::kThreads;
      if (i < Shape<P>::P13 * Sm::BC)
        (&sm.u[0][0])[i] = LATTICE ? v[j] * m[j] : v[j];
    }
  }
};

// LATTICE false (B3): u and out are cell batches (C P13, n_cells); true (B5,
// B6): u is the lattice, gathered times the mask, and out the masked
// cell-local values (C, n_cells, P13).  Three blocks an SM (72.6 KB of
// shared memory each at p=4) cap a thread at 72 registers in f32.
template <typename T, int P, bool LATTICE>
__global__ void __launch_bounds__(SumfacSmem<T, P>::kThreads, 3)
    apply_sumfac_kernel(const T* __restrict__ sz, const T* __restrict__ dz,
                        const T* __restrict__ gmetric, Grid gr,
                        const T* __restrict__ mask, const T* __restrict__ u,
                        T* __restrict__ out) {
  using S = Shape<P>;
  using Sm = SumfacSmem<T, P>;
  constexpr int BC = Sm::BC, NT = Sm::kThreads;
  constexpr int P1 = S::P1, Q = S::Q, Q2 = S::Q2, Q3 = S::Q3, P13 = S::P13;
  constexpr bool kAhead = !LATTICE;  // next component's input (SumfacInput)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int nc = gr.n_cells();
  const int cell0 = blockIdx.x * BC;
  const int nlive = min(BC, nc - cell0);  // cells past the end: zeros
  const int tid = threadIdx.x;
  const int b = tid % BC, col = tid / BC;

  for (int i = tid; i < Q * P1; i += NT) {
    sm.sz[i] = sz[i];
    sm.dz[i] = dz[i];
  }
  // the block's metric, copied asynchronously (cp.async) while component
  // 0's input arrives and its x pass runs; cells past the end zero-filled
  for (int i = tid; i < 6 * Q3 * BC; i += NT) {
    const int bb = i % BC;
    __pipeline_memcpy_async(
        &sm.g[0][0][0] + i,
        gmetric + static_cast<size_t>(i / BC) * nc + cell0 + min(bb, nlive - 1),
        sizeof(T), bb < nlive ? 0 : sizeof(T));
  }
  __pipeline_commit();
  SumfacInput<T, P, LATTICE> in;
  in.load(gr, mask, u, 0, cell0, nlive);
  in.store(sm);

  for (int c = 0; c < kComps; ++c) {
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
    if (c == 0) __pipeline_wait_prior(0);  // this thread's metric copies
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
    if (kAhead && c + 1 < kComps) in.load(gr, mask, u, c + 1, cell0, nlive);
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
    T* stage = &sm.w[0][0][0][0];  // lattice form: (cell, node)
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
        if constexpr (LATTICE) {
          T m = T(0);
          if (b < nlive) cell_node<P>(gr, cell0 + b, k, mask, &m);
          stage[b * P13 + k] = v * m;
        } else if (b < nlive) {
          out[static_cast<size_t>(c * P13 + k) * nc + cell0 + b] = v;
        }
      }
    }
    if constexpr (LATTICE) {
      __syncthreads();
      T* dst = out + (static_cast<size_t>(c) * nc + cell0) * P13;
      for (int i = tid; i < nlive * P13; i += NT) dst[i] = stage[i];
    }
    if (c + 1 < kComps) {  // sm.u was last read by the x pass
      if (!kAhead) in.load(gr, mask, u, c + 1, cell0, nlive);
      in.store(sm);
    }
  }
}

template <typename T, int P, bool LATTICE>
cudaError_t launch_sumfac(const T* sz, const T* dz, const T* gmetric,
                          const Grid& gr, const T* mask, const T* u, T* out,
                          cudaStream_t st) {
  using Sm = SumfacSmem<T, P>;
  auto kern = apply_sumfac_kernel<T, P, LATTICE>;
  // above 48 KB a block's shared memory must be requested explicitly
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Sm));
  if (attr != cudaSuccess) return attr;
  const int blocks = (gr.n_cells() + Sm::BC - 1) / Sm::BC;
  kern<<<blocks, Sm::kThreads, sizeof(Sm), st>>>(sz, dz, gmetric, gr, mask, u,
                                                 out);
  return cudaGetLastError();
}

}  // namespace bp4
