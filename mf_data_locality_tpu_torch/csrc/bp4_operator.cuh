// BP4 cell operator for Hopper (sm_90a): the shared core of the matvec
// (B1) and fused CG iteration (B2) kernels in cg_fused.cu.
//
// What it computes, per hex cell of the lattice (C = 3 components, degree P,
// Q = P + 2 Gauss points per direction), on the cell's (P+1)^3 node values u:
//
//   z stage     uS[qz] = sum_kz Sz[qz,kz] u[kz],  uD[qz] = sum_kz Dz[qz,kz] u[kz]
//   2D stage    gx, gy = [Dx2d; Dy2d] uS[qz],     gz = S2d uD[qz]
//   metric      J = pds . c24 (trilinear Jacobian), adj = det(J) J^-1,
//               G = w3 adj adj^T / det            (adjugate chain, "adjj")
//   apply       t = G [gx, gy, gz]
//   backward    w1 = [Dx2d; Dy2d]^T [t0; t1],     w2 = S2d^T t2
//               v[kz] = sum_qz Sz[qz,kz] w1[qz] + Dz[qz,kz] w2[qz]
//   mask        v = 0 at Dirichlet nodes
//
// This is the arithmetic of the TPU kernel's _operator_block twostage branch
// with _metric_onthefly's adjj chain (mf_data_locality_tpu/ops/
// cg_fused_kernel.py:583-651, :178-265), not its block structure: the TPU
// kernel puts cells in vector lanes and walks z-cell layers in order; here
// one thread block owns one cell and its threads walk the cell's nodes,
// q-points and planes, with every intermediate in shared memory.
//
// Precision rungs (laplace_pallas._mm, cg_fused_kernel._stream_parts):
//   SPLIT (f32 "split2m"): the 2D-stage matrices arrive rounded to bf16;
//     each streamed value b is split into bh = bf16(b), bl = bf16(b - bh)
//     and the products mh*bh + mh*bl are accumulated in f32, hi parts
//     first, as the TPU's K-stacked matmul orders them.
//   !SPLIT ("highest", f32 or f64): plain FMA at the working type.
// The z stage runs at the working type, unrounded, as on the TPU.
// The Jacobian J = pds . c24 is exact FMA at the working type.  Deliberate
// difference: the TPU kernel evaluates it under every f32 rung as a split3
// bf16 hi/lo product (cg_fused_kernel.py:208), whose intent is f32 class;
// exact f32 is that class without the emulation.
//
// Bound on the H100: one cell costs ~2.4e5 FMAs (3 components x (2D stage
// forward + backward with two stream parts) + the metric rebuild) against
// ~4.5 KB of node data, so the cell kernel is bound by the CUDA cores'
// FMA rate and shared-memory traffic, not by DRAM.  A later PR moves the
// 2D stage onto the tensor cores (wgmma / mma.sync: split2m is by
// definition bf16 x bf16 products with f32 accumulation) and stages node
// planes with TMA; PERF.md records the measured split.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bp4 {

constexpr int kComps = 3;           // vector components of BP4
constexpr int kCellThreads = 256;   // threads per cell block
constexpr int kNodeThreads = 256;   // threads per block of the node passes
constexpr int kDots = 7;            // update3b sums (cg_fused_kernel.py:891)

template <int P>
struct Shape {
  static constexpr int P1 = P + 1, Q = P + 2;
  static constexpr int P12 = P1 * P1, P13 = P12 * P1;
  static constexpr int Q2 = Q * Q, Q3 = Q2 * Q;
};

// Read-only operator tables, device pointers at the working type T.
template <typename T>
struct OpTables {
  const T* mats;    // (3 Q2, P12): [Dx2d; Dy2d; S2d], rows (qy,qx), cols (ky,kx)
  const T* sz;      // (Q, P1)
  const T* dz;      // (Q, P1)
  const T* pds;     // (Q3, 24): d(monomial k)/d(u_e) at e*8 + k
  const T* w3;      // (Q3,)
  const T* coeffs;  // (n_cells, 24): monomial coefficient k of coordinate d at d*8 + k
};

struct Grid {
  int ncz, ncy, ncx;  // cells per axis
  int nz, ny, nx;     // lattice nodes per axis
  __host__ __device__ int n_cells() const { return ncz * ncy * ncx; }
  __host__ __device__ int n_nodes() const { return nz * ny * nx; }
};

__device__ __forceinline__ bool interior(const Grid& gr, int z, int y, int x) {
  return z > 0 && z < gr.nz - 1 && y > 0 && y < gr.ny - 1 && x > 0 &&
         x < gr.nx - 1;
}

// Stream parts of one value: the value itself, or its bf16 hi/lo pair.
template <typename T, bool SPLIT>
struct Stream {
  static constexpr int N = 1;
  __device__ static void split(T v, T* parts) { parts[0] = v; }
};
template <>
struct Stream<float, true> {
  static constexpr int N = 2;
  __device__ static void split(float v, float* parts) {
    const float hi = __bfloat162float(__float2bfloat16_rn(v));
    parts[0] = hi;
    parts[1] = __bfloat162float(__float2bfloat16_rn(v - hi));
  }
};

template <typename T, int P, bool SPLIT>
struct CellSmem {
  using S = Shape<P>;
  static constexpr int NS = Stream<T, SPLIT>::N;
  static constexpr int NP = kComps * S::Q * S::P12;  // plane values, all comps
  static constexpr int NQ = kComps * S::Q3;          // q-point values, all comps
  T mats[3 * S::Q2 * S::P12];
  T sz[S::Q * S::P1];
  T dz[S::Q * S::P1];
  T c24[24];
  T u[kComps * S::P13];  // operator input at the cell's nodes
  T g6[6 * S::Q3];       // metric entries 00, 01, 02, 11, 12, 22 per q-point
  T us[NS][NP];          // z-interpolated planes (stream parts)
  T ud[NS][NP];          // z-differentiated planes
  T t[3][NS][NQ];        // metric-applied gradients (stream parts)
  T w1[NP];              // backward 2D stage
  T w2[NP];
};

// Copy the operator tables and this cell's coefficients to shared memory.
template <typename T, int P, bool SPLIT>
__device__ void load_tables(CellSmem<T, P, SPLIT>& sm, const OpTables<T>& tb,
                            int cell) {
  using S = Shape<P>;
  for (int i = threadIdx.x; i < 3 * S::Q2 * S::P12; i += blockDim.x)
    sm.mats[i] = tb.mats[i];
  for (int i = threadIdx.x; i < S::Q * S::P1; i += blockDim.x) {
    sm.sz[i] = tb.sz[i];
    sm.dz[i] = tb.dz[i];
  }
  if (threadIdx.x < 24) sm.c24[threadIdx.x] = tb.coeffs[cell * 24 + threadIdx.x];
}

// Apply the operator to sm.u (loaded and synchronised by the caller) and
// write the masked cell-local result to cells[(c * n_cells + cell) * P13 + l].
template <typename T, int P, bool SPLIT>
__device__ void cell_apply(CellSmem<T, P, SPLIT>& sm, const OpTables<T>& tb,
                           const Grid& gr, int cell, int cz, int cy, int cx,
                           T* __restrict__ cells) {
  using S = Shape<P>;
  using St = Stream<T, SPLIT>;
  constexpr int NS = St::N;
  const int tid = threadIdx.x;

  // metric at each q-point, rebuilt from the 24 coefficients
  for (int qp = tid; qp < S::Q3; qp += blockDim.x) {
    const T* pq = tb.pds + qp * 24;
    T J[3][3];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        T a = T(0);
#pragma unroll
        for (int k = 0; k < 8; ++k) a = fma(pq[e * 8 + k], sm.c24[d * 8 + k], a);
        J[d][e] = a;
      }
    const T a = J[0][0], b = J[0][1], c = J[0][2];
    const T d = J[1][0], e = J[1][1], f = J[1][2];
    const T g = J[2][0], h = J[2][1], i = J[2][2];
    const T adj[3][3] = {{e * i - f * h, c * h - b * i, b * f - c * e},
                         {f * g - d * i, a * i - c * g, c * d - a * f},
                         {d * h - e * g, b * g - a * h, a * e - b * d}};
    const T det = a * adj[0][0] + b * adj[1][0] + c * adj[2][0];
    const T scale = tb.w3[qp] / (det == T(0) ? T(1) : det);
    int r = 0;
#pragma unroll
    for (int e0 = 0; e0 < 3; ++e0)
#pragma unroll
      for (int f0 = e0; f0 < 3; ++f0, ++r)
        sm.g6[r * S::Q3 + qp] =
            (adj[e0][0] * adj[f0][0] + adj[e0][1] * adj[f0][1] +
             adj[e0][2] * adj[f0][2]) * scale;
  }

  // z stage: (c, qz, ky, kx) planes
  for (int i = tid; i < CellSmem<T, P, SPLIT>::NP; i += blockDim.x) {
    const int c = i / (S::Q * S::P12);
    const int qz = (i / S::P12) % S::Q;
    const int k2 = i % S::P12;
    const T* uc = sm.u + c * S::P13 + k2;
    T s = uc[0] * sm.sz[qz * S::P1];
    T dd = uc[0] * sm.dz[qz * S::P1];
#pragma unroll
    for (int kz = 1; kz < S::P1; ++kz) {
      s = fma(uc[kz * S::P12], sm.sz[qz * S::P1 + kz], s);
      dd = fma(uc[kz * S::P12], sm.dz[qz * S::P1 + kz], dd);
    }
    T ps[NS], pd[NS];
    St::split(s, ps);
    St::split(dd, pd);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      sm.us[n][i] = ps[n];
      sm.ud[n][i] = pd[n];
    }
  }
  __syncthreads();

  // forward 2D stage and metric apply: (c, qz, qy, qx) q-points
  for (int i = tid; i < CellSmem<T, P, SPLIT>::NQ; i += blockDim.x) {
    const int c = i / S::Q3;
    const int qp = i % S::Q3;
    const int qz = qp / S::Q2;
    const int r = qp % S::Q2;
    const T* mx = sm.mats + r * S::P12;
    const T* my = sm.mats + (S::Q2 + r) * S::P12;
    const T* mz = sm.mats + (2 * S::Q2 + r) * S::P12;
    T gx = T(0), gy = T(0), gz = T(0);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const T* bs = sm.us[n] + (c * S::Q + qz) * S::P12;
      const T* bd = sm.ud[n] + (c * S::Q + qz) * S::P12;
#pragma unroll
      for (int k = 0; k < S::P12; ++k) {
        gx = fma(mx[k], bs[k], gx);
        gy = fma(my[k], bs[k], gy);
        gz = fma(mz[k], bd[k], gz);
      }
    }
    const T* G = sm.g6 + qp;
    const T g00 = G[0], g01 = G[S::Q3], g02 = G[2 * S::Q3];
    const T g11 = G[3 * S::Q3], g12 = G[4 * S::Q3], g22 = G[5 * S::Q3];
    const T t[3] = {g00 * gx + g01 * gy + g02 * gz,
                    g01 * gx + g11 * gy + g12 * gz,
                    g02 * gx + g12 * gy + g22 * gz};
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      T parts[NS];
      St::split(t[e], parts);
#pragma unroll
      for (int n = 0; n < NS; ++n) sm.t[e][n][i] = parts[n];
    }
  }
  __syncthreads();

  // backward 2D stage: (c, qz, ky, kx) planes
  for (int i = tid; i < CellSmem<T, P, SPLIT>::NP; i += blockDim.x) {
    const int c = i / (S::Q * S::P12);
    const int qz = (i / S::P12) % S::Q;
    const int k2 = i % S::P12;
    const int q0 = c * S::Q3 + qz * S::Q2;
    T w1 = T(0), w2 = T(0);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      for (int r = 0; r < S::Q2; ++r)
        w1 = fma(sm.mats[r * S::P12 + k2], sm.t[0][n][q0 + r], w1);
      for (int r = 0; r < S::Q2; ++r)
        w1 = fma(sm.mats[(S::Q2 + r) * S::P12 + k2], sm.t[1][n][q0 + r], w1);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
      for (int r = 0; r < S::Q2; ++r)
        w2 = fma(sm.mats[(2 * S::Q2 + r) * S::P12 + k2], sm.t[2][n][q0 + r], w2);
    sm.w1[i] = w1;
    sm.w2[i] = w2;
  }
  __syncthreads();

  // backward z stage and Dirichlet mask: (c, kz, ky, kx) nodes
  const int n_cells = gr.n_cells();
  for (int i = tid; i < kComps * S::P13; i += blockDim.x) {
    const int c = i / S::P13;
    const int l = i % S::P13;
    const int kz = l / S::P12;
    const int k2 = l % S::P12;
    const T* w1 = sm.w1 + c * S::Q * S::P12 + k2;
    const T* w2 = sm.w2 + c * S::Q * S::P12 + k2;
    T a = T(0);
#pragma unroll
    for (int qz = 0; qz < S::Q; ++qz) {
      a = fma(w1[qz * S::P12], sm.sz[qz * S::P1 + kz], a);
      a = fma(w2[qz * S::P12], sm.dz[qz * S::P1 + kz], a);
    }
    const int z = cz * P + kz, y = cy * P + k2 / S::P1, x = cx * P + k2 % S::P1;
    cells[(static_cast<size_t>(c) * n_cells + cell) * S::P13 + l] =
        interior(gr, z, y, x) ? a : T(0);
  }
}

// The cells sharing lattice coordinate `z` along one axis with nc cells:
// fills (cell index, local node index) pairs in ascending cell order and
// returns their count (1 or 2).
template <int P>
__device__ __forceinline__ int axis_cells(int z, int nc, int* cs, int* ks) {
  const int c = z / P, k = z % P;
  if (k == 0 && c > 0) {
    cs[0] = c - 1;
    ks[0] = P;
    if (c < nc) {
      cs[1] = c;
      ks[1] = 0;
      return 2;
    }
    return 1;
  }
  cs[0] = c;
  ks[0] = k;
  return 1;
}

// Sum a node's cell contributions in a fixed order (deterministic, no atomics).
template <typename T, int P>
__device__ __forceinline__ T gather_node(const T* __restrict__ cells,
                                         const Grid& gr, int c, int z, int y,
                                         int x) {
  using S = Shape<P>;
  int zc[2], zk[2], yc[2], yk[2], xc[2], xk[2];
  const int nzc = axis_cells<P>(z, gr.ncz, zc, zk);
  const int nyc = axis_cells<P>(y, gr.ncy, yc, yk);
  const int nxc = axis_cells<P>(x, gr.ncx, xc, xk);
  const size_t base = static_cast<size_t>(c) * gr.n_cells();
  T s = T(0);
  for (int a = 0; a < nzc; ++a)
    for (int b = 0; b < nyc; ++b)
      for (int e = 0; e < nxc; ++e) {
        const int cell = (zc[a] * gr.ncy + yc[b]) * gr.ncx + xc[e];
        const int l = (zk[a] * S::P1 + yk[b]) * S::P1 + xk[e];
        s += cells[(base + cell) * S::P13 + l];
      }
  return s;
}

// Fixed-order tree sum of `kDots` values over the block (blockDim.x ==
// kNodeThreads); the result is valid in red[k][0].
template <typename T>
__device__ void block_sum(T (*red)[kNodeThreads], const T* v) {
  for (int k = 0; k < kDots; ++k) red[k][threadIdx.x] = v[k];
  __syncthreads();
  for (int s = kNodeThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      for (int k = 0; k < kDots; ++k) red[k][threadIdx.x] += red[k][threadIdx.x + s];
    __syncthreads();
  }
}

}  // namespace bp4
