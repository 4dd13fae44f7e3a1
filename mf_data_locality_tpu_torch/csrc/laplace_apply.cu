// The apply family of the BP4 operator for Hopper (sm_90a): v = sum_e
// M_e^T G_ef M_f u per cell, on cell batches (B3, B4) and on the lattice
// (B5, B6), and its C interface.
//
// Replace the TPU kernels of mf_data_locality_tpu/ops/laplace_pallas.py:
//   B3  apply_local_batched, precomputed metric -> _kernel_g   (pallas_call :1023)
//   B4  apply_local_batched, metric on the fly  -> _kernel     (pallas_call :1043)
//   B5  apply_lattice_pieces -> _kernel_g_pieces                (pallas_call :947)
//   B6  apply_lattice_zslab  -> _kernel_g_zslab                 (pallas_call :664)
//
// Which cell pass runs (precision: laplace_pallas._mm):
//   B3, B5, B6  "highest", f32 or f64: the sum-factorized pass on the CUDA
//               cores, apply_sumfac.cuh;
//               f32 "split2m": the tensor-core pass, apply_mma.cuh;
//   B4          every rung, exact at the working type as _kernel
//               (Precision.HIGHEST, :529): apply_kernel below, the dense
//               form with the metric rebuilt per q-point.
// B5 and B6 write masked cell-local values to scratch; the assemble pass
// (bp4_operator.cuh) then sums each node's <= 8 contributions in a fixed
// order (no atomics).  The TPU kernels walk z-cell layers in order carrying
// the shared z plane in VMEM; the assemble pass takes the carry's place, so
// blocks run in any order.
//
// What one block of apply_kernel (B4) computes, for BC consecutive cells (8
// in f32: one 32-byte sector of every coefficient row; 4 in f64), Q3 = q^3
// q-points, P13 = (p+1)^3 nodes, R = 3 Q3 gradient rows:
//
//   input     u[c][k] per cell from the cell batch (C P13, n_cells)
//   metric    rebuilt from the 24 trilinear coefficients (onthefly_metric)
//   forward   g[r] = sum_k M[r][k] u[k]          one thread per q-point
//   apply     t = G [gx, gy, gz]
//   backward  v[j] = sum_r M[r][j] t[r]          one thread per (node, comp)
//
// Bound of apply_kernel on the H100 (p=4, s=13, 8192 cells): 2 R P13 C =
// 4.9e5 FMAs per cell plus the rebuild, 4.0e9 per apply, against 24
// coefficient + 2 x 375 u/v words per cell; at the CUDA cores' ~3.3e13
// FMA/s the arithmetic needs >= 0.12 ms and the bytes ~0.01 ms, so the
// kernel is bound by its FMAs and the shared-memory and L2 reads that feed
// them (M, 324 KB in f32, is read from L2 by every block).  The
// sum-factorized form (apply_sumfac.cuh) would cut that work ~10x; B4 has
// not moved to it yet.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() (0 on success),
// or -1 for a configuration with no instantiation.

#include <type_traits>

#include "apply_mma.cuh"
#include "apply_sumfac.cuh"
#include "bp4_operator.cuh"

namespace bp4 {

constexpr int kApplyThreads = 256;

template <typename T>
struct ApplyCells {
  static constexpr int N = 8;
};
template <>
struct ApplyCells<double> {
  static constexpr int N = 4;
};

// Read-only tables of B4, device pointers at the working type.
template <typename T>
struct ApplyTables {
  const T* mats;    // (R, P13): [M_x; M_y; M_z], rows (dir, qz, qy, qx)
  const T* kmats;   // (P13, R): the same, transposed
  const T* pds;     // (Q3, 24)
  const T* w3;      // (Q3,)
  const T* coeffs;  // (n_cells, 24)
};

template <typename T, int P>
struct ApplySmem {
  using S = Shape<P>;
  static constexpr int BC = ApplyCells<T>::N;
  T u[S::P13][kComps][BC];     // input, (node, comp, cell)
  T t[kComps][3 * S::Q3][BC];  // metric-applied gradients
  T g6[6 * S::Q3][BC];         // rebuilt metric
};

template <typename T, int P>
__global__ void __launch_bounds__(kApplyThreads)
    apply_kernel(ApplyTables<T> tb, int nc, const T* __restrict__ u,
                 T* __restrict__ out) {
  using S = Shape<P>;
  using Sm = ApplySmem<T, P>;
  constexpr int BC = Sm::BC, Q3 = S::Q3, P13 = S::P13;
  constexpr int R = 3 * Q3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int cell0 = blockIdx.x * BC;
  const int tid = threadIdx.x;

  // input; cells past the end are zero
  for (int i = tid; i < kComps * P13 * BC; i += blockDim.x) {
    const int b = i % BC, k = (i / BC) % P13, c = i / (BC * P13);
    const int cell = cell0 + b;
    sm.u[k][c][b] =
        cell < nc ? u[static_cast<size_t>(c * P13 + k) * nc + cell] : T(0);
  }
  for (int i = tid; i < Q3 * BC; i += blockDim.x) {
    const int b = i % BC, qp = i / BC;
    const int cell = min(cell0 + b, nc - 1);  // tail: results not stored
    T g[6];
    onthefly_metric(tb.pds + qp * 24, tb.coeffs + cell * 24, tb.w3[qp], g);
#pragma unroll
    for (int e = 0; e < 6; ++e) sm.g6[e * Q3 + qp][b] = g[e];
  }
  __syncthreads();

  // forward contraction and metric apply: one thread per q-point
  for (int qp = tid; qp < Q3; qp += blockDim.x) {
    T acc[3][kComps][BC];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int c = 0; c < kComps; ++c)
#pragma unroll
        for (int b = 0; b < BC; ++b) acc[d][c][b] = T(0);
#pragma unroll 5
    for (int k = 0; k < P13; ++k) {
      const T* mk = tb.kmats + k * R + qp;
      const T m[3] = {mk[0], mk[Q3], mk[2 * Q3]};
#pragma unroll
      for (int c = 0; c < kComps; ++c)
#pragma unroll
        for (int b = 0; b < BC; ++b) {
          const T uv = sm.u[k][c][b];
#pragma unroll
          for (int d = 0; d < 3; ++d) acc[d][c][b] = fma(m[d], uv, acc[d][c][b]);
        }
    }
#pragma unroll
    for (int b = 0; b < BC; ++b) {
      T G[6];
#pragma unroll
      for (int e = 0; e < 6; ++e) G[e] = sm.g6[e * Q3 + qp][b];
#pragma unroll
      for (int c = 0; c < kComps; ++c) {
        const T gx = acc[0][c][b], gy = acc[1][c][b], gz = acc[2][c][b];
        sm.t[c][qp][b] = G[0] * gx + G[1] * gy + G[2] * gz;
        sm.t[c][Q3 + qp][b] = G[1] * gx + G[3] * gy + G[4] * gz;
        sm.t[c][2 * Q3 + qp][b] = G[2] * gx + G[4] * gy + G[5] * gz;
      }
    }
  }
  __syncthreads();

  // transposed contraction: one thread per (node, component)
  for (int w = tid; w < kComps * P13; w += blockDim.x) {
    const int j = w % P13, c = w / P13;
    T acc[BC];
#pragma unroll
    for (int b = 0; b < BC; ++b) acc[b] = T(0);
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const T m = tb.mats[r * P13 + j];
#pragma unroll
      for (int b = 0; b < BC; ++b) acc[b] = fma(m, sm.t[c][r][b], acc[b]);
    }
#pragma unroll
    for (int b = 0; b < BC; ++b) {
      const int cell = cell0 + b;
      if (cell >= nc) break;
      out[static_cast<size_t>(c * P13 + j) * nc + cell] = acc[b];
    }
  }
}

template <typename T, int P>
cudaError_t launch_onthefly(const void* mats, const void* kmats,
                            const void* pds, const void* w3,
                            const void* coeffs, const void* u, void* out,
                            int nc, cudaStream_t st) {
  using Sm = ApplySmem<T, P>;
  auto kern = apply_kernel<T, P>;
  // above 48 KB a block's shared memory must be requested explicitly
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Sm));
  if (attr != cudaSuccess) return attr;
  const ApplyTables<T> tb{
      static_cast<const T*>(mats), static_cast<const T*>(kmats),
      static_cast<const T*>(pds), static_cast<const T*>(w3),
      static_cast<const T*>(coeffs)};
  kern<<<(nc + Sm::BC - 1) / Sm::BC, kApplyThreads, sizeof(Sm), st>>>(
      tb, nc, static_cast<const T*>(u), static_cast<T*>(out));
  return cudaGetLastError();
}

// The cell pass of B3, B5 and B6 (streamed metric): under split (f32 only)
// the tensor-core pass, whose m0/m1 are apply_mma.cuh's bf16 fragment
// tables; else the sum-factorized pass, whose m0/m1 are S and D (Q, P1).
template <typename T, int P, bool LATTICE>
cudaError_t metric_pass(int split, const void* m0, const void* m1,
                        const void* gmetric, const Grid& gr, const void* mask,
                        const void* u, void* out, cudaStream_t st) {
  const auto gm = static_cast<const T*>(gmetric);
  const auto mm = static_cast<const T*>(mask);
  const auto uu = static_cast<const T*>(u);
  const auto oo = static_cast<T*>(out);
  if (!split)
    return launch_sumfac<T, P, LATTICE>(static_cast<const T*>(m0),
                                        static_cast<const T*>(m1), gm, gr, mm,
                                        uu, oo, st);
  if constexpr (std::is_same_v<T, float>)
    return launch_mma<P, LATTICE>(m0, m1, gm, gr, mm, uu, oo, st);
  return static_cast<cudaError_t>(-1);
}

// B3 (metric streamed) and B4 (onthefly) on a cell batch (C P13, n_cells).
// mats/kmats: B4's M and M^T; B3's tables of metric_pass.
template <int P>
int batched_for_degree(int dtype, int split, int onthefly, const void* mats,
                       const void* kmats, const void* gmetric, const void* pds,
                       const void* w3, const void* coeffs, const void* u,
                       void* v, int n_cells, cudaStream_t st) {
  const Grid gr{1, 1, n_cells, 1, 1, 1};
  if (dtype == 0)
    return onthefly  // B4 is exact on every rung
               ? launch_onthefly<float, P>(mats, kmats, pds, w3, coeffs, u, v,
                                           n_cells, st)
               : metric_pass<float, P, false>(split, mats, kmats, gmetric, gr,
                                              nullptr, u, v, st);
  if (dtype == 1)
    return onthefly
               ? launch_onthefly<double, P>(mats, kmats, pds, w3, coeffs, u,
                                            v, n_cells, st)
               : metric_pass<double, P, false>(split, mats, kmats, gmetric,
                                               gr, nullptr, u, v, st);
  return -1;
}

// B5 (mask null: the box's Dirichlet mask from the indices) and B6 (mask
// tensor) on the lattice: the cell pass into the scratch `cells`, then the
// assemble pass.  mats/kmats: the tables of metric_pass.
template <typename T, int P>
int lattice_typed(int split, const void* mats, const void* kmats,
                  const void* gmetric, const void* mask, const void* u,
                  void* cells, void* v, const Grid& gr, cudaStream_t st) {
  const cudaError_t e = metric_pass<T, P, true>(split, mats, kmats, gmetric,
                                                gr, mask, u, cells, st);
  if (e != cudaSuccess) return e;
  assemble_kernel<T, P, false><<<node_blocks(gr), kNodeThreads, 0, st>>>(
      gr, static_cast<const T*>(cells), static_cast<T*>(v), nullptr, nullptr,
      nullptr, nullptr);
  return cudaGetLastError();
}

template <int P>
int lattice_for_degree(int dtype, int split, const void* mats,
                       const void* kmats, const void* gmetric,
                       const void* mask, const void* u, void* cells, void* v,
                       const Grid& gr, cudaStream_t st) {
  if (dtype == 0)
    return lattice_typed<float, P>(split, mats, kmats, gmetric, mask, u,
                                   cells, v, gr, st);
  if (dtype == 1)
    return lattice_typed<double, P>(split, mats, kmats, gmetric, mask, u,
                                    cells, v, gr, st);
  return -1;
}

}  // namespace bp4

// dtype: 0 = float32, 1 = float64.  Instantiated: degrees 1..4; "highest"
// f32 and f64 (B3, B5, B6: the sum-factorized pass, mats = S, kmats = D),
// f32 split2m (B3, B5, B6: the tensor-core pass, mats/kmats = its fragment
// tables); B4 (onthefly, mats = M, kmats = M^T) ignores split.
extern "C" {

int bp4_apply_batched(int dtype, int split, int degree, int onthefly,
                      const void* mats, const void* kmats, const void* gmetric,
                      const void* pds, const void* w3, const void* coeffs,
                      const void* u, void* v, int n_cells, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define BP4_BATCHED(P)                                                       \
  bp4::batched_for_degree<P>(dtype, split, onthefly, mats, kmats, gmetric,   \
                             pds, w3, coeffs, u, v, n_cells, st)
  switch (degree) {
    case 1: return BP4_BATCHED(1);
    case 2: return BP4_BATCHED(2);
    case 3: return BP4_BATCHED(3);
    case 4: return BP4_BATCHED(4);
  }
#undef BP4_BATCHED
  return -1;
}

int bp4_apply_lattice(int dtype, int split, int degree, const void* mats,
                      const void* kmats, const void* gmetric, const void* mask,
                      const void* u, void* cells, void* v, int ncz, int ncy,
                      int ncx, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const bp4::Grid gr{ncz, ncy, ncx, degree * ncz + 1, degree * ncy + 1,
                     degree * ncx + 1};
#define BP4_LATTICE(P)                                                       \
  bp4::lattice_for_degree<P>(dtype, split, mats, kmats, gmetric, mask, u,    \
                             cells, v, gr, st)
  switch (degree) {
    case 1: return BP4_LATTICE(1);
    case 2: return BP4_LATTICE(2);
    case 3: return BP4_LATTICE(3);
    case 4: return BP4_LATTICE(4);
  }
#undef BP4_LATTICE
  return -1;
}

}  // extern "C"
