// The apply family of the BP4 operator for Hopper (sm_90a): the dense
// factorization v = sum_e M_e^T G_ef M_f u per cell, on cell batches (B3, B4)
// and on the lattice (B5, B6).
//
// Replace the TPU kernels of mf_data_locality_tpu/ops/laplace_pallas.py:
//   B3  apply_local_batched, precomputed metric -> _kernel_g   (pallas_call :1023)
//   B4  apply_local_batched, metric on the fly  -> _kernel     (pallas_call :1043)
//   B5  apply_lattice_pieces -> _kernel_g_pieces                (pallas_call :947)
//   B6  apply_lattice_zslab  -> _kernel_g_zslab                 (pallas_call :664)
//
// What one block computes, for BC consecutive cells (8 in f32: one 32-byte
// sector of every streamed metric row; 4 in f64), Q3 = q^3 q-points, P13 =
// (p+1)^3 nodes, R = 3 Q3 gradient rows:
//
//   input     u[c][k] per cell: B3/B4 from the cell batch (C P13, n_cells);
//             B5/B6 from the lattice by index, times the Dirichlet mask
//             (B5: computed from the indices, B6: read from the mask tensor)
//   metric    B3/B5/B6 stream the 6 entries G[e Q3 + qp][cell]; B4 rebuilds
//             them from the 24 trilinear coefficients (onthefly_metric)
//   forward   g[r] = sum_k M[r][k] u[k]          one thread per q-point
//   apply     t = G [gx, gy, gz]
//   backward  v[j] = sum_r M[r][j] t[r]          one thread per (node, comp)
//   output    B3/B4: the cell batch; B5/B6: the masked cell-local values to
//             scratch, then the assemble pass (bp4_operator.cuh) sums each
//             node's <= 8 contributions in a fixed order (no atomics)
//
// The TPU kernels put cells in vector lanes and, for B5/B6, walk z-cell
// layers in order carrying the shared z plane in VMEM; here the assemble pass
// takes the carry's place, so blocks run in any order.
//
// Precision (laplace_pallas._mm): "highest" is plain FMA at the working type.
// SPLIT (f32 "split2m"): M rounded to bf16 at the product (it is held
// unrounded), the streamed operand (u forward, t backward) split into bf16
// hi and lo parts, f32 accumulation, hi products first.  B4 is exact at the
// working type on every rung, as _kernel (Precision.HIGHEST, :529).
//
// Bound on the H100 (p=4, s=13, 8192 cells): 2 R P13 C = 4.9e5 FMAs per cell
// in f32 highest (twice that under SPLIT), 4.0e9 per apply, against 1296
// metric words + 2 x 375 u/v words per cell (~67 MB per apply in f32).  At
// the CUDA cores' ~3.3e13 FMA/s the arithmetic needs >= 0.12 ms and the
// bytes ~0.02 ms, so the kernel is bound by its FMAs and the shared-memory
// and L2 reads that feed them (M, 324 KB in f32, is read from L2 by every
// block).  The dense form is the TPU's MXU choice; later PRs move it onto
// the tensor cores or sum-factorize it (PERF.md).
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() (0 on success),
// or -1 for a configuration with no instantiation.

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

// Read-only tables of the apply family, device pointers at the working type.
template <typename T>
struct ApplyTables {
  const T* mats;     // (R, P13): [M_x; M_y; M_z], rows (dir, qz, qy, qx)
  const T* kmats;    // (P13, R): the same, transposed
  const T* gmetric;  // (6 Q3, n_cells), or null for the on-the-fly metric
  const T* pds;      // (Q3, 24)
  const T* w3;       // (Q3,)
  const T* coeffs;   // (n_cells, 24)
};

template <typename T, int P, bool SPLIT, bool ONTHEFLY>
struct ApplySmem {
  using S = Shape<P>;
  static constexpr int BC = ApplyCells<T>::N;
  static constexpr int NS = Stream<T, SPLIT>::N;
  T u[NS][S::P13][kComps][BC];     // input stream parts, (node, comp, cell)
  T t[NS][kComps][3 * S::Q3][BC];  // metric-applied gradients, stream parts
  T g6[ONTHEFLY ? 6 * S::Q3 : 1][BC];  // rebuilt metric (B4)
};

template <typename T, bool SPLIT>
__device__ __forceinline__ T matrix_value(T m) {
  if constexpr (SPLIT) {
    return __bfloat162float(__float2bfloat16_rn(m));
  } else {
    return m;
  }
}

// The lattice node of local node k of a cell, and its mask value: the mask
// tensor's where one is given (B6), else the box's Dirichlet mask from the
// indices (B5).
template <int P, typename T>
__device__ __forceinline__ size_t cell_node(const Grid& gr, int cell, int k,
                                            const T* mask, T* m) {
  using S = Shape<P>;
  const int cx = cell % gr.ncx, cy = (cell / gr.ncx) % gr.ncy,
            cz = cell / (gr.ncx * gr.ncy);
  const int z = cz * P + k / S::P12, y = cy * P + (k / S::P1) % S::P1,
            x = cx * P + k % S::P1;
  const size_t node = (static_cast<size_t>(z) * gr.ny + y) * gr.nx + x;
  *m = mask ? mask[node] : (interior(gr, z, y, x) ? T(1) : T(0));
  return node;
}

template <typename T, int P, bool SPLIT, bool ONTHEFLY, bool LATTICE>
__global__ void __launch_bounds__(kApplyThreads)
    apply_kernel(ApplyTables<T> tb, Grid gr, const T* __restrict__ mask,
                 const T* __restrict__ u, T* __restrict__ out) {
  using S = Shape<P>;
  using Sm = ApplySmem<T, P, SPLIT, ONTHEFLY>;
  using St = Stream<T, SPLIT>;
  constexpr int BC = Sm::BC, NS = Sm::NS, Q3 = S::Q3, P13 = S::P13;
  constexpr int R = 3 * Q3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int nc = gr.n_cells();
  const int cell0 = blockIdx.x * BC;
  const int tid = threadIdx.x;
  const size_t n_nodes = gr.n_nodes();

  // input, split into stream parts; cells past the end are zero
  for (int i = tid; i < kComps * P13 * BC; i += blockDim.x) {
    const int b = i % BC, k = (i / BC) % P13, c = i / (BC * P13);
    const int cell = cell0 + b;
    T val = T(0);
    if (cell < nc) {
      if constexpr (LATTICE) {
        T m;
        const size_t node = cell_node<P>(gr, cell, k, mask, &m);
        val = u[c * n_nodes + node] * m;
      } else {
        val = u[static_cast<size_t>(c * P13 + k) * nc + cell];
      }
    }
    T parts[NS];
    St::split(val, parts);
#pragma unroll
    for (int n = 0; n < NS; ++n) sm.u[n][k][c][b] = parts[n];
  }
  if constexpr (ONTHEFLY) {
    for (int i = tid; i < Q3 * BC; i += blockDim.x) {
      const int b = i % BC, qp = i / BC;
      const int cell = min(cell0 + b, nc - 1);  // tail: results not stored
      T g[6];
      onthefly_metric(tb.pds + qp * 24, tb.coeffs + cell * 24, tb.w3[qp], g);
#pragma unroll
      for (int e = 0; e < 6; ++e) sm.g6[e * Q3 + qp][b] = g[e];
    }
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
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll 5
      for (int k = 0; k < P13; ++k) {
        const T* mk = tb.kmats + k * R + qp;
        const T m[3] = {matrix_value<T, SPLIT>(mk[0]),
                        matrix_value<T, SPLIT>(mk[Q3]),
                        matrix_value<T, SPLIT>(mk[2 * Q3])};
#pragma unroll
        for (int c = 0; c < kComps; ++c)
#pragma unroll
          for (int b = 0; b < BC; ++b) {
            const T uv = sm.u[n][k][c][b];
#pragma unroll
            for (int d = 0; d < 3; ++d) acc[d][c][b] = fma(m[d], uv, acc[d][c][b]);
          }
      }
    }
#pragma unroll
    for (int b = 0; b < BC; ++b) {
      T G[6];
#pragma unroll
      for (int e = 0; e < 6; ++e) {
        if constexpr (ONTHEFLY) {
          G[e] = sm.g6[e * Q3 + qp][b];
        } else {
          G[e] = cell0 + b < nc
                     ? tb.gmetric[static_cast<size_t>(e * Q3 + qp) * nc + cell0 + b]
                     : T(0);
        }
      }
#pragma unroll
      for (int c = 0; c < kComps; ++c) {
        const T gx = acc[0][c][b], gy = acc[1][c][b], gz = acc[2][c][b];
        const T t[3] = {G[0] * gx + G[1] * gy + G[2] * gz,
                        G[1] * gx + G[3] * gy + G[4] * gz,
                        G[2] * gx + G[4] * gy + G[5] * gz};
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          T parts[NS];
          St::split(t[e], parts);
#pragma unroll
          for (int n = 0; n < NS; ++n) sm.t[n][c][e * Q3 + qp][b] = parts[n];
        }
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
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll 4
      for (int r = 0; r < R; ++r) {
        const T m = matrix_value<T, SPLIT>(tb.mats[r * P13 + j]);
#pragma unroll
        for (int b = 0; b < BC; ++b) acc[b] = fma(m, sm.t[n][c][r][b], acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < BC; ++b) {
      const int cell = cell0 + b;
      if (cell >= nc) break;
      if constexpr (LATTICE) {
        T m;
        cell_node<P>(gr, cell, j, mask, &m);
        out[(static_cast<size_t>(c) * nc + cell) * P13 + j] = acc[b] * m;
      } else {
        out[static_cast<size_t>(c * P13 + j) * nc + cell] = acc[b];
      }
    }
  }
}

template <typename T, int P, bool SPLIT, bool ONTHEFLY, bool LATTICE>
cudaError_t launch_cells(const ApplyTables<T>& tb, const Grid& gr,
                         const T* mask, const T* u, T* out, cudaStream_t st) {
  using Sm = ApplySmem<T, P, SPLIT, ONTHEFLY>;
  auto kern = apply_kernel<T, P, SPLIT, ONTHEFLY, LATTICE>;
  // above 48 KB a block's shared memory must be requested explicitly
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Sm));
  if (attr != cudaSuccess) return attr;
  const int blocks = (gr.n_cells() + Sm::BC - 1) / Sm::BC;
  kern<<<blocks, kApplyThreads, sizeof(Sm), st>>>(tb, gr, mask, u, out);
  return cudaGetLastError();
}

// B3 (ONTHEFLY false) and B4 (true) on a cell batch (C P13, n_cells).
template <typename T, int P, bool SPLIT, bool ONTHEFLY>
int apply_batched(const ApplyTables<T>& tb, int n_cells, const T* u, T* v,
                  cudaStream_t st) {
  const Grid gr{1, 1, n_cells, 1, 1, 1};
  return launch_cells<T, P, SPLIT, ONTHEFLY, false>(tb, gr, nullptr, u, v, st);
}

// B5 (mask null: the box's Dirichlet mask from the indices) and B6 (mask
// tensor) on the lattice: the cell pass, then the assemble pass.
template <typename T, int P, bool SPLIT>
int apply_lattice(const ApplyTables<T>& tb, const Grid& gr, const T* mask,
                  const T* u, T* cells, T* v, cudaStream_t st) {
  cudaError_t e =
      launch_cells<T, P, SPLIT, false, true>(tb, gr, mask, u, cells, st);
  if (e != cudaSuccess) return e;
  assemble_kernel<T, P, false><<<node_blocks(gr), kNodeThreads, 0, st>>>(
      gr, cells, v, nullptr, nullptr, nullptr, nullptr);
  return cudaGetLastError();
}

template <typename T>
ApplyTables<T> apply_tables(const void* mats, const void* kmats,
                            const void* gmetric, const void* pds,
                            const void* w3, const void* coeffs) {
  return {static_cast<const T*>(mats), static_cast<const T*>(kmats),
          static_cast<const T*>(gmetric), static_cast<const T*>(pds),
          static_cast<const T*>(w3), static_cast<const T*>(coeffs)};
}

template <int P>
int batched_for_degree(int dtype, int split, int onthefly, const void* mats,
                       const void* kmats, const void* gmetric, const void* pds,
                       const void* w3, const void* coeffs, const void* u,
                       void* v, int n_cells, cudaStream_t st) {
  if (dtype == 0) {
    const auto tb = apply_tables<float>(mats, kmats, gmetric, pds, w3, coeffs);
    const auto uu = static_cast<const float*>(u);
    const auto vv = static_cast<float*>(v);
    if (onthefly) return apply_batched<float, P, false, true>(tb, n_cells, uu, vv, st);
    return split ? apply_batched<float, P, true, false>(tb, n_cells, uu, vv, st)
                 : apply_batched<float, P, false, false>(tb, n_cells, uu, vv, st);
  }
  if (dtype == 1 && !split) {
    const auto tb = apply_tables<double>(mats, kmats, gmetric, pds, w3, coeffs);
    const auto uu = static_cast<const double*>(u);
    const auto vv = static_cast<double*>(v);
    return onthefly ? apply_batched<double, P, false, true>(tb, n_cells, uu, vv, st)
                    : apply_batched<double, P, false, false>(tb, n_cells, uu, vv, st);
  }
  return -1;
}

template <int P>
int lattice_for_degree(int dtype, int split, const void* mats,
                       const void* kmats, const void* gmetric,
                       const void* mask, const void* u, void* cells, void* v,
                       const Grid& gr, cudaStream_t st) {
  if (dtype == 0) {
    const auto tb = apply_tables<float>(mats, kmats, gmetric, nullptr, nullptr,
                                        nullptr);
    const auto mm = static_cast<const float*>(mask);
    const auto uu = static_cast<const float*>(u);
    const auto cc = static_cast<float*>(cells);
    const auto vv = static_cast<float*>(v);
    return split ? apply_lattice<float, P, true>(tb, gr, mm, uu, cc, vv, st)
                 : apply_lattice<float, P, false>(tb, gr, mm, uu, cc, vv, st);
  }
  if (dtype == 1 && !split) {
    return apply_lattice<double, P, false>(
        apply_tables<double>(mats, kmats, gmetric, nullptr, nullptr, nullptr),
        gr, static_cast<const double*>(mask), static_cast<const double*>(u),
        static_cast<double*>(cells), static_cast<double*>(v), st);
  }
  return -1;
}

}  // namespace bp4

// dtype: 0 = float32, 1 = float64.  Instantiated: degrees 1..4; f32 with and
// without the split2m stream split, f64 without; B4 (onthefly) ignores split.
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
