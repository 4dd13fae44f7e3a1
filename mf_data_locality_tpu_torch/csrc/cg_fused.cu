// BP4 matvec (B1) and fused merged-CG iteration (B2) kernels for Hopper.
//
// Replace the TPU kernels of mf_data_locality_tpu/ops/cg_fused_kernel.py:
//   B1  piece_vmult -> _matvec_kernel        (pallas_call at :1116)
//   B2  fused_cg_iteration -> _fused_cg_kernel (pallas_call at :1476)
// for the twostage + onthefly + adjj configuration (bp4_operator.cuh).
//
// State is the lattice (C, Nz, Ny, Nx), not the TPU's corner-piece rows.
// The TPU kernels walk z-cell layers in order on one core and carry the
// shared z plane and the dot partials from one grid step to the next; the
// H100 runs blocks in no order, so each apply is split into passes:
//
//   cells     one block per cell: (B2: update4b at the cell's nodes, the
//             owning cell writes x', g', d') then the cell operator; writes
//             the masked cell-local result to scratch (C, n_cells, (P+1)^3).
//   assemble  one thread per lattice node: sums its <= 8 cell contributions
//             in a fixed order, masks, writes h (replaces the TPU's lane-roll
//             consistency and z carry plane, cg_fused_kernel.py:869-905);
//             B2 also writes per-block partials of the 7 update3b dots.
//   finalize  (B2) one block: reduces the partials in a fixed order and runs
//             the merged-CG scalar recurrence (solver_cg_optimized.h:249-295).
//
// No atomics anywhere, so every result is bitwise reproducible run to run.
// B2 reads state buffers A and writes buffers B (the caller swaps them each
// iteration): the TPU's in-place update relied on its sequential grid to
// read each +1 plane before it was overwritten (cg_fused_kernel.py:820-829).
//
// Bound on the H100 at p=4, s=13: one lattice vector is 6.5 MB; an
// iteration reads x, g, d, h, P (~28 MB), writes x', g', d', h' (~26 MB)
// and passes ~12 MB through the cell scratch, all close to the 50 MB L2.
// The cell pass does ~1.9e9 FMAs per apply, so it, not DRAM, sets the time:
// measured on an H100 SXM (700 W), f32 split2m, one iteration is 446 us of
// cell pass, 25 us of assemble and 4 us of finalize, while the whole
// iteration's traffic would take ~26 us at the measured 3.0 TB/s.  Later:
// the 2D stage on the tensor cores (wgmma), TMA-staged node planes, and the
// node passes fused into the cell pass once a cell owns its output nodes.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() (0 on success),
// or -1 for a configuration with no instantiation.

#include "bp4_operator.cuh"

namespace bp4 {

template <typename T, int P, bool SPLIT>
__global__ void __launch_bounds__(kCellThreads)
    matvec_cells_kernel(OpTables<T> tb, Grid gr, const T* __restrict__ d,
                        T* __restrict__ cells) {
  using S = Shape<P>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<CellSmem<T, P, SPLIT>*>(smem_raw);
  const int cell = blockIdx.x;
  const int cx = cell % gr.ncx, cy = (cell / gr.ncx) % gr.ncy,
            cz = cell / (gr.ncx * gr.ncy);
  load_tables(sm, tb, cell);
  const size_t n_nodes = gr.n_nodes();
  for (int i = threadIdx.x; i < kComps * S::P13; i += blockDim.x) {
    const int c = i / S::P13, l = i % S::P13;
    const int z = cz * P + l / S::P12, y = cy * P + (l / S::P1) % S::P1,
              x = cx * P + l % S::P1;
    const size_t node = (static_cast<size_t>(z) * gr.ny + y) * gr.nx + x;
    sm.u[i] = interior(gr, z, y, x) ? d[c * n_nodes + node] : T(0);
  }
  __syncthreads();
  cell_apply(sm, tb, gr, cell, cz, cy, cx, cells);
}

// update4b (cg_fused_kernel.py:836-858) at every node of the cell, then the
// operator on d'.  Scalars come from the device (scal = alpha, beta, c1, aob,
// ...), so iterations chain with no host round trip in between.
template <typename T, int P, bool SPLIT>
__global__ void __launch_bounds__(kCellThreads)
    fused_cells_kernel(OpTables<T> tb, Grid gr, const T* __restrict__ x,
                       const T* __restrict__ g, const T* __restrict__ d,
                       const T* __restrict__ h, const T* __restrict__ prec,
                       const T* __restrict__ scal, T* __restrict__ x2,
                       T* __restrict__ g2, T* __restrict__ d2,
                       T* __restrict__ cells) {
  using S = Shape<P>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<CellSmem<T, P, SPLIT>*>(smem_raw);
  const int cell = blockIdx.x;
  const int cx = cell % gr.ncx, cy = (cell / gr.ncx) % gr.ncy,
            cz = cell / (gr.ncx * gr.ncy);
  load_tables(sm, tb, cell);
  const T alpha = scal[0], beta = scal[1], c1 = scal[2], aob = scal[3];
  const size_t n_nodes = gr.n_nodes();
  for (int i = threadIdx.x; i < kComps * S::P13; i += blockDim.x) {
    const int c = i / S::P13, l = i % S::P13;
    const int kz = l / S::P12, ky = (l / S::P1) % S::P1, kx = l % S::P1;
    const int z = cz * P + kz, y = cy * P + ky, xx = cx * P + kx;
    const size_t node = (static_cast<size_t>(z) * gr.ny + y) * gr.nx + xx;
    const size_t idx = c * n_nodes + node;
    const T pv = prec[node], gv = g[idx], dv = d[idx];
    const T gn = gv + alpha * h[idx];
    const T dn = beta * dv - pv * gn;
    // each node is written by exactly one cell: the one it is local node
    // (k < P) of, or the last cell along an axis for the top face
    const bool owner = (kz < P || cz == gr.ncz - 1) &&
                       (ky < P || cy == gr.ncy - 1) &&
                       (kx < P || cx == gr.ncx - 1);
    if (owner) {
      x2[idx] = x[idx] + c1 * dv + aob * (pv * gv);
      g2[idx] = gn;
      d2[idx] = dn;
    }
    sm.u[i] = interior(gr, z, y, xx) ? dn : T(0);
  }
  __syncthreads();
  cell_apply(sm, tb, gr, cell, cz, cy, cx, cells);
}

template <typename T, int P, bool DOTS>
__global__ void __launch_bounds__(kNodeThreads)
    assemble_kernel(Grid gr, const T* __restrict__ cells, T* __restrict__ h,
                    const T* __restrict__ g, const T* __restrict__ d,
                    const T* __restrict__ prec, T* __restrict__ partials) {
  __shared__ T red[DOTS ? kDots : 1][kNodeThreads];
  const int n_nodes = gr.n_nodes();
  const int node = blockIdx.x * kNodeThreads + threadIdx.x;
  T acc[kDots] = {};
  if (node < n_nodes) {
    const int x = node % gr.nx, y = (node / gr.nx) % gr.ny,
              z = node / (gr.nx * gr.ny);
    const bool in = interior(gr, z, y, x);
    T pv = T(0);
    if constexpr (DOTS) pv = prec[node];
    for (int c = 0; c < kComps; ++c) {
      const size_t idx = static_cast<size_t>(c) * n_nodes + node;
      const T hv = in ? gather_node<T, P>(cells, gr, c, z, y, x) : T(0);
      h[idx] = hv;
      if constexpr (DOTS) {
        // update3b sums over d', g' as stored and h' (cg_fused_kernel.py:877-895)
        const T gv = g[idx], dv = d[idx];
        const T ph = pv * hv, pg = pv * gv;
        acc[0] += dv * hv;
        acc[1] += hv * hv;
        acc[2] += gv * hv;
        acc[3] += gv * gv;
        acc[4] += gv * ph;
        acc[5] += hv * ph;
        acc[6] += gv * pg;
      }
    }
  }
  if constexpr (DOTS) {
    block_sum(red, acc);
    if (threadIdx.x == 0) {
      for (int k = 0; k < kDots; ++k) partials[blockIdx.x * 8 + k] = red[k][0];
      partials[blockIdx.x * 8 + kDots] = T(0);
    }
  }
}

// The merged-CG scalar update from the 7 sums (cg_fused_kernel.scalar_recurrence,
// solver_cg_optimized.h:249-295).  d.h = 0 (breakdown) propagates NaN into
// alpha and res2 on purpose: the solver's `res > tol` test then ends the solve.
template <typename T>
__device__ void scalar_recurrence(const T* s, const T* scal, T* out) {
  const T alpha = scal[0], beta = scal[1], parity = scal[4];
  const T alpha_n = s[6] / s[0];
  const T beta_n = alpha_n * (s[4] + alpha_n * s[5]) / s[6];
  const T res2 = s[3] + T(2) * alpha_n * s[2] + alpha_n * alpha_n * s[1];
  const T parity_next = T(1) - parity;
  const bool is_pay = (parity_next > T(0.5)) && (alpha != T(0));
  const T safe_b = beta == T(0) ? T(1) : beta;
  const T aob_n = is_pay ? alpha / safe_b : T(0);
  const T c1_n = is_pay ? alpha_n + aob_n : T(0);
  out[0] = alpha_n;
  out[1] = beta_n;
  out[2] = c1_n;
  out[3] = aob_n;
  out[4] = parity_next;
  out[5] = res2;
  out[6] = alpha;
  out[7] = beta;
}

template <typename T>
__global__ void __launch_bounds__(kNodeThreads)
    finalize_kernel(const T* __restrict__ partials, int n_blocks,
                    const T* __restrict__ scal, T* __restrict__ scal2) {
  __shared__ T red[kDots][kNodeThreads];
  T acc[kDots] = {};
  for (int b = threadIdx.x; b < n_blocks; b += kNodeThreads)
    for (int k = 0; k < kDots; ++k) acc[k] += partials[b * 8 + k];
  block_sum(red, acc);
  if (threadIdx.x == 0) {
    T s[kDots];
    for (int k = 0; k < kDots; ++k) s[k] = red[k][0];
    scalar_recurrence(s, scal, scal2);
  }
}

inline int node_blocks(const Grid& gr) {
  return (gr.n_nodes() + kNodeThreads - 1) / kNodeThreads;
}

template <typename T, int P, bool SPLIT>
struct Launch {
  using Smem = CellSmem<T, P, SPLIT>;

  static cudaError_t prepare() {
    // above 48 KB a block's shared memory must be requested explicitly
    static const cudaError_t err = [] {
      cudaError_t e = cudaFuncSetAttribute(
          matvec_cells_kernel<T, P, SPLIT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
      if (e != cudaSuccess) return e;
      return cudaFuncSetAttribute(fused_cells_kernel<T, P, SPLIT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  sizeof(Smem));
    }();
    return err;
  }

  static int matvec(const OpTables<T>& tb, const Grid& gr, const T* d,
                    T* cells, T* h, cudaStream_t st) {
    cudaError_t e = prepare();
    if (e != cudaSuccess) return e;
    matvec_cells_kernel<T, P, SPLIT>
        <<<gr.n_cells(), kCellThreads, sizeof(Smem), st>>>(tb, gr, d, cells);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    assemble_kernel<T, P, false><<<node_blocks(gr), kNodeThreads, 0, st>>>(
        gr, cells, h, nullptr, nullptr, nullptr, nullptr);
    return cudaGetLastError();
  }

  static int fused(const OpTables<T>& tb, const Grid& gr, const T* x,
                   const T* g, const T* d, const T* h, const T* prec,
                   const T* scal, T* x2, T* g2, T* d2, T* h2, T* scal2,
                   T* cells, T* partials, cudaStream_t st) {
    cudaError_t e = prepare();
    if (e != cudaSuccess) return e;
    fused_cells_kernel<T, P, SPLIT>
        <<<gr.n_cells(), kCellThreads, sizeof(Smem), st>>>(
            tb, gr, x, g, d, h, prec, scal, x2, g2, d2, cells);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    const int nb = node_blocks(gr);
    assemble_kernel<T, P, true><<<nb, kNodeThreads, 0, st>>>(
        gr, cells, h2, g2, d2, prec, partials);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    finalize_kernel<T><<<1, kNodeThreads, 0, st>>>(partials, nb, scal, scal2);
    return cudaGetLastError();
  }
};

template <typename T>
OpTables<T> tables(const void* mats, const void* sz, const void* dz,
                   const void* pds, const void* w3, const void* coeffs) {
  return {static_cast<const T*>(mats), static_cast<const T*>(sz),
          static_cast<const T*>(dz),   static_cast<const T*>(pds),
          static_cast<const T*>(w3),   static_cast<const T*>(coeffs)};
}

}  // namespace bp4

using bp4::Grid;
using bp4::Launch;
using bp4::tables;

namespace {

Grid make_grid(int degree, int ncz, int ncy, int ncx) {
  return {ncz, ncy, ncx, degree * ncz + 1, degree * ncy + 1, degree * ncx + 1};
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  Instantiated: degree 4; f32 with and
// without the split2m stream split, f64 without.
extern "C" {

int bp4_partials_len(int degree, int ncz, int ncy, int ncx) {
  return 8 * bp4::node_blocks(make_grid(degree, ncz, ncy, ncx));
}

const char* bp4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bp4_matvec(int dtype, int split, int degree, const void* mats,
               const void* sz, const void* dz, const void* pds, const void* w3,
               const void* coeffs, const void* d, void* cells, void* h, int ncz,
               int ncy, int ncx, void* stream) {
  const Grid gr = make_grid(degree, ncz, ncy, ncx);
  auto st = static_cast<cudaStream_t>(stream);
  if (degree != 4) return -1;
  if (dtype == 0) {
    auto tb = tables<float>(mats, sz, dz, pds, w3, coeffs);
    auto dd = static_cast<const float*>(d);
    auto cc = static_cast<float*>(cells);
    auto hh = static_cast<float*>(h);
    return split ? Launch<float, 4, true>::matvec(tb, gr, dd, cc, hh, st)
                 : Launch<float, 4, false>::matvec(tb, gr, dd, cc, hh, st);
  }
  if (dtype == 1 && !split) {
    return Launch<double, 4, false>::matvec(
        tables<double>(mats, sz, dz, pds, w3, coeffs), gr,
        static_cast<const double*>(d), static_cast<double*>(cells),
        static_cast<double*>(h), st);
  }
  return -1;
}

int bp4_fused_iteration(int dtype, int split, int degree, const void* mats,
                        const void* sz, const void* dz, const void* pds,
                        const void* w3, const void* coeffs, const void* x,
                        const void* g, const void* d, const void* h,
                        const void* prec, const void* scal, void* x2, void* g2,
                        void* d2, void* h2, void* scal2, void* cells,
                        void* partials, int ncz, int ncy, int ncx,
                        void* stream) {
  const Grid gr = make_grid(degree, ncz, ncy, ncx);
  auto st = static_cast<cudaStream_t>(stream);
  if (degree != 4) return -1;
#define BP4_FUSED(T, SPLIT)                                                   \
  Launch<T, 4, SPLIT>::fused(                                                 \
      tables<T>(mats, sz, dz, pds, w3, coeffs), gr,                           \
      static_cast<const T*>(x), static_cast<const T*>(g),                     \
      static_cast<const T*>(d), static_cast<const T*>(h),                     \
      static_cast<const T*>(prec), static_cast<const T*>(scal),               \
      static_cast<T*>(x2), static_cast<T*>(g2), static_cast<T*>(d2),          \
      static_cast<T*>(h2), static_cast<T*>(scal2), static_cast<T*>(cells),    \
      static_cast<T*>(partials), st)
  if (dtype == 0) return split ? BP4_FUSED(float, true) : BP4_FUSED(float, false);
  if (dtype == 1 && !split) return BP4_FUSED(double, false);
#undef BP4_FUSED
  return -1;
}

}  // extern "C"
