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
//   cells     one block per 8 f32 or 4 f64 cells (split2m: per 16 cells):
//             (B2: update4b at the cells' nodes, the owning cell writes x',
//             g', d') then the cell operator; writes the masked cell-local
//             result to scratch (C, n_cells, (P+1)^3).
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
// The cell pass has two designs.  "highest" (f32, f64): the sum-factorized
// pass of apply_sumfac.cuh in its lattice forms with the metric rebuilt
// from the coefficients (B1: the gather masked from the indices, as B5;
// B2: update4b at the gathered nodes), 8 f32 (4 f64) cells a block.  f32
// "split2m": one block per 16 cells, the 2D stage on the tensor cores
// (cell_mma.cuh).  Their notes give each pass's bound.  Bound of an
// iteration on the H100 at p=4, s=13: it reads x, g, d, h, P (~28 MB),
// writes x', g', d', h' (~26 MB) and passes ~12 MB through the cell
// scratch, all close to the 50 MB L2; the cell pass takes most of the time
// (PERF.md).  Later: the node passes fused into the cell pass once a cell
// owns its output nodes.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() (0 on success),
// or -1 for a configuration with no instantiation.

#include "apply_sumfac.cuh"
#include "bp4_operator.cuh"
#include "cell_mma.cuh"

namespace bp4 {

// The cell pass of B1 (FUSED false) or B2: under split2m the tensor-core
// pass, else the sum-factorized pass with the metric rebuilt (tb.coeffs
// cell-fastest); both write the masked cell-local result to
// cells[(c * n_cells + cell) * P13 + l].
template <typename T, int P, bool SPLIT, bool FUSED>
cudaError_t launch_cells(const OpTables<T>& tb, const Grid& gr,
                         const CellIo<T>& io, T* cells, cudaStream_t st) {
  if constexpr (SPLIT) {
    return launch_cells_mma<P, FUSED>(tb, gr, io, cells, st);
  } else {
    const SumfacArgs<T> a{tb.sz,     tb.dz,   nullptr, tb.pds, tb.w3,
                          tb.coeffs, nullptr, io,      cells};
    return launch_sumfac<T, P, FUSED ? kLatticeUpdate : kLattice, true>(
        a, gr, st);
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

template <typename T, int P, bool SPLIT>
struct Launch {
  static int matvec(const OpTables<T>& tb, const Grid& gr, const T* d,
                    T* cells, T* h, cudaStream_t st) {
    CellIo<T> io{};
    io.d = d;
    cudaError_t e = launch_cells<T, P, SPLIT, false>(tb, gr, io, cells, st);
    if (e != cudaSuccess) return e;
    assemble_kernel<T, P, false><<<node_blocks(gr), kNodeThreads, 0, st>>>(
        gr, cells, h, nullptr, nullptr, nullptr, nullptr);
    return cudaGetLastError();
  }

  static int fused(const OpTables<T>& tb, const Grid& gr, const T* x,
                   const T* g, const T* d, const T* h, const T* prec,
                   const T* scal, T* x2, T* g2, T* d2, T* h2, T* scal2,
                   T* cells, T* partials, cudaStream_t st) {
    const CellIo<T> io{x, g, d, h, prec, scal, x2, g2, d2};
    cudaError_t e = launch_cells<T, P, SPLIT, true>(tb, gr, io, cells, st);
    if (e != cudaSuccess) return e;
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

// dtype: 0 = float32, 1 = float64.  Instantiated: degree 4; f32 "highest"
// and "split2m" (split = 1: mats is the bf16 fragment tables of
// cell_mma.cuh, coeffs (n_cells, 24)), f64 "highest" (mats unused, coeffs
// (24, n_cells)).
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
