// BP4 matvec (B1) and fused merged-CG iteration (B2) kernels for Hopper.
//
// Replace the TPU kernels of mf_data_locality_tpu/ops/cg_fused_kernel.py:
//   B1  piece_vmult -> _matvec_kernel        (pallas_call at :1116)
//   B2  fused_cg_iteration -> _fused_cg_kernel (pallas_call at :1476)
// at degrees 1..4, in the configurations the JAX auto-dispatch gives the
// fused solver there (laplace_cuda.fused_configs): the dense factorization
// or twostage, the metric streamed or rebuilt by the adjj chain
// (bp4_operator.cuh).
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
// The cell pass, by configuration:
//   "highest" (f32, f64), any factorization and metric source: the
//     sum-factorized pass of apply_sumfac.cuh in its lattice forms (B1: the
//     gather masked from the indices, as B5; B2: update4b at the gathered
//     nodes), 8 f32 (4 f64) cells a block, the metric streamed or rebuilt
//     from the coefficients.  Under "highest" the dense and twostage
//     operators are one function; this pass sums it in its own order.
//   f32 "split2m", dense: the tensor-core pass of apply_mma.cuh in its
//     lattice forms, 32 cells a block, the metric streamed or rebuilt per
//     chunk of 16 q-points into shared memory.
//   f32 "split2m", twostage + onthefly, p=4: one block per 16 cells, the 2D
//     stage on the tensor cores (cell_mma.cuh).
// Their notes give each pass's bound.  Bound of an iteration on the H100 at
// p=4, s=13: it reads x, g, d, h, P (~28 MB), writes x', g', d', h' (~26
// MB) and passes ~12 MB through the cell scratch, all close to the 50 MB
// L2; a streamed metric adds 6 Q3 words a cell (42 MB in f32); the cell
// pass takes most of the time (PERF.md).  Later: the node passes fused into
// the cell pass once a cell owns its output nodes.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() (0 on success),
// or -1 for a configuration with no instantiation.

#include <type_traits>

#include "apply_mma.cuh"
#include "apply_sumfac.cuh"
#include "bp4_operator.cuh"
#include "cell_mma.cuh"

namespace bp4 {

// The cell pass of B1 (FUSED false) or B2 for the configuration (split,
// dense, tb.gmetric null or not); each writes the masked cell-local result
// to cells[(c * n_cells + cell) * P13 + l].  -1: no instantiation.
template <typename T, int P, bool FUSED>
cudaError_t launch_cells(int split, int dense, const OpTables<T>& tb,
                         const Grid& gr, const CellIo<T>& io, T* cells,
                         cudaStream_t st) {
  constexpr int FORM = FUSED ? kLatticeUpdate : kLattice;
  if (!split) {
    const SumfacArgs<T> a{tb.sz,     tb.dz,   tb.gmetric, tb.pds, tb.w3,
                          tb.coeffs, nullptr, io,         cells};
    return tb.gmetric ? launch_sumfac<T, P, FORM, false>(a, gr, st)
                      : launch_sumfac<T, P, FORM, true>(a, gr, st);
  }
  if constexpr (std::is_same_v<T, float>) {
    if (dense) {
      // the forward table, then the backward one (laplace_cuda.mma_tables)
      const auto mf = reinterpret_cast<const uint2*>(tb.mats);
      const auto mb = mf + 3 * MmaShape<P>::Q3P * MmaShape<P>::P13P / 4;
      const MmaFusedArgs x{tb.pds, tb.w3, tb.coeffs, io};
      return tb.gmetric
                 ? launch_mma<P, FORM, false>(mf, mb, tb.gmetric, gr, nullptr,
                                              io.d, cells, x, st)
                 : launch_mma<P, FORM, true>(mf, mb, nullptr, gr, nullptr,
                                             io.d, cells, x, st);
    }
    if constexpr (P == 4) {
      if (!tb.gmetric) return launch_cells_mma<P, FUSED>(tb, gr, io, cells, st);
    }
  }
  return static_cast<cudaError_t>(-1);
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

template <typename T, int P>
struct Launch {
  static int matvec(int split, int dense, const OpTables<T>& tb,
                    const Grid& gr, const T* d, T* cells, T* h,
                    cudaStream_t st) {
    CellIo<T> io{};
    io.d = d;
    cudaError_t e =
        launch_cells<T, P, false>(split, dense, tb, gr, io, cells, st);
    if (e != cudaSuccess) return e;
    assemble_kernel<T, P, false><<<node_blocks(gr), kNodeThreads, 0, st>>>(
        gr, cells, h, nullptr, nullptr, nullptr, nullptr);
    return cudaGetLastError();
  }

  static int fused(int split, int dense, const OpTables<T>& tb,
                   const Grid& gr, const T* x, const T* g, const T* d,
                   const T* h, const T* prec, const T* scal, T* x2, T* g2,
                   T* d2, T* h2, T* scal2, T* cells, T* partials,
                   cudaStream_t st) {
    const CellIo<T> io{x, g, d, h, prec, scal, x2, g2, d2};
    cudaError_t e =
        launch_cells<T, P, true>(split, dense, tb, gr, io, cells, st);
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
                   const void* pds, const void* w3, const void* coeffs,
                   const void* gmetric) {
  return {static_cast<const T*>(mats),   static_cast<const T*>(sz),
          static_cast<const T*>(dz),     static_cast<const T*>(pds),
          static_cast<const T*>(w3),     static_cast<const T*>(coeffs),
          static_cast<const T*>(gmetric)};
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

// dtype: 0 = float32, 1 = float64.  Instantiated: degrees 1..4; f32 and
// f64 "highest" (mats unused, coeffs (24, n_cells)), f32 "split2m" (split
// = 1): dense (dense = 1: mats the bf16 fragment tables of apply_mma.cuh,
// coeffs (24, n_cells)) and, at degree 4, twostage with the rebuilt metric
// (dense = 0: mats the bf16 fragment tables of cell_mma.cuh, coeffs
// (n_cells, 24)).  gmetric: the streamed metric (6 Q3, n_cells), or null
// for the metric rebuilt from the coefficients.
extern "C" {

int bp4_partials_len(int degree, int ncz, int ncy, int ncx) {
  return 8 * bp4::node_blocks(make_grid(degree, ncz, ncy, ncx));
}

const char* bp4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bp4_matvec(int dtype, int split, int degree, int dense, const void* mats,
               const void* sz, const void* dz, const void* pds, const void* w3,
               const void* coeffs, const void* gmetric, const void* d,
               void* cells, void* h, int ncz, int ncy, int ncx, void* stream) {
  const Grid gr = make_grid(degree, ncz, ncy, ncx);
  auto st = static_cast<cudaStream_t>(stream);
#define BP4_MATVEC(T, P)                                                      \
  Launch<T, P>::matvec(split, dense,                                          \
                       tables<T>(mats, sz, dz, pds, w3, coeffs, gmetric), gr, \
                       static_cast<const T*>(d), static_cast<T*>(cells),      \
                       static_cast<T*>(h), st)
#define BP4_DEGREES(T)                   \
  switch (degree) {                      \
    case 1: return BP4_MATVEC(T, 1);     \
    case 2: return BP4_MATVEC(T, 2);     \
    case 3: return BP4_MATVEC(T, 3);     \
    case 4: return BP4_MATVEC(T, 4);     \
  }
  if (dtype == 0) BP4_DEGREES(float)
  if (dtype == 1 && !split) BP4_DEGREES(double)
#undef BP4_DEGREES
#undef BP4_MATVEC
  return -1;
}

int bp4_fused_iteration(int dtype, int split, int degree, int dense,
                        const void* mats, const void* sz, const void* dz,
                        const void* pds, const void* w3, const void* coeffs,
                        const void* gmetric, const void* x, const void* g,
                        const void* d, const void* h, const void* prec,
                        const void* scal, void* x2, void* g2, void* d2,
                        void* h2, void* scal2, void* cells, void* partials,
                        int ncz, int ncy, int ncx, void* stream) {
  const Grid gr = make_grid(degree, ncz, ncy, ncx);
  auto st = static_cast<cudaStream_t>(stream);
#define BP4_FUSED(T, P)                                                       \
  Launch<T, P>::fused(                                                        \
      split, dense, tables<T>(mats, sz, dz, pds, w3, coeffs, gmetric), gr,    \
      static_cast<const T*>(x), static_cast<const T*>(g),                     \
      static_cast<const T*>(d), static_cast<const T*>(h),                     \
      static_cast<const T*>(prec), static_cast<const T*>(scal),               \
      static_cast<T*>(x2), static_cast<T*>(g2), static_cast<T*>(d2),          \
      static_cast<T*>(h2), static_cast<T*>(scal2), static_cast<T*>(cells),    \
      static_cast<T*>(partials), st)
#define BP4_DEGREES(T)                  \
  switch (degree) {                     \
    case 1: return BP4_FUSED(T, 1);     \
    case 2: return BP4_FUSED(T, 2);     \
    case 3: return BP4_FUSED(T, 3);     \
    case 4: return BP4_FUSED(T, 4);     \
  }
  if (dtype == 0) BP4_DEGREES(float)
  if (dtype == 1 && !split) BP4_DEGREES(double)
#undef BP4_DEGREES
#undef BP4_FUSED
  return -1;
}

}  // extern "C"
