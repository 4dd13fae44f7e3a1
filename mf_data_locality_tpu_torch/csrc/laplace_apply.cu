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
//               cores with the metric streamed, apply_sumfac.cuh;
//               f32 "split2m": the tensor-core pass, apply_mma.cuh;
//   B4          every rung, exact at the working type as _kernel
//               (Precision.HIGHEST, :529): the sum-factorized pass with the
//               metric rebuilt per (cell, q-point) from the 24 trilinear
//               coefficients, apply_sumfac.cuh.
// B5 and B6 write masked cell-local values to scratch; the assemble pass
// (bp4_operator.cuh) then sums each node's <= 8 contributions in a fixed
// order (no atomics).  The TPU kernels walk z-cell layers in order carrying
// the shared z plane in VMEM; the assemble pass takes the carry's place, so
// blocks run in any order.  The passes' notes give their bounds.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() (0 on success),
// or -1 for a configuration with no instantiation.

#include <type_traits>

#include "apply_mma.cuh"
#include "apply_sumfac.cuh"
#include "bp4_operator.cuh"

namespace bp4 {

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
  if (!split) {
    SumfacArgs<T> a{static_cast<const T*>(m0), static_cast<const T*>(m1), gm};
    a.mask = mm;
    a.io.d = uu;
    a.out = oo;
    return launch_sumfac<T, P, LATTICE ? kLattice : kCellBatch, false>(a, gr,
                                                                       st);
  }
  if constexpr (std::is_same_v<T, float>)
    return launch_mma<P, LATTICE ? kLattice : kCellBatch, false>(
        m0, m1, gm, gr, mm, uu, oo, MmaFusedArgs{}, st);
  return static_cast<cudaError_t>(-1);
}

// B4: the sum-factorized pass with the metric rebuilt, on a cell batch;
// s, d are S and D (Q, P1), coeffs (24, n_cells).
template <typename T, int P>
cudaError_t rebuilt_pass(const void* s, const void* d, const void* pds,
                         const void* w3, const void* coeffs, const Grid& gr,
                         const void* u, void* out, cudaStream_t st) {
  SumfacArgs<T> a{static_cast<const T*>(s), static_cast<const T*>(d), nullptr,
                  static_cast<const T*>(pds), static_cast<const T*>(w3),
                  static_cast<const T*>(coeffs)};
  a.io.d = static_cast<const T*>(u);
  a.out = static_cast<T*>(out);
  return launch_sumfac<T, P, kCellBatch, true>(a, gr, st);
}

// B3 (metric streamed) and B4 (onthefly) on a cell batch (C P13, n_cells).
// mats/kmats: the tables of metric_pass (B3); S and D (B4).
template <int P>
int batched_for_degree(int dtype, int split, int onthefly, const void* mats,
                       const void* kmats, const void* gmetric, const void* pds,
                       const void* w3, const void* coeffs, const void* u,
                       void* v, int n_cells, cudaStream_t st) {
  const Grid gr{1, 1, n_cells, 1, 1, 1};
  if (dtype == 0)
    return onthefly  // B4 is exact on every rung
               ? rebuilt_pass<float, P>(mats, kmats, pds, w3, coeffs, gr, u, v,
                                        st)
               : metric_pass<float, P, false>(split, mats, kmats, gmetric, gr,
                                              nullptr, u, v, st);
  if (dtype == 1)
    return onthefly
               ? rebuilt_pass<double, P>(mats, kmats, pds, w3, coeffs, gr, u,
                                         v, st)
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
// tables); B4 (onthefly: the sum-factorized pass, mats = S, kmats = D, pds
// (Q3, 24), w3, coeffs (24, n_cells)) ignores split.
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
