// The cell passes at one shape beyond BP4's (shapes.cuh), degree
// BP4_DEGREE and shape flags BP4_SHAPE: one object a degree and shape
// (ops/_build.py), so that nvcc builds them in parallel with the other
// sources.

#include "apply_mma_hd.cuh"
#include "apply_sumfac.cuh"
#include "cell_mma_hd.cuh"
#include "shapes.cuh"

namespace bp4 {

namespace {

constexpr int kSplit2m = 2;  // the rung's products a tile (mma.cuh)

// the dense tensor-core pass of one form at shape SH: the metric streamed
// (gmetric), or rebuilt by `cofactor` (NP | kJtjChain for jtj)
template <int P, int SH, int FORM>
cudaError_t dense_pass(int cofactor, const void* mf, const void* mb,
                       const float* gmetric, const Grid& gr,
                       const float* mask, const float* u, float* out,
                       const MmaFusedArgs& x, void* scratch,
                       cudaStream_t st) {
  constexpr int NP = kSplit2m | SH;
  if (gmetric)
    return launch_mma_hd_here<P, FORM, false, NP>(mf, mb, gmetric, gr, mask,
                                                  u, out, x, scratch, st);
  if constexpr (FORM == kCellBatch) {
    return static_cast<cudaError_t>(-1);  // B4 runs the sum-factorized pass
  } else {
    return cofactor == kJtj
               ? launch_mma_hd_here<P, FORM, true, NP | kJtjChain>(
                     mf, mb, nullptr, gr, mask, u, out, x, scratch, st)
               : launch_mma_hd_here<P, FORM, true, NP>(
                     mf, mb, nullptr, gr, mask, u, out, x, scratch, st);
  }
}

}  // namespace

template <typename T, int P, int SH, bool FUSED>
cudaError_t shape_cells(int rung, int dense, int cofactor,
                        const OpTables<T>& tb, const Grid& gr,
                        const CellIo<T>& io, T* cells, void* scratch,
                        cudaStream_t st) {
  constexpr int FORM = FUSED ? kLatticeUpdate : kLattice;
  const auto none = static_cast<cudaError_t>(-1);
  if (io.bf16 || io.prec_bf16 || io.x_bf16 || (tb.gmetric && tb.metric_bf16))
    return none;
  if (!rung) {
    const SumfacArgs<T> a{tb.sz,     tb.dz,   tb.gmetric, tb.pds, tb.w3,
                          tb.coeffs, nullptr, io,         cells,  cofactor};
    return tb.gmetric ? launch_sumfac_here<T, P, FORM, false, SH>(a, gr, st)
                      : launch_sumfac_here<T, P, FORM, true, SH>(a, gr, st);
  }
  if constexpr (std::is_same_v<T, float>) {
    if (rung != kSplit2m) return none;
    constexpr int NP = kSplit2m | SH;
    if (dense) {
      // the forward table, then the backward one (laplace_cuda.mma_tables)
      using Ms = MmaShape<P, SH>;
      const auto mf = reinterpret_cast<const uint2*>(tb.mats);
      const auto mb = mf + 3 * Ms::Q3P * Ms::P13P / 4;
      const MmaFusedArgs x{tb.pds, tb.w3, tb.coeffs, io};
      return dense_pass<P, SH, FORM>(cofactor, mf, mb, tb.gmetric, gr,
                                     nullptr, io.d, cells, x, scratch, st);
    }
    if (tb.gmetric)
      return launch_cells_mma_hd_here<P, FUSED, false, kAdjj, NP>(tb, gr, io,
                                                                  cells, st);
    return cofactor == kJtj
               ? launch_cells_mma_hd_here<P, FUSED, true, kJtj, NP>(
                     tb, gr, io, cells, st)
               : launch_cells_mma_hd_here<P, FUSED, true, kAdjj, NP>(
                     tb, gr, io, cells, st);
  }
  return none;
}

template <typename T, int P, int SH>
cudaError_t shape_batched(int rung, int onthefly, const void* mats,
                          const void* kmats, const void* gmetric,
                          const void* pds, const void* w3,
                          const void* coeffs, const Grid& gr, const void* u,
                          void* v, void* scratch, cudaStream_t st) {
  const auto uu = static_cast<const T*>(u);
  const auto vv = static_cast<T*>(v);
  if (onthefly || !rung) {  // B4 (exact on every rung), B3 under highest
    SumfacArgs<T> a{static_cast<const T*>(mats), static_cast<const T*>(kmats),
                    static_cast<const T*>(gmetric), static_cast<const T*>(pds),
                    static_cast<const T*>(w3), static_cast<const T*>(coeffs)};
    a.io.d = uu;
    a.out = vv;
    a.cofactor = kAdjj;
    return onthefly
               ? launch_sumfac_here<T, P, kCellBatch, true, SH>(a, gr, st)
               : launch_sumfac_here<T, P, kCellBatch, false, SH>(a, gr, st);
  }
  if constexpr (std::is_same_v<T, float>) {
    if (rung != kSplit2m) return static_cast<cudaError_t>(-1);
    MmaFusedArgs x{};
    return dense_pass<P, SH, kCellBatch>(
        kAdjj, mats, kmats, static_cast<const float*>(gmetric), gr, nullptr,
        uu, vv, x, scratch, st);
  }
  return static_cast<cudaError_t>(-1);
}

template <typename T, int P, int SH>
cudaError_t shape_lattice_cells(int rung, const void* mats,
                                const void* kmats, const void* gmetric,
                                const Grid& gr, const void* mask,
                                const void* u, void* cells, void* scratch,
                                cudaStream_t st) {
  const auto mm = static_cast<const T*>(mask);
  const auto uu = static_cast<const T*>(u);
  const auto oo = static_cast<T*>(cells);
  if (!rung) {
    SumfacArgs<T> a{static_cast<const T*>(mats), static_cast<const T*>(kmats),
                    static_cast<const T*>(gmetric)};
    a.mask = mm;
    a.io.d = uu;
    a.out = oo;
    return launch_sumfac_here<T, P, kLattice, false, SH>(a, gr, st);
  }
  if constexpr (std::is_same_v<T, float>) {
    if (rung != kSplit2m) return static_cast<cudaError_t>(-1);
    MmaFusedArgs x{};
    return dense_pass<P, SH, kLattice>(kAdjj, mats, kmats,
                                       static_cast<const float*>(gmetric), gr,
                                       mm, uu, oo, x, scratch, st);
  }
  return static_cast<cudaError_t>(-1);
}

template <int P, int SH>
size_t shape_dense_scratch_len(int n_cells) {
  return dense_hd_scratch_len<P, kSplit2m | SH>(n_cells);
}

#define BP4_SHAPE_TYPE(T, P, SH)                                             \
  template cudaError_t shape_cells<T, P, SH, false>(                         \
      int, int, int, const OpTables<T>&, const Grid&, const CellIo<T>&, T*, \
      void*, cudaStream_t);                                                  \
  template cudaError_t shape_cells<T, P, SH, true>(                          \
      int, int, int, const OpTables<T>&, const Grid&, const CellIo<T>&, T*, \
      void*, cudaStream_t);                                                  \
  template cudaError_t shape_batched<T, P, SH>(                              \
      int, int, const void*, const void*, const void*, const void*,          \
      const void*, const void*, const Grid&, const void*, void*, void*,      \
      cudaStream_t);                                                         \
  template cudaError_t shape_lattice_cells<T, P, SH>(                        \
      int, const void*, const void*, const void*, const Grid&, const void*,  \
      const void*, void*, void*, cudaStream_t);
BP4_SHAPE_TYPE(float, BP4_DEGREE, BP4_SHAPE)
BP4_SHAPE_TYPE(double, BP4_DEGREE, BP4_SHAPE)
template size_t shape_dense_scratch_len<BP4_DEGREE, BP4_SHAPE>(int);

}  // namespace bp4
