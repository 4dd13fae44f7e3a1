// The cell passes at one shape beyond BP4's (shapes.cuh), degree
// BP4_DEGREE and shape flags BP4_SHAPE (with kSbState: the bf16 state at
// one component, f32), and the node passes over its components: one
// object a degree and shape (ops/_build.py), so that nvcc builds them in
// parallel with the other sources.

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
  constexpr bool STATE = (SH & kSbState) != 0;
  const auto none = static_cast<cudaError_t>(-1);
  if ((io.bf16 && !STATE) || io.prec_bf16 || io.x_bf16 ||
      (tb.gmetric && tb.metric_bf16))
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
      using Ms = MmaShape<P, SH & kShMask>;
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
    a.io.bf16 = (SH & kSbState) != 0;
    a.out = vv;
    a.cofactor = kAdjj;
    return onthefly
               ? launch_sumfac_here<T, P, kCellBatch, true, SH>(a, gr, st)
               : launch_sumfac_here<T, P, kCellBatch, false, SH>(a, gr, st);
  }
  if constexpr (std::is_same_v<T, float>) {
    if (rung != kSplit2m) return static_cast<cudaError_t>(-1);
    MmaFusedArgs x{};
    x.io.bf16 = (SH & kSbState) != 0;
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
    a.io.bf16 = (SH & kSbState) != 0;
    a.out = oo;
    return launch_sumfac_here<T, P, kLattice, false, SH>(a, gr, st);
  }
  if constexpr (std::is_same_v<T, float>) {
    if (rung != kSplit2m) return static_cast<cudaError_t>(-1);
    MmaFusedArgs x{};
    x.io.bf16 = (SH & kSbState) != 0;
    return dense_pass<P, SH, kLattice>(kAdjj, mats, kmats,
                                       static_cast<const float*>(gmetric), gr,
                                       mm, uu, oo, x, scratch, st);
  }
  return static_cast<cudaError_t>(-1);
}

template <typename T, int P, int SH, bool DOTS>
cudaError_t shape_assemble(const Grid& gr, const T* cells, void* h,
                           const CellIo<T>& io, T* partials,
                           cudaStream_t st) {
  constexpr int C = Shape<P, SH>::C;
  using V = std::conditional_t<(SH & kSbState) != 0, __nv_bfloat16, T>;
  assemble_kernel<T, P, DOTS, V, false, false, C>
      <<<node_blocks(gr), kNodeThreads, 0, st>>>(
          gr, cells, static_cast<V*>(h), io.g2,
          reinterpret_cast<const V*>(io.d2), io.prec, partials);
  return cudaGetLastError();
}

// B5/B6's assemble pass at T over C components: on a block's lattice
// (block) every node summed, the faces keeping their partial sums; else
// the box's faces zeroed
template <typename T, int P, int C>
cudaError_t shape_lattice_sum(const Grid& gr, const T* c, T* h, int block,
                              cudaStream_t st) {
  const int nb = node_blocks(gr);
  if (block) {
    if constexpr (C == 1) {
      Grid all = gr;
      all.zlo = all.ylo = all.xlo = 0;
      all.zhi = gr.nz;
      all.yhi = gr.ny;
      all.xhi = gr.nx;
      assemble_kernel<T, P, false, T, false, true, C>
          <<<nb, kNodeThreads, 0, st>>>(all, c, h, nullptr, nullptr,
                                        nullptr, nullptr);
    } else {
      return static_cast<cudaError_t>(-1);  // the block form at Q = P + 1
    }
  } else {
    assemble_kernel<T, P, false, T, false, false, C>
        <<<nb, kNodeThreads, 0, st>>>(gr, c, h, nullptr, nullptr, nullptr,
                                      nullptr);
  }
  return cudaGetLastError();
}

template <typename T, int P, int SH>
cudaError_t shape_lattice_nodes(const Grid& gr, const void* cells, void* v,
                                int pieces, int block, cudaStream_t st) {
  constexpr int C = Shape<P, SH>::C;
  const auto c = static_cast<const T*>(cells);
  if constexpr ((SH & kSbState) != 0) {
    const int nb = node_blocks(gr);
    const auto h = static_cast<__nv_bfloat16*>(v);
    if (pieces && block)
      assemble_bf16_kernel<P, true, true, C><<<nb, kNodeThreads, 0, st>>>(
          gr, c, h);
    else if (pieces)
      assemble_bf16_kernel<P, true, false, C><<<nb, kNodeThreads, 0, st>>>(
          gr, c, h);
    else if (block)
      assemble_bf16_kernel<P, false, true, C><<<nb, kNodeThreads, 0, st>>>(
          gr, c, h);
    else
      assemble_bf16_kernel<P, false, false, C><<<nb, kNodeThreads, 0, st>>>(
          gr, c, h);
    return cudaGetLastError();
  } else {
    return shape_lattice_sum<T, P, C>(gr, c, static_cast<T*>(v), block, st);
  }
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
      const void*, void*, void*, cudaStream_t);                             \
  template cudaError_t shape_assemble<T, P, SH, false>(                      \
      const Grid&, const T*, void*, const CellIo<T>&, T*, cudaStream_t);    \
  template cudaError_t shape_assemble<T, P, SH, true>(                       \
      const Grid&, const T*, void*, const CellIo<T>&, T*, cudaStream_t);    \
  template cudaError_t shape_lattice_nodes<T, P, SH>(                        \
      const Grid&, const void*, void*, int, int, cudaStream_t);
BP4_SHAPE_TYPE(float, BP4_DEGREE, BP4_SHAPE)
#if ((BP4_SHAPE) & 4) == 0  // the bf16 state (kSbState): f32 only
BP4_SHAPE_TYPE(double, BP4_DEGREE, BP4_SHAPE)
template size_t shape_dense_scratch_len<BP4_DEGREE, BP4_SHAPE>(int);
#endif
static_assert(kSbState == 4, "BP4_SHAPE's state flag");

}  // namespace bp4
