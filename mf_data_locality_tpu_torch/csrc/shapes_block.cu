// B2's block form and its layer-range form at one component (CEED BP3,
// Q = P + 2; shapes.cuh), degree BP4_DEGREE: the distributed fused
// solver's iteration on a rank's block of a (z), (z, y) or (z, y, x) rank
// mesh (cg_fused.cu's notes on the block form), one object a degree
// (ops/_build.py), so that nvcc builds them in parallel with the other
// sources.  It replaces the TPU kernel of
//   B2  cg_fused_kernel.py _fused_cg_kernel (pallas_call :1476)
// with halo, z0, ncz_global, recurrence=False and want_carry=True (and
// y_split / x_split on a mesh) at one component, as the JAX distributed
// builders run it with n_components=1.
//
// The cell pass is the kLatticeUpdateBlock form of the pass that the
// shapes' other forms run: the sum-factorized pass under highest (f32,
// f64; the metric streamed or rebuilt by either chain), the dense
// tensor-core pass of apply_mma_hd.cuh under split2m at every degree (its
// C counts rows and warps; the metric streamed or rebuilt by adjj, the
// ranks' dense operator), each also in its bf16-state instantiation
// (kSbState: d and h in bf16, d' rounded where it is stored).  The node
// passes: the assemble pass's BLOCK over one component (h' rounded to
// bf16 under the state), the RAW finalize pass; and C10's f32 carry over
// one component.  The bound is the block form's at BP4's shape with one
// component's vectors: at p=4 the streamed metric (6 Q^3 = 1,296 words a
// cell) moves more than twice the vectors' words (about 9 p^3 = 576 a
// cell), so the pass is bound by bytes; rebuilt, by its operations
// (PERF.md).

#include "cg_fused.cuh"
#include "shapes.cuh"

namespace bp4 {

namespace {

constexpr int kSplit2m = 2;  // the rung's products a tile (mma.cuh)

// the cell pass of the block form at one component, storage SB (0, or
// kSbState: the bf16 state)
template <typename T, int P, int SB>
cudaError_t block_cells(int rung, int dense, int cofactor,
                        const OpTables<T>& tb, const Grid& gr,
                        const CellIo<T>& io, T* cells, void* scratch,
                        cudaStream_t st) {
  constexpr int FORM = kLatticeUpdateBlock, SH = kShC1 | SB;
  const auto none = static_cast<cudaError_t>(-1);
  if (!rung) {
    const SumfacArgs<T> a{tb.sz,     tb.dz,   tb.gmetric, tb.pds, tb.w3,
                          tb.coeffs, nullptr, io,         cells,  cofactor};
    return tb.gmetric ? launch_sumfac_here<T, P, FORM, false, SH>(a, gr, st)
                      : launch_sumfac_here<T, P, FORM, true, SH>(a, gr, st);
  }
  if constexpr (std::is_same_v<T, float>) {
    if (rung != kSplit2m || !dense || (!tb.gmetric && cofactor == kJtj))
      return none;
    // the forward table, then the backward one (laplace_cuda.mma_tables)
    using Ms = MmaShape<P, kShC1>;
    const auto mf = reinterpret_cast<const uint2*>(tb.mats);
    const auto mb = mf + 3 * Ms::Q3P * Ms::P13P / 4;
    const MmaFusedArgs x{tb.pds, tb.w3, tb.coeffs, io};
    constexpr int NP = kSplit2m | SH;
    return tb.gmetric
               ? launch_mma_hd_here<P, FORM, false, NP>(
                     mf, mb, tb.gmetric, gr, nullptr, io.d, cells, x,
                     scratch, st)
               : launch_mma_hd_here<P, FORM, true, NP>(
                     mf, mb, nullptr, gr, nullptr, io.d, cells, x, scratch,
                     st);
  }
  return none;
}

}  // namespace

template <typename T, int P>
int shape_fused_block(int rung, int dense, int cofactor,
                      const OpTables<T>& tb, const Grid& gr,
                      const CellIo<T>& io, T* h2, T* scal2, T* cells,
                      T* partials, void* scratch, cudaStream_t st,
                      int passes) {
  const auto none = static_cast<cudaError_t>(-1);
  if (io.prec_bf16 || io.x_bf16 || (tb.gmetric && tb.metric_bf16))
    return none;
  if constexpr (!std::is_same_v<T, float>) {
    if (io.bf16) return none;
  }
  cudaError_t e = cudaSuccess;
  if (passes & kCellPass) {
    if constexpr (std::is_same_v<T, float>) {
      e = io.bf16 ? block_cells<T, P, kSbState>(rung, dense, cofactor, tb,
                                                gr, io, cells, scratch, st)
                  : block_cells<T, P, 0>(rung, dense, cofactor, tb, gr, io,
                                         cells, scratch, st);
    } else {
      e = block_cells<T, P, 0>(rung, dense, cofactor, tb, gr, io, cells,
                               scratch, st);
    }
  }
  if (e != cudaSuccess || !(passes & kNodePasses)) return e;
  const int nb = node_blocks(gr);
  if constexpr (std::is_same_v<T, float>) {
    if (io.bf16) {
      assemble_kernel<T, P, true, __nv_bfloat16, false, true, 1>
          <<<nb, kNodeThreads, 0, st>>>(
              gr, cells, reinterpret_cast<__nv_bfloat16*>(h2), io.g2,
              reinterpret_cast<const __nv_bfloat16*>(io.d2), io.prec,
              partials);
    }
  }
  if (!io.bf16)
    assemble_kernel<T, P, true, T, false, true, 1>
        <<<nb, kNodeThreads, 0, st>>>(gr, cells, h2, io.g2, io.d2, io.prec,
                                      partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  finalize_kernel<T, true><<<1, kNodeThreads, 0, st>>>(partials, nb, io.scal,
                                                       scal2);
  return cudaGetLastError();
}

template <int P>
cudaError_t shape_block_carry(const Grid& gr, const float* cells,
                              float* carry, cudaStream_t st) {
  const int nb = (gr.ny * gr.nx + kNodeThreads - 1) / kNodeThreads;
  block_carry_kernel<P, 1><<<nb, kNodeThreads, 0, st>>>(gr, cells, carry);
  return cudaGetLastError();
}

#define BP4_SHAPE_BLOCK(T, P)                                               \
  template int shape_fused_block<T, P>(                                     \
      int, int, int, const OpTables<T>&, const Grid&, const CellIo<T>&, T*, \
      T*, T*, T*, void*, cudaStream_t, int);
BP4_SHAPE_BLOCK(float, BP4_DEGREE)
BP4_SHAPE_BLOCK(double, BP4_DEGREE)
template cudaError_t shape_block_carry<BP4_DEGREE>(const Grid&, const float*,
                                                   float*, cudaStream_t);

}  // namespace bp4
