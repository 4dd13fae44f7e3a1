// B2 (the fused merged-CG iteration, cg_fused.cu) with the preconditioner
// P or the solution x stored in bf16: the fused solver's prec_dtype and
// x_dtype (mf_data_locality_tpu/solvers/cg_fused.py:57-70, 127-137).
// The kernel upcasts P and x at the load and computes in the working type;
// x' is rounded where it is stored, as the JAX package does.  x feeds none
// of the g, d, h recurrences, so with x in bf16 the residual history is
// the one of x at the working type, bit for bit.
//
// Every configuration of cg_fused.cu (f32 and f64 "highest", the
// tensor-core rungs' dense and twostage passes, the bf16 state and
// metric) in one more instantiation of its cell pass each
// (kLatticeUpdatePx, PX): the flags io.prec_bf16 and io.x_bf16 are
// warp-uniform, so one instantiation serves bf16 P, bf16 x and both.  The
// instantiations with P and x at the working type are untouched, but the
// storage instantiations (the bf16 state, or metric, where the rung's own
// passes read neither), which are the P/x form for both (cg_fused.cuh's
// px_form): launched from here they read P or x in bf16, from cg_fused.cu
// both at the working type.  Bound: P is one word a node beside ~9 state
// words a DoF, x two of them, so bf16 P saves <= 2% of an iteration's
// bytes at p=4 and bf16 x ~8%.  Degrees 1..4 of the passes are built
// here, 5..11 in their own sources (sumfac_pNN.cu, cell_mma_pNN.cu,
// apply_mma_pNN.cu), split3's and bf16's at p <= 4 in mma_rungs.cu.

#include "cg_fused.cuh"

namespace bp4 {

template <typename T, int P>
int fused_iteration_px(int rung, int dense, int cofactor,
                       const OpTables<T>& tb, const Grid& gr,
                       const CellIo<T>& io, T* h2, T* scal2, T* cells,
                       T* partials, void* scratch, cudaStream_t st) {
  return fused_iteration<T, P, true>(rung, dense, cofactor, tb, gr, io, h2,
                                     scal2, cells, partials, scratch, st);
}

#define BP4_FUSED_PX(T, P)                                                  \
  template int fused_iteration_px<T, P>(                                    \
      int, int, int, const OpTables<T>&, const Grid&, const CellIo<T>&, T*, \
      T*, T*, T*, void*, cudaStream_t);
#define BP4_FUSED_PX_DEGREES(T)                                            \
  BP4_FUSED_PX(T, 1) BP4_FUSED_PX(T, 2) BP4_FUSED_PX(T, 3)                 \
  BP4_FUSED_PX(T, 4) BP4_FUSED_PX(T, 5) BP4_FUSED_PX(T, 6)                 \
  BP4_FUSED_PX(T, 7) BP4_FUSED_PX(T, 8) BP4_FUSED_PX(T, 9)                 \
  BP4_FUSED_PX(T, 10) BP4_FUSED_PX(T, 11)

BP4_FUSED_PX_DEGREES(float)
BP4_FUSED_PX_DEGREES(double)

}  // namespace bp4
