// B2's block form (cg_fused.cu's header; parallel/dist_fused.py): the
// fused iteration on a block's Grid, its Dirichlet faces by global
// position (kLatticeUpdateBlock of the dense passes, interior<true>), the
// sums over the owned nodes (the assemble pass's BLOCK) returned raw
// (finalize_kernel<T, true>); also split in two, the cell pass over a
// range of cells and the node passes (the layer-range form, `passes`).
// A source of its own, so that nvcc builds it
// in parallel with cg_fused.cu.  Degrees 1..4 of the passes are built
// here, 5..11 in their own sources (sumfac_pNN.cu, apply_mma_pNN.cu),
// split3's and bf16's at p <= 4 in mma_rungs.cu.

#include "cg_fused.cuh"

namespace bp4 {

template <typename T, int P>
int fused_iteration_block(int rung, int dense, int cofactor,
                          const OpTables<T>& tb, const Grid& gr,
                          const CellIo<T>& io, T* h2, T* scal2, T* cells,
                          T* partials, void* scratch, cudaStream_t st,
                          int passes) {
  return fused_iteration<T, P, false, true>(rung, dense, cofactor, tb, gr, io,
                                            h2, scal2, cells, partials,
                                            scratch, st, passes);
}

#define BP4_FUSED_BLOCK(T, P)                                               \
  template int fused_iteration_block<T, P>(                                 \
      int, int, int, const OpTables<T>&, const Grid&, const CellIo<T>&, T*, \
      T*, T*, T*, void*, cudaStream_t, int);
#define BP4_FUSED_BLOCK_DEGREES(T)                                         \
  BP4_FUSED_BLOCK(T, 1) BP4_FUSED_BLOCK(T, 2) BP4_FUSED_BLOCK(T, 3)        \
  BP4_FUSED_BLOCK(T, 4) BP4_FUSED_BLOCK(T, 5) BP4_FUSED_BLOCK(T, 6)        \
  BP4_FUSED_BLOCK(T, 7) BP4_FUSED_BLOCK(T, 8) BP4_FUSED_BLOCK(T, 9)        \
  BP4_FUSED_BLOCK(T, 10) BP4_FUSED_BLOCK(T, 11)

BP4_FUSED_BLOCK_DEGREES(float)
BP4_FUSED_BLOCK_DEGREES(double)

}  // namespace bp4
