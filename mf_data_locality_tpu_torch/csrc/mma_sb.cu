// The storage instantiations of the tensor-core cell passes at p <= 4
// under the rung BP4_RUNG (the products a tile: 1 bf16, 2 split2m, 3
// split3) and the degree BP4_DEGREE (undefined: every degree 1..4):
// apply_mma.cuh's with the bf16 state (kSbState; B3 at every rung,
// B5/B6/B1/B2 at split2m and split3) and, at split2m, with the bf16 metric
// (kSbMetric); at p=4 cell_mma.cuh's (B1/B2 twostage, the metric rebuilt)
// and cell_mma_hd.cuh's (the metric streamed) with the bf16 state at
// split2m and split3, and the latter with the bf16 metric at split2m.
// Built once per rung and degree (ops/_build.py), so that nvcc builds
// them in parallel with the other sources; the instantiations without the
// flags stay where they were.

#include "apply_mma.cuh"
#include "cell_mma.cuh"
#include "cell_mma_hd.cuh"

namespace bp4 {

#ifdef BP4_DEGREE
BP4_CAT(BP4_MMA_SB_RUNG, BP4_RUNG)(BP4_DEGREE, BP4_MMA_DEFINE1)
#else
BP4_MMA_SB_LO(BP4_RUNG, BP4_MMA_DEFINE1)
#endif
#if !defined(BP4_DEGREE) || BP4_DEGREE == 4
#if BP4_RUNG != 1
BP4_CELL_MMA_SB(BP4_RUNG | kSbState, BP4_CELL_MMA_DEFINE1)
#endif
BP4_CAT(BP4_CELL_MMA_HD_SB_P4_RUNG, BP4_RUNG)(BP4_CELL_MMA_HD_DEFINE1)
#endif

}  // namespace bp4
