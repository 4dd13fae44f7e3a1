// The tensor-core cell passes at p <= 4 under the rung BP4_RUNG (the
// products a tile: 1 bf16, 3 split3; split2m's are instantiated where they
// are called): apply_mma.cuh's (B3, B5, B6, B1/B2 dense, p=1..4),
// cell_mma.cuh's (B1/B2 twostage with the rebuilt metric, p=4) and
// cell_mma_hd.cuh's at p=4 (B1/B2 twostage, the metric streamed), B2's
// also with P or x in bf16.  One source built once per rung
// (ops/_build.py), so that nvcc builds the rungs in parallel with the
// other sources; cg_fused.cu, cg_fused_px.cu and laplace_apply.cu call
// them.

#include "apply_mma.cuh"
#include "cell_mma.cuh"
#include "cell_mma_hd.cuh"

namespace bp4 {

BP4_MMA_RUNG(BP4_RUNG, BP4_MMA_DEFINE1)
BP4_CELL_MMA_RUNG(BP4_RUNG, BP4_CELL_MMA_DEFINE1)
BP4_CELL_MMA_HD_P4(BP4_RUNG, BP4_CELL_MMA_HD_DEFINE1)

}  // namespace bp4
