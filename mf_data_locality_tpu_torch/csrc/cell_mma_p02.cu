// The twostage tensor-core cell pass of B1/B2 (cell_mma_hd.cuh) at degree
// 2, in its nine configurations (B1, B2 x the metric streamed, rebuilt by
// adjj, rebuilt by jtj; B2 also with P or x in bf16) at the rung
// BP4_RUNG (the products a tile: 1 bf16, 2 split2m, 3 split3): one
// source a degree, built once per rung, so that nvcc builds the degrees
// and rungs in parallel (ops/_build.py); cg_fused.cu and cg_fused_px.cu
// call them.

#include "cell_mma_hd.cuh"

namespace bp4 {

BP4_CELL_MMA_HD_DEGREE(2, BP4_RUNG)

}  // namespace bp4
