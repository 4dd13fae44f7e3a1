// The dense tensor-core cell pass (apply_mma_hd.cuh) at degree 11, in its
// seven configurations (B3 cell batch; B5, B6, B1 lattice with the
// metric streamed; B1 rebuilt; B2 update4b, streamed or rebuilt, and
// with P or x in bf16) at the rung BP4_RUNG (the products a tile: 1
// bf16, 2 split2m, 3 split3): one source a degree, built once per rung,
// so that nvcc builds the degrees and rungs in parallel (ops/_build.py);
// laplace_apply.cu, cg_fused.cu and cg_fused_px.cu call them.

#include "apply_mma_hd.cuh"

namespace bp4 {

BP4_MMA_HD_DEGREE(11, BP4_RUNG)

}  // namespace bp4
