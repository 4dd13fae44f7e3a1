// The split2m twostage cell pass of B1/B2 (cell_mma_hd.cuh) at degree 6,
// in its six configurations (B1, B2 x the metric streamed, rebuilt by adjj,
// rebuilt by jtj): one source a degree, so that nvcc builds the degrees in
// parallel (ops/_build.py); cg_fused.cu calls them.

#include "cell_mma_hd.cuh"

namespace bp4 {

BP4_CELL_MMA_HD_DEGREE(6)

}  // namespace bp4
