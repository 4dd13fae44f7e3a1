// The storage instantiations of the twostage tensor-core cell pass of
// B1/B2 at p=5..11 (cell_mma_hd.cuh's BP4_CELL_MMA_HD_SB_RUNG*: the bf16
// state at split2m and split3, and at split2m the bf16 metric) under the
// rung BP4_RUNG at the degree BP4_DEGREE.  Built once per rung and degree
// (ops/_build.py), in parallel with the other sources; the instantiations
// without the flags stay in cell_mma_p05.cu .. cell_mma_p11.cu.

#include "cell_mma_hd.cuh"

namespace bp4 {

BP4_CAT(BP4_CELL_MMA_HD_SB_RUNG, BP4_RUNG)(BP4_DEGREE, BP4_CELL_MMA_HD_DEFINE1)

}  // namespace bp4
