// The storage instantiations of the twostage tensor-core cell pass of
// B1/B2 at p=1..3 and 5..11 (cell_mma_hd.cuh's
// BP4_CELL_MMA_HD_SB_RUNG*: the bf16 state at split2m and split3, and at
// split2m the bf16 metric) under the rung BP4_RUNG at the degree
// BP4_DEGREE (undefined: degrees 1..3).  Built once per rung and degree
// from p=5, once per rung for p=1..3 (ops/_build.py), in parallel with
// the other sources; the instantiations without the flags stay in
// cell_mma_p01.cu .. cell_mma_p11.cu.

#include "cell_mma_hd.cuh"

namespace bp4 {

#ifdef BP4_DEGREE
BP4_CAT(BP4_CELL_MMA_HD_SB_RUNG, BP4_RUNG)(BP4_DEGREE, BP4_CELL_MMA_HD_DEFINE1)
#else  // degrees 1..3, small instantiations: one object a rung
BP4_CAT(BP4_CELL_MMA_HD_SB_RUNG, BP4_RUNG)(1, BP4_CELL_MMA_HD_DEFINE1)
BP4_CAT(BP4_CELL_MMA_HD_SB_RUNG, BP4_RUNG)(2, BP4_CELL_MMA_HD_DEFINE1)
BP4_CAT(BP4_CELL_MMA_HD_SB_RUNG, BP4_RUNG)(3, BP4_CELL_MMA_HD_DEFINE1)
#endif

}  // namespace bp4
