// The storage instantiations of the dense tensor-core cell pass at p=5..11
// (apply_mma_hd.cuh; apply_mma.cuh's BP4_MMA_SB_RUNG*: the bf16 state, B3
// at every rung and B5/B6/B1/B2 at split2m and split3, B1/B2 also with the
// metric rebuilt by jtj, BP4_MMA_JTJ_SB_RUNG*, and at split2m the bf16
// metric) under the rung BP4_RUNG at the degree BP4_DEGREE
// (undefined: every degree 5..11).  Built once per rung and degree
// (ops/_build.py), in parallel with the other sources; the instantiations
// without the flags stay in apply_mma_p05.cu .. apply_mma_p11.cu.

#include "apply_mma_hd.cuh"

namespace bp4 {

#ifdef BP4_DEGREE
BP4_CAT(BP4_MMA_SB_RUNG, BP4_RUNG)(BP4_DEGREE, BP4_MMA_HD_DEFINE1)
BP4_CAT(BP4_MMA_JTJ_SB_RUNG, BP4_RUNG)(BP4_DEGREE, BP4_MMA_HD_DEFINE1)
#else
BP4_CAT(BP4_MMA_SB_RUNG, BP4_RUNG)(5, BP4_MMA_HD_DEFINE1)
BP4_CAT(BP4_MMA_SB_RUNG, BP4_RUNG)(6, BP4_MMA_HD_DEFINE1)
BP4_CAT(BP4_MMA_SB_RUNG, BP4_RUNG)(7, BP4_MMA_HD_DEFINE1)
BP4_CAT(BP4_MMA_SB_RUNG, BP4_RUNG)(8, BP4_MMA_HD_DEFINE1)
BP4_CAT(BP4_MMA_SB_RUNG, BP4_RUNG)(9, BP4_MMA_HD_DEFINE1)
BP4_CAT(BP4_MMA_SB_RUNG, BP4_RUNG)(10, BP4_MMA_HD_DEFINE1)
BP4_CAT(BP4_MMA_SB_RUNG, BP4_RUNG)(11, BP4_MMA_HD_DEFINE1)
#endif

}  // namespace bp4
