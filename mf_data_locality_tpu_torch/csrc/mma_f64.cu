// The f64 form of split2m (bp4_operator.cuh's kF64: the JAX CLI's --dtype
// f64 --precision split2m) at degree BP4_DEGREE: the dense tensor-core
// pass (apply_mma_hd.cuh's BP4_MMA_HD_F64: B3, B5/B6 with the products
// summed in f64, B1 and B2 with the metric streamed or rebuilt by adjj or
// jtj, summed in f32) and the twostage one of B1/B2 (cell_mma_hd.cuh's
// BP4_CELL_MMA_HD_F64), at every degree 1..11.  One object a degree
// (ops/_build.py), in parallel with the other sources; laplace_apply.cu
// and cg_fused.cu call them.

#include "apply_mma_hd.cuh"
#include "cell_mma_hd.cuh"

namespace bp4 {

BP4_MMA_HD_F64(BP4_DEGREE, BP4_MMA_HD_DEFINE1)
BP4_CELL_MMA_HD_F64(BP4_DEGREE, BP4_CELL_MMA_HD_DEFINE1)

}  // namespace bp4
