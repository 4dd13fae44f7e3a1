// The sum-factorized pass (apply_sumfac.cuh) at degree 6, in its six
// forms and both types: one source a degree, so that nvcc builds the
// degrees in parallel (ops/_build.py); laplace_apply.cu and cg_fused.cu
// call them.

#include "apply_sumfac.cuh"

namespace bp4 {

BP4_SUMFAC_DEGREE(6)

}  // namespace bp4
