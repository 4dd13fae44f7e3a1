// The sum-factorized pass (apply_sumfac.cuh) at degree 9, in its eight
// forms (B2's update4b also with P or x in bf16) and both types: one
// source a degree, so that nvcc builds the degrees in parallel
// (ops/_build.py); laplace_apply.cu, cg_fused.cu and cg_fused_px.cu
// call them.

#include "apply_sumfac.cuh"

namespace bp4 {

BP4_SUMFAC_DEGREE(9)

}  // namespace bp4
