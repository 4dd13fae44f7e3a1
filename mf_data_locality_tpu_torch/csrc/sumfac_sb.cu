// The sum-factorized pass's storage instantiations (apply_sumfac.cuh, SB,
// f32: the bf16 state in every form, B2's in its P/x form, with the
// metric streamed or rebuilt, and with it the bf16 metric where it is
// streamed) at degree BP4_DEGREE (undefined: 1..4): one
// object a degree from p=5 (ops/_build.py), so that nvcc builds them in
// parallel with the other sources; the instantiations without them stay
// where they were.

#include "apply_sumfac.cuh"

namespace bp4 {

#ifdef BP4_DEGREE
BP4_SUMFAC_SB_FORMS(BP4_DEGREE, BP4_SUMFAC_SB_DEFINE1)
#else
BP4_SUMFAC_SB_FORMS(1, BP4_SUMFAC_SB_DEFINE1)
BP4_SUMFAC_SB_FORMS(2, BP4_SUMFAC_SB_DEFINE1)
BP4_SUMFAC_SB_FORMS(3, BP4_SUMFAC_SB_DEFINE1)
BP4_SUMFAC_SB_FORMS(4, BP4_SUMFAC_SB_DEFINE1)
#endif

}  // namespace bp4
