// The dense tensor-core cell pass of B1/B2 at p=1..4 (apply_mma.cuh) with
// the metric rebuilt by the jtj chain (NP | kJtjChain: B1, B2 and B2 with
// P or x in bf16; BP4_MMA_JTJ_RUNG) under the rung BP4_RUNG.  Built once
// per rung (ops/_build.py), in parallel with the other sources; the adjj
// instantiations stay where they were, the storage forms are mma_sb.cu's,
// and from p=5 the jtj forms are apply_mma_pNN.cu's.

#include "apply_mma.cuh"

namespace bp4 {

BP4_MMA_JTJ_RUNG(1, BP4_RUNG, BP4_MMA_DEFINE1)
BP4_MMA_JTJ_RUNG(2, BP4_RUNG, BP4_MMA_DEFINE1)
BP4_MMA_JTJ_RUNG(3, BP4_RUNG, BP4_MMA_DEFINE1)
BP4_MMA_JTJ_RUNG(4, BP4_RUNG, BP4_MMA_DEFINE1)

}  // namespace bp4
