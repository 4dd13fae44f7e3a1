// The cell passes of B1-B6 at the shapes beyond BP4's (C = 3 components,
// Q = P + 2 Gauss points a direction): CEED BP3, one component (kShC1),
// and the Gauss rule Q = P + 1 (kShQ1), alone or together
// (bp4_operator.cuh's shape flags).  The JAX package's Pallas kernels take
// both from their block shapes and the operator's n_q
// (mf_data_locality_tpu/ops/laplace_pallas.py, cg_fused_kernel.py), so
// the same TPU kernels are replaced here as at BP4's shape:
//   B3, B4, B5, B6  laplace_pallas.py  pallas_call :1023, :1043, :947, :664
//   B1, B2          cg_fused_kernel.py pallas_call :1116, :1476
// in the forms that the single-device solvers run (the cell batch, the
// lattice, B2's update4b) at degrees 1..11, on two rungs:
//   "highest" (f32, f64)  the sum-factorized pass (apply_sumfac.cuh), the
//                 metric streamed or rebuilt by adjj or jtj;
//   "split2m" (f32)       the dense tensor-core pass of apply_mma_hd.cuh at
//                 every degree (its C is a count of rows and warps, so one
//                 component keeps the pass's layout; apply_mma.cuh's
//                 warps are the three components of a tile, and stay
//                 BP4's), the metric streamed or rebuilt by adjj or jtj;
//                 twostage the tensor-core pass of cell_mma_hd.cuh at
//                 every degree, p=4 included (its warp is one component of
//                 8 cells and C the grid's y, so one component leaves its
//                 blocks as they were; cell_mma.cuh's block is a warp a
//                 component and a metric warp, and stays BP4's).
// The assemble and finalize passes follow as at BP4's shape, the assemble
// pass over C components (bp4_operator.cuh's NC).  At one component and
// Q = P + 2 (CEED BP3) also:
//   the bf16 state (SH's kSbState beside kShC1, f32): every pass above
//     reads d (B1/B2), u (B3-B6) and h in bf16 and rounds where the JAX
//     kernels store, as the passes' storage instantiations do at BP4's
//     shape; B5/B6 sum z at f32 and y/x in bf16 (assemble_bf16_kernel);
//   B2's block form and its layer-range form (the distributed fused
//     solver's, shapes_block.cu): the sum-factorized pass (f32, f64) and
//     the dense tensor-core pass of apply_mma_hd.cuh under split2m (the
//     metric streamed or rebuilt by adjj), each also with the bf16 state;
//     the assemble pass's BLOCK over one component, C10's carry;
//   B5/B6 on a block's lattice (the ranks' pieces and zslab windowings),
//     their assemble pass only summing.
// What stays BP4's only (queue B item 6g in ROADMAP.md): split3 and bf16,
// a bf16 metric, B2's P/x forms, a bf16 state or the block form at Q = P +
// 1, any other Q or C; the entries below return -1 for them.
//
// Each degree and shape is built in an object of its own (shapes.cu with
// -DBP4_DEGREE=p -DBP4_SHAPE=flags, the bf16 state's flags kShC1 |
// kSbState; shapes_block.cu with -DBP4_DEGREE=p; ops/_build.py), so that
// nvcc builds them in parallel with the other sources; the callers
// (cg_fused.cu, laplace_apply.cu) see these declarations only.  The
// bounds are the passes' own at BP4's shape, with C (p+1)^3 vector and
// 6 Q^3 metric words a cell (PERF.md).

#pragma once

#include <type_traits>

#include "bp4_operator.cuh"

namespace bp4 {

// f(std::integral_constant<int, SH>) for the shape flags SH of an
// instantiated shape beyond BP4's; -1 for any other.
template <typename F>
cudaError_t with_shape(int shape, F&& f) {
  switch (shape) {
    case kShC1: return f(std::integral_constant<int, kShC1>{});
    case kShQ1: return f(std::integral_constant<int, kShQ1>{});
    case kShC1 | kShQ1:
      return f(std::integral_constant<int, kShC1 | kShQ1>{});
  }
  return static_cast<cudaError_t>(-1);
}

// f(std::integral_constant<int, SH>) as with_shape, for T's vectors with
// d and h (u and v) in bf16 where `state` is set: SH kShC1 | kSbState, the
// bf16 state at one component, f32 only; -1 for any other.
template <typename T, typename F>
cudaError_t with_shape_state(int shape, int state, F&& f) {
  if (!state) return with_shape(shape, f);
  if constexpr (std::is_same_v<T, float>) {
    if (shape == kShC1)
      return f(std::integral_constant<int, kShC1 | kSbState>{});
  }
  return static_cast<cudaError_t>(-1);
}

// The cell pass of B1 (FUSED false: the lattice form) or B2 (update4b) at
// shape SH: rung 0 highest, 2 split2m; dense or twostage; the metric
// streamed (tb.gmetric) or rebuilt by `cofactor`.  Writes the masked
// cell-local results to cells (C, n_cells, (P+1)^3).  scratch: the dense
// tensor-core pass's (bp4_dense_scratch_len), else unused.
template <typename T, int P, int SH, bool FUSED>
cudaError_t shape_cells(int rung, int dense, int cofactor,
                        const OpTables<T>& tb, const Grid& gr,
                        const CellIo<T>& io, T* cells, void* scratch,
                        cudaStream_t st);

// B3 (metric streamed) and B4 (onthefly: the sum-factorized pass on every
// rung) on a cell batch (C (P+1)^3, n_cells) at shape SH; mats/kmats the
// dense tables (split2m B3) or S and D, as bp4_apply_batched's.
template <typename T, int P, int SH>
cudaError_t shape_batched(int rung, int onthefly, const void* mats,
                          const void* kmats, const void* gmetric,
                          const void* pds, const void* w3,
                          const void* coeffs, const Grid& gr, const void* u,
                          void* v, void* scratch, cudaStream_t st);

// The cell pass of B5 (mask null) and B6 (the mask tensor) at shape SH, the
// metric streamed, into cells (C, n_cells, (P+1)^3).
template <typename T, int P, int SH>
cudaError_t shape_lattice_cells(int rung, const void* mats,
                                const void* kmats, const void* gmetric,
                                const Grid& gr, const void* mask,
                                const void* u, void* cells, void* scratch,
                                cudaStream_t st);

// The assemble pass of B1 (DOTS false) or B2 at shape SH over the shape's
// components, from cells into h (bf16 under kSbState), with B2's dot
// partials; B2's finalize pass follows in cg_fused.cu.
template <typename T, int P, int SH, bool DOTS>
cudaError_t shape_assemble(const Grid& gr, const T* cells, void* h,
                           const CellIo<T>& io, T* partials, cudaStream_t st);

// The assemble pass of B5 (pieces) and B6 at shape SH into v, on a block's
// lattice (block: only summed) or the box's; under kSbState v in bf16,
// summed as B5 (pieces) or B6 sum it.
template <typename T, int P, int SH>
cudaError_t shape_lattice_nodes(const Grid& gr, const void* cells, void* v,
                                int pieces, int block, cudaStream_t st);

// The scratch of the dense tensor-core pass at shape SH, degree P and
// split2m, for n_cells cells, in 16-byte words (shapes.cu).
template <int P, int SH>
size_t shape_dense_scratch_len(int n_cells);

// B2's block form at one component (shapes_block.cu): the arguments of
// cg_fused.cuh's fused_iteration_block (its `passes`, the layer-range
// form), d and h in bf16 where io.bf16 is set (f32); rung 0 highest (f32,
// f64), 2 split2m dense (f32), the metric streamed or rebuilt by adjj.
template <typename T, int P>
int shape_fused_block(int rung, int dense, int cofactor,
                      const OpTables<T>& tb, const Grid& gr,
                      const CellIo<T>& io, T* h2, T* scal2, T* cells,
                      T* partials, void* scratch, cudaStream_t st,
                      int passes);

// C10's f32 carry of B2's block form at one component (shapes_block.cu):
// bp4_block_carry's face (1, Ny, Nx).
template <int P>
cudaError_t shape_block_carry(const Grid& gr, const float* cells,
                              float* carry, cudaStream_t st);

}  // namespace bp4
