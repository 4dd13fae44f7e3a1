// The passes of B1 and B2 (cg_fused.cu's header): the cell pass by
// configuration, the assemble and finalize passes, and one B2 iteration.
// cg_fused.cu instantiates them with P and x at the working type,
// cg_fused_px.cu with P or x in bf16 (the fused solver's prec_dtype and
// x_dtype).

#pragma once

#include <type_traits>

#include "apply_mma.cuh"
#include "apply_mma_hd.cuh"
#include "apply_sumfac.cuh"
#include "bp4_operator.cuh"
#include "cell_mma.cuh"
#include "cell_mma_hd.cuh"

namespace bp4 {

// The tensor-core cell pass of B1 (FUSED false) or B2 for the
// configuration (dense, cofactor, tb.gmetric null or not) at NP, the
// rung's products a tile and the storage flags (bp4_operator.cuh): -1 for
// a configuration with no instantiation (the bf16 metric (kSbMetric) is
// streamed only; the block form runs the dense pass, its metric rebuilt by
// adjj only).  The dense pass rebuilds the metric by jtj in its
// NP | kJtjChain instantiations (mma_jtj.cu, apply_mma_pNN.cu); twostage
// runs cell_mma_hd.cuh's pass, cell_mma.cuh's at p=4 with the rebuilt
// metric.
template <typename T, int P, bool FUSED, bool PX, bool BLOCK, int NP>
cudaError_t tensor_cells(int dense, int cofactor, const OpTables<T>& tb,
                         const Grid& gr, const CellIo<T>& io, T* cells,
                         void* scratch, cudaStream_t st) {
  constexpr int FORM =
      !FUSED ? kLattice
             : (BLOCK ? kLatticeUpdateBlock
                      : (PX ? kLatticeUpdatePx : kLatticeUpdate));
  constexpr bool MB = (NP & kSbMetric) != 0;
  const auto none = static_cast<cudaError_t>(-1);
  if (dense) {
    // the forward table, then the backward one (laplace_cuda.mma_tables)
    const auto mf = reinterpret_cast<const uint2*>(tb.mats);
    const auto mb = mf + 3 * MmaShape<P>::Q3P * MmaShape<P>::P13P / 4;
    MmaFusedArgs x{tb.pds, tb.w3, tb.coeffs, io};
    x.metric_bf16 = tb.metric_bf16;
    // the metric rebuilt by the instantiation NR's chain
    const auto rebuilt = [&](auto nr) {
      constexpr int NR = decltype(nr)::value;
      if constexpr (P <= 4)
        return launch_mma<P, FORM, true, NR>(mf, mb, nullptr, gr, nullptr,
                                             io.d, cells, x, st);
      else
        return launch_mma_hd<P, FORM, true, NR>(mf, mb, nullptr, gr, nullptr,
                                                io.d, cells, x, scratch, st);
    };
    if (!tb.gmetric) {
      if constexpr (MB) {
        return none;
      } else {
        if (cofactor != kJtj)
          return rebuilt(std::integral_constant<int, NP>{});
        if constexpr (BLOCK)
          return none;
        else
          return rebuilt(std::integral_constant<int, NP | kJtjChain>{});
      }
    }
    if constexpr (P <= 4)
      return launch_mma<P, FORM, false, NP>(mf, mb, tb.gmetric, gr, nullptr,
                                            io.d, cells, x, st);
    else
      return launch_mma_hd<P, FORM, false, NP>(mf, mb, tb.gmetric, gr,
                                               nullptr, io.d, cells, x,
                                               scratch, st);
  }
  if constexpr (!BLOCK) {
    if (tb.gmetric)
      return launch_cells_mma_hd<P, FUSED, false, kAdjj, NP, PX>(tb, gr, io,
                                                                 cells, st);
    if constexpr (MB) {
      return none;
    } else if constexpr (P == 4) {
      return cofactor == kJtj
                 ? launch_cells_mma<P, FUSED, kJtj, NP, PX>(tb, gr, io, cells,
                                                            st)
                 : launch_cells_mma<P, FUSED, kAdjj, NP, PX>(tb, gr, io,
                                                             cells, st);
    } else {
      return cofactor == kJtj
                 ? launch_cells_mma_hd<P, FUSED, true, kJtj, NP, PX>(
                       tb, gr, io, cells, st)
                 : launch_cells_mma_hd<P, FUSED, true, kAdjj, NP, PX>(
                       tb, gr, io, cells, st);
    }
  }
  return none;
}

// The cell pass of B1 (FUSED false) or B2 for the configuration (rung,
// dense, cofactor, tb.gmetric null or not); each writes the masked
// cell-local result to cells[(c * n_cells + cell) * P13 + l].  rung 0:
// highest, the sum-factorized pass; 1..3: the tensor-core rungs
// (tensor_cells).  scratch: the dense tensor-core pass's at p >= 5.  PX:
// B2 with P or x in bf16 (io.prec_bf16, io.x_bf16), the passes' PX
// instantiations.  BLOCK: B2's block form (kLatticeUpdateBlock), the
// sum-factorized pass and the dense tensor-core passes only (-1 for the
// rungs' twostage and their dense jtj).  A bf16 state (io.bf16) or a bf16
// streamed metric (tb.metric_bf16) where the rung's own instantiations
// read none (the bf16 rung reads both, split3 the metric, by their
// flags): the storage instantiations (SB, NP | kSbState [| kSbMetric]),
// not built with PX, nor with the bf16 metric in the block form (-1).
template <typename T, int P, bool FUSED, bool PX = false, bool BLOCK = false>
cudaError_t launch_cells(int rung, int dense, int cofactor,
                         const OpTables<T>& tb, const Grid& gr,
                         const CellIo<T>& io, T* cells, void* scratch,
                         cudaStream_t st) {
  constexpr int FORM =
      !FUSED ? kLattice
             : (BLOCK ? kLatticeUpdateBlock
                      : (PX ? kLatticeUpdatePx : kLatticeUpdate));
  const auto none = static_cast<cudaError_t>(-1);
  const bool mbf = tb.metric_bf16 && tb.gmetric;
  if (!rung) {
    const SumfacArgs<T> a{tb.sz,     tb.dz,   tb.gmetric, tb.pds, tb.w3,
                          tb.coeffs, nullptr, io,         cells,  cofactor};
    if constexpr (std::is_same_v<T, float> && !PX) {
      if constexpr (!BLOCK) {
        if (mbf)
          return launch_sumfac<T, P, FORM, false, kSbState | kSbMetric>(
              a, gr, st);
      }
      if (io.bf16 && !mbf)
        return tb.gmetric
                   ? launch_sumfac<T, P, FORM, false, kSbState>(a, gr, st)
                   : launch_sumfac<T, P, FORM, true, kSbState>(a, gr, st);
    }
    if (mbf || io.bf16) return none;
    return tb.gmetric ? launch_sumfac<T, P, FORM, false>(a, gr, st)
                      : launch_sumfac<T, P, FORM, true>(a, gr, st);
  }
  if constexpr (std::is_same_v<T, float>) {
    return with_rung(rung, [&](auto np) {
      constexpr int NP = decltype(np)::value;
      if constexpr (NP == 2 && !PX && !BLOCK) {
        if (mbf)
          return tensor_cells<T, P, FUSED, PX, BLOCK,
                              NP | kSbState | kSbMetric>(
              dense, cofactor, tb, gr, io, cells, scratch, st);
      }
      if constexpr (NP != 1 && !PX) {
        if (io.bf16)
          return tensor_cells<T, P, FUSED, PX, BLOCK, NP | kSbState>(
              dense, cofactor, tb, gr, io, cells, scratch, st);
      }
      if ((NP != 1 && io.bf16) || (NP == 2 && mbf)) return none;
      return tensor_cells<T, P, FUSED, PX, BLOCK, NP>(dense, cofactor, tb, gr,
                                                      io, cells, scratch, st);
    });
  }
  return none;
}

// The merged-CG scalar update from the 7 sums (cg_fused_kernel.scalar_recurrence,
// solver_cg_optimized.h:249-295).  d.h = 0 (breakdown) propagates NaN into
// alpha and res2 on purpose: the solver's `res > tol` test then ends the solve.
template <typename T>
__device__ void scalar_recurrence(const T* s, const T* scal, T* out) {
  const T alpha = scal[0], beta = scal[1], parity = scal[4];
  const T alpha_n = s[6] / s[0];
  const T beta_n = alpha_n * (s[4] + alpha_n * s[5]) / s[6];
  const T res2 = s[3] + T(2) * alpha_n * s[2] + alpha_n * alpha_n * s[1];
  const T parity_next = T(1) - parity;
  const bool is_pay = (parity_next > T(0.5)) && (alpha != T(0));
  const T safe_b = beta == T(0) ? T(1) : beta;
  const T aob_n = is_pay ? alpha / safe_b : T(0);
  const T c1_n = is_pay ? alpha_n + aob_n : T(0);
  out[0] = alpha_n;
  out[1] = beta_n;
  out[2] = c1_n;
  out[3] = aob_n;
  out[4] = parity_next;
  out[5] = res2;
  out[6] = alpha;
  out[7] = beta;
}

// The finalize pass: one block reduces the assemble pass's partials in a
// fixed order and runs the scalar recurrence on the 7 sums; RAW (B2's
// block form, the TPU kernel's recurrence=False) writes the 7 sums and a 0
// instead, for the caller to correct, reduce over the ranks and run the
// recurrence on (parallel/dist_fused.py).
template <typename T, bool RAW = false>
__global__ void __launch_bounds__(kNodeThreads)
    finalize_kernel(const T* __restrict__ partials, int n_blocks,
                    const T* __restrict__ scal, T* __restrict__ scal2) {
  __shared__ T red[kDots][kNodeThreads];
  T acc[kDots] = {};
  for (int b = threadIdx.x; b < n_blocks; b += kNodeThreads)
    for (int k = 0; k < kDots; ++k) acc[k] += partials[b * 8 + k];
  block_sum(red, acc);
  if (threadIdx.x == 0) {
    T s[kDots];
    for (int k = 0; k < kDots; ++k) s[k] = red[k][0];
    if constexpr (RAW) {
      for (int k = 0; k < kDots; ++k) scal2[k] = s[k];
      scal2[kDots] = T(0);
    } else {
      scalar_recurrence(s, scal, scal2);
    }
  }
}

// The assemble pass of B1 (DOTS false) or B2 with h and d stored at T, or
// in bf16 (`store`, the bf16 state); PBF: prec in bf16; BLOCK: the block
// form's.
template <typename T, int P, bool DOTS, bool PBF = false,
          bool BLOCK = false>
cudaError_t launch_assemble(int store, const Grid& gr, const T* cells,
                            void* h, const T* g, const void* d,
                            const T* prec, T* partials, cudaStream_t st) {
  if constexpr (std::is_same_v<T, float>) {
    if (store) {
      assemble_kernel<T, P, DOTS, __nv_bfloat16, PBF, BLOCK>
          <<<node_blocks(gr), kNodeThreads, 0, st>>>(
              gr, cells, static_cast<__nv_bfloat16*>(h), g,
              static_cast<const __nv_bfloat16*>(d), prec, partials);
      return cudaGetLastError();
    }
  }
  if (store) return static_cast<cudaError_t>(-1);
  assemble_kernel<T, P, DOTS, T, PBF, BLOCK>
      <<<node_blocks(gr), kNodeThreads, 0, st>>>(
          gr, cells, static_cast<T*>(h), g, static_cast<const T*>(d), prec,
          partials);
  return cudaGetLastError();
}

// One B2 iteration (cells, assemble with the dot partials, finalize) on
// io's vectors, d and h in bf16 where io.bf16 is set (the bf16 state);
// PX: the cell pass's PX instantiation (P or x in bf16 by io.prec_bf16,
// io.x_bf16) and the assemble pass reading P in bf16 where io.prec_bf16
// is set.  BLOCK: the block form on a block's Grid (cg_fused.cu's header),
// the finalize pass writing the 7 sums to scal2 in place of the
// recurrence; `passes` (the block form's layer-range form): kCellPass the
// cell pass alone, over the Grid's cells [cbeg, cend), kNodePasses the
// assemble and finalize passes alone, both the whole iteration.
enum : int { kCellPass = 1, kNodePasses = 2 };
template <typename T, int P, bool PX, bool BLOCK = false>
int fused_iteration(int rung, int dense, int cofactor, const OpTables<T>& tb,
                    const Grid& gr, const CellIo<T>& io, T* h2, T* scal2,
                    T* cells, T* partials, void* scratch, cudaStream_t st,
                    int passes = kCellPass | kNodePasses) {
  cudaError_t e = cudaSuccess;
  if (passes & kCellPass)
    e = launch_cells<T, P, true, PX, BLOCK>(rung, dense, cofactor, tb, gr, io,
                                            cells, scratch, st);
  if (e != cudaSuccess || !(passes & kNodePasses)) return e;
  const int nb = node_blocks(gr);
  if constexpr (PX) {
    e = io.prec_bf16
            ? launch_assemble<T, P, true, true>(io.bf16, gr, cells, h2,
                                                io.g2, io.d2, io.prec,
                                                partials, st)
            : launch_assemble<T, P, true>(io.bf16, gr, cells, h2, io.g2,
                                          io.d2, io.prec, partials, st);
  } else {
    e = launch_assemble<T, P, true, false, BLOCK>(
        io.bf16, gr, cells, h2, io.g2, io.d2, io.prec, partials, st);
  }
  if (e != cudaSuccess) return e;
  finalize_kernel<T, BLOCK><<<1, kNodeThreads, 0, st>>>(partials, nb,
                                                        io.scal, scal2);
  return cudaGetLastError();
}

// fused_iteration<T, P, true>: instantiated in cg_fused_px.cu, a source of
// its own, so that nvcc builds it in parallel with cg_fused.cu.
template <typename T, int P>
int fused_iteration_px(int rung, int dense, int cofactor,
                       const OpTables<T>& tb, const Grid& gr,
                       const CellIo<T>& io, T* h2, T* scal2, T* cells,
                       T* partials, void* scratch, cudaStream_t st);

// fused_iteration<T, P, false, true>, the block form (`passes` as there):
// likewise in cg_fused_block.cu.
template <typename T, int P>
int fused_iteration_block(int rung, int dense, int cofactor,
                         const OpTables<T>& tb, const Grid& gr,
                         const CellIo<T>& io, T* h2, T* scal2, T* cells,
                         T* partials, void* scratch, cudaStream_t st,
                         int passes);

}  // namespace bp4
