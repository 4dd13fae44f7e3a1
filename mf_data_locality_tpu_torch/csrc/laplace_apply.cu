// The apply family of the BP4 operator for Hopper (sm_90a): v = sum_e
// M_e^T G_ef M_f u per cell, on cell batches (B3, B4) and on the lattice
// (B5, B6), and its C interface.
//
// Replace the TPU kernels of mf_data_locality_tpu/ops/laplace_pallas.py:
//   B3  apply_local_batched, precomputed metric -> _kernel_g   (pallas_call :1023)
//   B4  apply_local_batched, metric on the fly  -> _kernel     (pallas_call :1043)
//   B5  apply_lattice_pieces -> _kernel_g_pieces                (pallas_call :947)
//   B6  apply_lattice_zslab  -> _kernel_g_zslab                 (pallas_call :664)
//
// Which cell pass runs (precision: laplace_pallas._mm):
//   B3, B5, B6  "highest", f32 or f64, p=1..11: the sum-factorized pass on
//               the CUDA cores with the metric streamed, apply_sumfac.cuh;
//               f32 "split2m", "split3", "bf16": the tensor-core pass,
//               at p=1..4 apply_mma.cuh (split3's and bf16's built in
//               mma_rungs.cu), at p=5..11 apply_mma_hd.cuh (its
//               instantiations in apply_mma_p05.cu .. apply_mma_p11.cu,
//               built once per rung; the caller's scratch holds its
//               operands' fragments); their metric may be streamed in bf16
//               under split3 and bf16;
//   B4          every rung, exact at the working type as _kernel
//               (Precision.HIGHEST, :529), p=1..11: the sum-factorized pass
//               with the metric rebuilt per (cell, q-point) from the 24
//               trilinear coefficients by the adjj chain (_kernel has no
//               other), apply_sumfac.cuh.
// A bf16 state (the merged and baseline solvers' with --dtype bf16, every
// rung; laplace_pallas.py's kernels with a bf16 u): the cell passes'
// storage instantiations (bp4_operator.cuh's kSbState; apply_sumfac.cuh's
// SB, the tensor-core passes' NP) read u in bf16 and compute in f32; B3
// and B4 store their cell results rounded to bf16 (the TPU kernels'
// out_ref in u's dtype), which laplace_apply.from_cell_batches then sums
// in bf16 axis by axis, as _from_cell_batches does; B5 and B6 keep their
// f32 cell results and assemble_bf16_kernel sums each node at the TPU
// kernels' rounding points (the z carry at f32, then each y/x sum in
// bf16, in B5's or B6's order).  A bf16 metric under highest and split2m
// (kSbMetric) comes with the same instantiations, its storage fixed at
// compile time; split3's and bf16's read it by metric_bf16, as before.
//
// At the shapes beyond BP4's (one component, CEED BP3; Q = P + 1;
// shapes.cuh): highest (and B4 on every rung) the sum-factorized pass,
// split2m apply_mma_hd.cuh's dense pass at every degree (shapes.cu); at
// one component also with the bf16 state (the same rounding points) and
// B5/B6 on a block's lattice (the ranks' windowings).
//
// B5 and B6 write masked cell-local values to scratch; the assemble pass
// (bp4_operator.cuh) then sums each node's <= 8 contributions in a fixed
// order (no atomics), and zeroes the box's faces — or, on a block of a
// global lattice (a rank's slab, a layer range of it; the mask tensor's
// operator, laplace_cuda.OperatorData.slab), only sums: the mask applied
// in the cell pass, its faces hold the partial sums the halo exchange
// completes (the JAX slab operator's mask_mode "none").  The TPU kernels walk z-cell layers in order carrying
// the shared z plane in VMEM; the assemble pass takes the carry's place, so
// blocks run in any order.  The passes' notes give their bounds.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() (0 on success),
// or -1 for a configuration with no instantiation.

#include <type_traits>

#include "apply_mma.cuh"
#include "apply_mma_hd.cuh"
#include "apply_sumfac.cuh"
#include "bp4_operator.cuh"
#include "shapes.cuh"

namespace bp4 {

// The cell pass of B3, B5 and B6 (streamed metric): under a tensor-core
// rung (rung = its products a tile, 1..3; f64 split2m alone) the
// tensor-core pass, whose m0/m1 are the dense M's bf16 fragment tables,
// from p=5 (f64: at every degree) with `scratch` (dense_hd_scratch_len);
// under highest (rung 0) the
// sum-factorized pass, whose m0/m1 are S and D (Q, P1).  metric_bf16: the
// metric in bf16; state_bf16: u (and B3's output) in bf16 (both f32
// only).
template <typename T, int P, bool LATTICE>
cudaError_t metric_pass(int rung, int metric_bf16, int state_bf16,
                        const void* m0, const void* m1, const void* gmetric,
                        const Grid& gr, const void* mask, const void* u,
                        void* out, void* scratch, cudaStream_t st) {
  constexpr int FORM = LATTICE ? kLattice : kCellBatch;
  const auto gm = static_cast<const T*>(gmetric);
  const auto mm = static_cast<const T*>(mask);
  const auto uu = static_cast<const T*>(u);
  const auto oo = static_cast<T*>(out);
  const auto none = static_cast<cudaError_t>(-1);
  if (!rung) {
    SumfacArgs<T> a{static_cast<const T*>(m0), static_cast<const T*>(m1), gm};
    a.mask = mm;
    a.io.d = uu;
    a.io.bf16 = state_bf16;
    a.out = oo;
    if constexpr (std::is_same_v<T, float>) {
      if (metric_bf16)
        return launch_sumfac<T, P, FORM, false, kSbState | kSbMetric>(a, gr,
                                                                      st);
      if (state_bf16)
        return launch_sumfac<T, P, FORM, false, kSbState>(a, gr, st);
    }
    if (metric_bf16 || state_bf16) return none;
    return launch_sumfac<T, P, FORM, false>(a, gr, st);
  }
  if constexpr (std::is_same_v<T, float>) {
    return with_rung(rung, [&](auto np) {
      constexpr int NP = decltype(np)::value;
      MmaFusedArgs x{};
      x.metric_bf16 = metric_bf16;
      x.io.bf16 = state_bf16;
      // the instantiation: split2m's bf16 metric, or a bf16 state the
      // rung's own does not read (the bf16 rung's lattice form reads it
      // by io.bf16), or the rung's own
      auto run = [&](auto sb) {
        constexpr int NPS = NP | decltype(sb)::value;
        if constexpr (P <= 4)
          return launch_mma<P, FORM, false, NPS>(m0, m1, gm, gr, mm, uu, oo,
                                                 x, st);
        else
          return launch_mma_hd<P, FORM, false, NPS>(m0, m1, gm, gr, mm, uu,
                                                    oo, x, scratch, st);
      };
      if constexpr (NP == 2) {
        if (metric_bf16)
          return run(std::integral_constant<int, kSbState | kSbMetric>{});
      }
      if constexpr (NP != 1 || !LATTICE) {
        if (state_bf16) return run(std::integral_constant<int, kSbState>{});
      }
      return run(std::integral_constant<int, 0>{});
    });
  } else {
    // the f64 form of split2m (kF64Apply: the products summed in f64),
    // apply_mma_hd.cuh's pass at every degree (mma_f64.cu), its f64
    // tensors in the pass's float-typed parameters
    if (rung != 2 || metric_bf16 || state_bf16) return none;
    return launch_mma_hd<P, FORM, false, kF64Apply>(
        m0, m1, reinterpret_cast<const float*>(gm), gr,
        reinterpret_cast<const float*>(mm), reinterpret_cast<const float*>(uu),
        reinterpret_cast<float*>(oo), MmaFusedArgs{}, scratch, st);
  }
}

// B4: the sum-factorized pass with the metric rebuilt, on a cell batch;
// s, d are S and D (Q, P1), coeffs (24, n_cells).
template <typename T, int P>
cudaError_t rebuilt_pass(const void* s, const void* d, const void* pds,
                         const void* w3, const void* coeffs, const Grid& gr,
                         const void* u, void* out, int state_bf16,
                         cudaStream_t st) {
  SumfacArgs<T> a{static_cast<const T*>(s), static_cast<const T*>(d), nullptr,
                  static_cast<const T*>(pds), static_cast<const T*>(w3),
                  static_cast<const T*>(coeffs)};
  a.io.d = static_cast<const T*>(u);
  a.io.bf16 = state_bf16;
  a.out = static_cast<T*>(out);
  a.cofactor = kAdjj;
  if constexpr (std::is_same_v<T, float>) {
    if (state_bf16)
      return launch_sumfac<T, P, kCellBatch, true, kSbState>(a, gr, st);
  }
  if (state_bf16) return static_cast<cudaError_t>(-1);
  return launch_sumfac<T, P, kCellBatch, true>(a, gr, st);
}

// B3 (metric streamed) and B4 (onthefly) on a cell batch (C P13, n_cells).
// mats/kmats: the tables of metric_pass (B3); S and D (B4).
// shape: 0 BP4's, else the shape flags of shapes.cuh (no bf16 metric; the
// bf16 state at kShC1 only).
template <int P>
int batched_for_degree(int dtype, int rung, int shape, int onthefly,
                       int metric_bf16, int state_bf16, const void* mats,
                       const void* kmats, const void* gmetric,
                       const void* pds, const void* w3, const void* coeffs,
                       const void* u, void* v, void* scratch, int n_cells,
                       cudaStream_t st) {
  const Grid gr{1, 1, n_cells, 1, 1, 1};
  if (shape) {  // the bf16 state at one component: f32 (with_shape_state)
    if (metric_bf16) return -1;
    if (dtype == 0)
      return with_shape_state<float>(shape, state_bf16, [&](auto sh) {
        return shape_batched<float, P, decltype(sh)::value>(
            rung, onthefly, mats, kmats, gmetric, pds, w3, coeffs, gr, u, v,
            scratch, st);
      });
    if (dtype == 1)
      return with_shape_state<double>(shape, state_bf16, [&](auto sh) {
        return shape_batched<double, P, decltype(sh)::value>(
            rung, onthefly, mats, kmats, gmetric, pds, w3, coeffs, gr, u, v,
            scratch, st);
      });
    return -1;
  }
  if (dtype == 0)
    return onthefly  // B4 is exact on every rung
               ? rebuilt_pass<float, P>(mats, kmats, pds, w3, coeffs, gr, u, v,
                                        state_bf16, st)
               : metric_pass<float, P, false>(rung, metric_bf16, state_bf16,
                                              mats, kmats, gmetric, gr,
                                              nullptr, u, v, scratch, st);
  if (dtype == 1)
    return onthefly
               ? rebuilt_pass<double, P>(mats, kmats, pds, w3, coeffs, gr, u,
                                         v, state_bf16, st)
               : metric_pass<double, P, false>(rung, metric_bf16, state_bf16,
                                               mats, kmats, gmetric, gr,
                                               nullptr, u, v, scratch, st);
  return -1;
}

// B5 (mask null: the box's Dirichlet mask from the indices) and B6 (mask
// tensor) on the lattice: the cell pass into the scratch `cells`, then the
// assemble pass.  mats/kmats: the tables of metric_pass.  block: a block's
// lattice (with a mask tensor), assembled without the box's faces (the
// assemble pass's BLOCK on a Grid whose lo and hi take in every node).
// state: 0 at T; 1 bf16, B6's y/x sums; 2 bf16, B5's (assemble_bf16_kernel).
// shape: 0 BP4's, else the shape flags of shapes.cuh (no bf16 metric; a
// bf16 state or a block at kShC1 only).
// B5/B6 at a shape beyond BP4's: the cell pass and the assemble pass
// (shapes.cu), u and v in bf16 where `state` is set (1: summed as B6, 2:
// as B5), on a block's lattice where `block` is set
template <typename T, int P>
int lattice_shape(int rung, int shape, int state, const void* mats,
                  const void* kmats, const void* gmetric, const void* mask,
                  const void* u, void* cells, void* v, void* scratch,
                  const Grid& gr, int block, cudaStream_t st) {
  return with_shape_state<T>(shape, state, [&](auto sh) {
    constexpr int SH = decltype(sh)::value;
    const cudaError_t e = shape_lattice_cells<T, P, SH>(
        rung, mats, kmats, gmetric, gr, mask, u, cells, scratch, st);
    if (e != cudaSuccess) return e;
    return shape_lattice_nodes<T, P, SH>(gr, cells, v, state == 2, block,
                                         st);
  });
}

template <typename T, int P>
int lattice_typed(int rung, int shape, int metric_bf16, int state,
                  const void* mats, const void* kmats, const void* gmetric,
                  const void* mask, const void* u, void* cells, void* v,
                  void* scratch, const Grid& gr, int block, cudaStream_t st) {
  if (shape)
    return metric_bf16 ? -1
                       : lattice_shape<T, P>(rung, shape, state, mats, kmats,
                                             gmetric, mask, u, cells, v,
                                             scratch, gr, block, st);
  const cudaError_t e = metric_pass<T, P, true>(
      rung, metric_bf16, state != 0, mats, kmats, gmetric, gr, mask, u,
      cells, scratch, st);
  if (e != cudaSuccess) return e;
  if (state) {
    if constexpr (std::is_same_v<T, float>) {
      const auto c = static_cast<const float*>(cells);
      const auto h = static_cast<__nv_bfloat16*>(v);
      const int nb = node_blocks(gr);
      if (state == 2 && block)
        assemble_bf16_kernel<P, true, true><<<nb, kNodeThreads, 0, st>>>(gr, c,
                                                                        h);
      else if (state == 2)
        assemble_bf16_kernel<P, true, false><<<nb, kNodeThreads, 0, st>>>(gr,
                                                                         c, h);
      else if (block)
        assemble_bf16_kernel<P, false, true><<<nb, kNodeThreads, 0, st>>>(gr,
                                                                         c, h);
      else
        assemble_bf16_kernel<P, false, false><<<nb, kNodeThreads, 0, st>>>(
            gr, c, h);
      return cudaGetLastError();
    }
    return -1;
  }
  if (block) {
    Grid all = gr;
    all.zlo = all.ylo = all.xlo = 0;
    all.zhi = gr.nz;
    all.yhi = gr.ny;
    all.xhi = gr.nx;
    assemble_kernel<T, P, false, T, false, true>
        <<<node_blocks(gr), kNodeThreads, 0, st>>>(
            all, static_cast<const T*>(cells), static_cast<T*>(v), nullptr,
            nullptr, nullptr, nullptr);
  } else {
    assemble_kernel<T, P, false, T><<<node_blocks(gr), kNodeThreads, 0, st>>>(
        gr, static_cast<const T*>(cells), static_cast<T*>(v), nullptr,
        nullptr, nullptr, nullptr);
  }
  return cudaGetLastError();
}

template <int P>
int lattice_for_degree(int dtype, int rung, int shape, int metric_bf16,
                       int state, const void* mats, const void* kmats,
                       const void* gmetric, const void* mask, const void* u,
                       void* cells, void* v, void* scratch, const Grid& gr,
                       int block, cudaStream_t st) {
  if (dtype == 0)
    return lattice_typed<float, P>(rung, shape, metric_bf16, state, mats,
                                   kmats, gmetric, mask, u, cells, v, scratch,
                                   gr, block, st);
  if (dtype == 1)
    return lattice_typed<double, P>(rung, shape, metric_bf16, state, mats,
                                    kmats, gmetric, mask, u, cells, v,
                                    scratch, gr, block, st);
  return -1;
}

}  // namespace bp4

// dtype: 0 = float32, 1 = float64.  rung: 0 "highest", else the products a
// tile of a tensor-core rung (1 bf16, 2 split2m, 3 split3).  Instantiated:
// "highest" f32 and f64 at degrees 1..11 (B3, B5, B6: the sum-factorized
// pass, mats = S, kmats = D), f64 split2m at degrees 1..11 (the metric and
// u at f64, scratch at every degree; neither metric_bf16 nor a bf16
// state), the f32 tensor-core rungs at degrees 1..11
// (B3, B5, B6: the tensor-core pass, mats/kmats = its forward and backward
// fragment tables, split3's Ml tables after them; from p=5 scratch holds
// bp4_dense_scratch_len 16-byte words, else it is unused); B4 (onthefly: the
// sum-factorized pass, mats = S, kmats = D, pds (Q3, 24), w3, coeffs (24,
// n_cells)) at degrees 1..11 ignores the rung.  metric_bf16: the streamed
// metric in bf16 (f32, every rung).  state_bf16 (bp4_apply_batched):
// u and v in bf16 (f32 only, every rung, B4 too); state
// (bp4_apply_lattice): 0 u and v at the working type, 1 in bf16 with B6's
// sums, 2 in bf16 with B5's (the cells scratch stays f32).  shape: 0
// BP4's (C = 3, Q = P + 2), else the shape flags of shapes.cuh (kShC1 one
// component, kShQ1 Q = P + 1): highest (f32, f64) and split2m, B4 on every
// rung, the metric unrounded; at kShC1 also u and v in bf16 (f32) and a
// block.
#define BP4_SWITCH_DEGREE(F)     \
  switch (degree) {              \
    case 1: return F(1);         \
    case 2: return F(2);         \
    case 3: return F(3);         \
    case 4: return F(4);         \
    case 5: return F(5);         \
    case 6: return F(6);         \
    case 7: return F(7);         \
    case 8: return F(8);         \
    case 9: return F(9);         \
    case 10: return F(10);       \
    case 11: return F(11);       \
  }

extern "C" {

// The scratch of the dense tensor-core pass at degrees 5..11 (B3, B5, B6,
// B1/B2 dense) under the rung with `rung` products a tile, and at every
// degree under split2m at a shape beyond BP4's (`shape`, shapes.cuh) and
// in its f64 form (`rung` 2 | kF64, 130), for n_cells cells, in 16-byte
// words; 0 where the pass needs none.
int bp4_dense_scratch_len(int rung, int degree, int shape, int n_cells) {
  if (shape) {
    if (rung != 2) return 0;
#define BP4_SHAPE_SCRATCH(P)                                                  \
  static_cast<int>(shape == bp4::kShC1                                        \
                       ? bp4::shape_dense_scratch_len<P, bp4::kShC1>(n_cells) \
                   : shape == bp4::kShQ1                                      \
                       ? bp4::shape_dense_scratch_len<P, bp4::kShQ1>(n_cells) \
                       : bp4::shape_dense_scratch_len<P, bp4::kShMask>(       \
                             n_cells))
    if (shape != bp4::kShC1 && shape != bp4::kShQ1 && shape != bp4::kShMask)
      return 0;
    BP4_SWITCH_DEGREE(BP4_SHAPE_SCRATCH)
#undef BP4_SHAPE_SCRATCH
    return 0;
  }
#define BP4_SCRATCH(P)                                                 \
  static_cast<int>(                                                    \
      rung == 1   ? bp4::dense_hd_scratch_len<P, 1>(n_cells)           \
      : rung == 2 ? bp4::dense_hd_scratch_len<P, 2>(n_cells)           \
                  : bp4::dense_hd_scratch_len<P, 3>(n_cells))
  if (rung == (2 | bp4::kF64)) {  // the f64 form: at every degree
    rung = 2;
    BP4_SWITCH_DEGREE(BP4_SCRATCH)
    return 0;
  }
  if (rung < 1 || rung > 3) return 0;
  switch (degree) {
    case 5: return BP4_SCRATCH(5);
    case 6: return BP4_SCRATCH(6);
    case 7: return BP4_SCRATCH(7);
    case 8: return BP4_SCRATCH(8);
    case 9: return BP4_SCRATCH(9);
    case 10: return BP4_SCRATCH(10);
    case 11: return BP4_SCRATCH(11);
  }
#undef BP4_SCRATCH
  return 0;
}

int bp4_apply_batched(int dtype, int rung, int degree, int shape,
                      int onthefly, int metric_bf16, int state_bf16,
                      const void* mats,
                      const void* kmats,
                      const void* gmetric, const void* pds, const void* w3,
                      const void* coeffs, const void* u, void* v,
                      void* scratch, int n_cells, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define BP4_BATCHED(P)                                                       \
  bp4::batched_for_degree<P>(dtype, rung, shape, onthefly, metric_bf16,     \
                             state_bf16, mats, kmats, gmetric, pds, w3,      \
                             coeffs, u, v, scratch, n_cells, st)
  BP4_SWITCH_DEGREE(BP4_BATCHED)
#undef BP4_BATCHED
  return -1;
}

// block: the lattice is a block of a global one (a rank's, with its mask
// tensor): the assemble pass only sums, the faces keep their partial sums.
int bp4_apply_lattice(int dtype, int rung, int metric_bf16, int state,
                      int degree, int shape, const void* mats,
                      const void* kmats,
                      const void* gmetric,
                      const void* mask, const void* u, void* cells, void* v,
                      void* scratch, int ncz, int ncy, int ncx, int block,
                      void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const bp4::Grid gr = bp4::box_grid(degree, ncz, ncy, ncx);
  if (block && !mask) return -1;
#define BP4_LATTICE(P)                                                      \
  bp4::lattice_for_degree<P>(dtype, rung, shape, metric_bf16, state, mats,   \
                             kmats,                                          \
                             gmetric, mask, u, cells, v, scratch, gr, block, \
                             st)
  BP4_SWITCH_DEGREE(BP4_LATTICE)
#undef BP4_LATTICE
  return -1;
}

}  // extern "C"
