// BP4 matvec (B1) and fused merged-CG iteration (B2) kernels for Hopper.
//
// Replace the TPU kernels of mf_data_locality_tpu/ops/cg_fused_kernel.py:
//   B1  piece_vmult -> _matvec_kernel        (pallas_call at :1116)
//   B2  fused_cg_iteration -> _fused_cg_kernel (pallas_call at :1476)
// at degrees 1..11, in the configurations of laplace_cuda.fused_configs
// (the JAX auto-dispatch's among them): the dense factorization or
// twostage, the metric streamed or rebuilt by the adjj or the jtj chain
// (bp4_operator.cuh).
//
// State is the lattice (C, Nz, Ny, Nx), not the TPU's corner-piece rows.
// The TPU kernels walk z-cell layers in order on one core and carry the
// shared z plane and the dot partials from one grid step to the next; the
// H100 runs blocks in no order, so each apply is split into passes:
//
//   cells     one block per 8 f32 or 4 f64 cells (tensor cores: below):
//             (B2: update4b at the cells' nodes, the owning cell writes x',
//             g', d') then the cell operator; writes the masked cell-local
//             result to scratch (C, n_cells, (P+1)^3).
//   assemble  one thread per lattice node: sums its <= 8 cell contributions
//             in a fixed order, masks, writes h (replaces the TPU's lane-roll
//             consistency and z carry plane, cg_fused_kernel.py:869-905);
//             B2 also writes per-block partials of the 7 update3b dots.
//   finalize  (B2) one block: reduces the partials in a fixed order and runs
//             the merged-CG scalar recurrence (solver_cg_optimized.h:249-295).
//
// No atomics anywhere, so every result is bitwise reproducible run to run.
// B2 reads state buffers A and writes buffers B (the caller swaps them each
// iteration): the TPU's in-place update relied on its sequential grid to
// read each +1 plane before it was overwritten (cg_fused_kernel.py:820-829).
//
// The cell pass, by configuration:
//   "highest" (f32, f64), any factorization and metric source, p=1..11:
//     the sum-factorized pass of apply_sumfac.cuh in its lattice forms
//     (B1: the gather masked from the indices, as B5; B2: update4b at the
//     gathered nodes), 8 f32 (4 f64) cells a block (fewer from p=7), the
//     metric streamed or rebuilt from the coefficients by either chain.
//     Under "highest" the dense and twostage operators are one function;
//     this pass sums it in its own order.
//   f64 "split2m" (bp4_operator.cuh's kF64): the dense pass of
//     apply_mma_hd.cuh and the twostage one of cell_mma_hd.cuh at every
//     degree 1..11, the metric streamed or rebuilt by either chain, the
//     products' chains summed in f32 and met by the f64 metric, as
//     cg_fused_kernel._mm_pre sums them (mma_f64.cu, one object a degree);
//   f32 "split2m", "split3", "bf16" (the tensor-core rungs, a template
//   parameter NP of each pass: the products a tile, mma.cuh; split2m's
//   instantiated here, the others in mma_rungs.cu and cell_mma_pNN.cu):
//   - dense, p=1..4: the tensor-core pass of apply_mma.cuh in its lattice
//     forms, 32 cells a block, the metric streamed or rebuilt (adjj, or
//     jtj in the kJtjChain instantiations of mma_jtj.cu) per chunk of 16
//     q-points into shared memory; p=5..11: that of
//     apply_mma_hd.cuh (a gather, a forward and a backward GEMM-shaped
//     kernel tiled in cells and nodes through the workspace's `scratch`;
//     built in apply_mma_p05.cu .. apply_mma_p11.cu, once per rung);
//   - twostage + onthefly (adjj or jtj), p=4: one block per 16 cells, the
//     2D stage on the tensor cores (cell_mma.cuh);
//   - twostage, p=1..3 and 5..11 (the metric rebuilt by either chain or
//     streamed) and p=4 streamed: one warp per 8 cells and component, two
//     q-planes of them the rows of the 2D stage's tensor-core tiles
//     (cell_mma_hd.cuh, degrees 1..3 and 5..11 built in cell_mma_p01.cu
//     .. cell_mma_p11.cu, once per rung).
//   On every rung (f32) the streamed metric may be bf16, and d and h too
//   (the bf16 state, B1/B2's `store`): the passes upcast them at the load,
//   d' is stored rounded and the operator takes the rounded d', and the
//   assemble pass rounds h' where it stores it and sums the stored d' and
//   h' (cg_fused_kernel.py:856, 877).  The bf16 rung's instantiations
//   read both by their flags, split3's the metric; the others run the
//   passes' storage instantiations (bp4_operator.cuh's kSbState,
//   kSbMetric: apply_sumfac.cuh's SB, the tensor-core passes' NP), built
//   in sumfac_sb.cu, mma_sb.cu, apply_mma_sb.cu and cell_mma_sb.cu.  A
//   bf16 stream's lo part is zero, so the TPU kernel's degraded product
//   sets (cg_fused_kernel._stream_parts) equal the full ones here: the
//   passes keep their products, the zero ones included.  Under a bf16 state the
//   block form's top z face also leaves at f32 (bp4_block_carry, C10).
//   In every configuration B2's preconditioner P, and x, may be bf16 (the
//   fused solver's prec_dtype, x_dtype): one more instantiation of each
//   cell pass (kLatticeUpdatePx, PX) and of the assemble pass reads them,
//   built in cg_fused_px.cu (fused_iteration_px) and the per-degree
//   sources; x' is rounded where it is stored.  B2's storage
//   instantiations are that form themselves (cg_fused.cuh's px_form), so
//   P or x in bf16 beside a bf16 state or metric adds no instantiation.
// At the shapes beyond BP4's (one component, CEED BP3; Q = P + 1;
// shapes.cuh) the cell passes of shapes.cu: highest the sum-factorized
// pass, split2m dense apply_mma_hd.cuh's and twostage cell_mma_hd.cuh's at
// every degree; the assemble pass over the shape's components.  At one
// component and Q = P + 2 (CEED BP3) also the bf16 state, and B2's block
// form (shapes_block.cu: the sum-factorized pass and the dense pass of
// apply_mma_hd.cuh, with the bf16 state too).
// Their notes give each pass's bound.  Bound of an iteration on the H100 at
// p=4, s=13: it reads x, g, d, h, P (~28 MB), writes x', g', d', h' (~26
// MB) and passes ~12 MB through the cell scratch, all close to the 50 MB
// L2; a streamed metric adds 6 Q3 words a cell (42 MB in f32); the cell
// pass takes most of the time (PERF.md).  Later: the node passes fused into
// the cell pass once a cell owns its output nodes.
//
// B2's block form (bp4_fused_iteration_block; the TPU kernel's halo, z0,
// ncz_global, recurrence=False and want_carry=True, with y_split /
// x_split, y0, x0, ncy_global, ncx_global, cg_fused_kernel.py:1200-1205,
// 1236-1266), one block of a (z), (z, y) or (z, y, x) rank mesh on each
// rank (parallel/dist_fused.py; a z-slab is a block of a (N,) mesh): the
// block's state is (C, Pz+1, Py+1, Px+1), its top face on each axis a
// ghost of the upper neighbour's face 0 (the global Dirichlet face where
// the mesh does not split the axis).  The same three passes on the
// block's Grid (bp4_operator.cuh): the Dirichlet faces by global position
// on each axis (lo, hi: face 0 only on the first block, the top face only
// at the global top, dummy cells wholly); the caller has written the
// neighbours' pre-update g, d, h face 0 into the ghost faces, edges and
// corners included, so update4b there repeats their arithmetic on the
// same inputs; the dots cover the owned nodes [0, Pz) x [0, Py) x [0, Px)
// (own); the finalize pass writes the 7 raw sums in place of the
// recurrence; and the ghost faces of h' hold the block's partial sums
// owed upward (the carries), the assemble pass's own output there.  The
// TPU kernel's lane masks of _make_consistent (y_split, x_split) exist
// for its piece layout only: on the lattice they are these ghost faces.
// Still one launch sequence, no atomics.  Its
// instantiations (kLatticeUpdateBlock of the dense passes, the assemble
// pass's BLOCK, the RAW finalize) are built in cg_fused_block.cu and the
// per-degree sources; the other forms' are untouched.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() (0 on success),
// or -1 for a configuration with no instantiation.

#include "cg_fused.cuh"
#include "shapes.cuh"

namespace bp4 {

// B1 (FUSED false) or B2 at a shape beyond BP4's (shapes.cuh), d and h in
// bf16 where `store` is set (the bf16 state, one component): its cell pass
// and assemble pass (shapes.cu), then B2's finalize pass; -1 for what the
// shapes are not built with.
template <typename T, int P, bool FUSED>
int shape_iteration(int shape, int rung, int dense, int cofactor, int store,
                    const OpTables<T>& tb, const Grid& gr,
                    const CellIo<T>& io, T* h, T* scal2, T* cells,
                    T* partials, void* scratch, cudaStream_t st) {
  const cudaError_t e = with_shape_state<T>(shape, store, [&](auto sh) {
    constexpr int SH = decltype(sh)::value;
    const cudaError_t ec = shape_cells<T, P, SH, FUSED>(
        rung, dense, cofactor, tb, gr, io, cells, scratch, st);
    if (ec != cudaSuccess) return ec;
    return shape_assemble<T, P, SH, FUSED>(gr, cells, h, io, partials, st);
  });
  if (e != cudaSuccess || !FUSED) return e;
  finalize_kernel<T><<<1, kNodeThreads, 0, st>>>(partials, node_blocks(gr),
                                                 io.scal, scal2);
  return cudaGetLastError();
}

// store: d and h (d' and h') in bf16, the bf16 state (every rung).
// shape: 0 BP4's, else the shape flags of shapes.cuh.
template <typename T, int P>
struct Launch {
  static int matvec(int rung, int shape, int dense, int cofactor, int store,
                    const OpTables<T>& tb, const Grid& gr, const T* d,
                    T* cells, T* h, void* scratch, cudaStream_t st) {
    CellIo<T> io{};
    io.d = d;
    io.bf16 = store;
    if (shape)
      return shape_iteration<T, P, false>(shape, rung, dense, cofactor, store,
                                          tb, gr, io, h, nullptr, cells,
                                          nullptr, scratch, st);
    cudaError_t e = launch_cells<T, P, false>(rung, dense, cofactor, tb, gr,
                                              io, cells, scratch, st);
    if (e != cudaSuccess) return e;
    return launch_assemble<T, P, false>(store, gr, cells, h, nullptr, nullptr,
                                        nullptr, nullptr, st);
  }

  // prec_bf16, x_bf16: P, or x and x2, in bf16 (prec_dtype, x_dtype):
  // cg_fused_px.cu's instantiations
  // block: the block form (gr a block's Grid, the 7 sums in scal2), with
  // P and x at T
  static int fused(int rung, int shape, int dense, int cofactor, int store,
                   int prec_bf16, int x_bf16, const OpTables<T>& tb,
                   const Grid& gr, const T* x, const T* g, const T* d,
                   const T* h, const T* prec, const T* scal, T* x2, T* g2,
                   T* d2, T* h2, T* scal2, T* cells, T* partials,
                   void* scratch, int block, int passes, cudaStream_t st) {
    CellIo<T> io{x, g, d, h, prec, scal, x2, g2, d2};
    io.bf16 = store;
    io.prec_bf16 = prec_bf16;
    io.x_bf16 = x_bf16;
    if (shape && block)  // one component at Q = P + 2 (shapes_block.cu)
      return shape != kShC1
                 ? -1
                 : shape_fused_block<T, P>(rung, dense, cofactor, tb, gr, io,
                                           h2, scal2, cells, partials,
                                           scratch, st, passes);
    if (shape)
      return shape_iteration<T, P, true>(shape, rung, dense, cofactor, store,
                                         tb, gr, io, h2, scal2, cells,
                                         partials, scratch, st);
    if (block)
      return prec_bf16 || x_bf16
                 ? -1
                 : fused_iteration_block<T, P>(rung, dense, cofactor, tb,
                                               gr, io, h2, scal2, cells,
                                               partials, scratch, st, passes);
    if (prec_bf16 || x_bf16)
      return fused_iteration_px<T, P>(rung, dense, cofactor, tb, gr, io, h2,
                                      scal2, cells, partials, scratch, st);
    return fused_iteration<T, P, false>(rung, dense, cofactor, tb, gr, io, h2,
                                        scal2, cells, partials, scratch, st);
  }
};

// n_components 3 (BP4's), or 1 (shapes_block.cu)
template <int P>
int launch_block_carry(int n_components, const Grid& gr, const float* cells,
                       float* carry, cudaStream_t st) {
  if (n_components == 1) return shape_block_carry<P>(gr, cells, carry, st);
  if (n_components != kComps) return -1;
  const int nb = (gr.ny * gr.nx + kNodeThreads - 1) / kNodeThreads;
  block_carry_kernel<P><<<nb, kNodeThreads, 0, st>>>(gr, cells, carry);
  return cudaGetLastError();
}

template <typename T>
OpTables<T> tables(const void* mats, const void* sz, const void* dz,
                   const void* pds, const void* w3, const void* coeffs,
                   const void* gmetric, int metric_bf16) {
  return {static_cast<const T*>(mats),   static_cast<const T*>(sz),
          static_cast<const T*>(dz),     static_cast<const T*>(pds),
          static_cast<const T*>(w3),     static_cast<const T*>(coeffs),
          static_cast<const T*>(gmetric), metric_bf16};
}

}  // namespace bp4

using bp4::Grid;
using bp4::Launch;
using bp4::tables;

namespace {

Grid make_grid(int degree, int ncz, int ncy, int ncx) {
  return bp4::box_grid(degree, ncz, ncy, ncx);
}

}  // namespace

// return F(T, P) for P = degree, 1..11
#define BP4_SWITCH_DEGREE(F, T)                          \
  switch (degree) {                                      \
    case 1: return F(T, 1);                              \
    case 2: return F(T, 2);                              \
    case 3: return F(T, 3);                              \
    case 4: return F(T, 4);                              \
    case 5: return F(T, 5);                              \
    case 6: return F(T, 6);                              \
    case 7: return F(T, 7);                              \
    case 8: return F(T, 8);                              \
    case 9: return F(T, 9);                              \
    case 10: return F(T, 10);                            \
    case 11: return F(T, 11);                            \
  }

// dtype: 0 = float32, 1 = float64.  rung: 0 "highest", else the products
// a tile of a tensor-core rung (1 bf16, 2 split2m, 3 split3).
// Instantiated: f32 and f64 "highest" at degrees 1..11 (mats unused,
// coeffs (24, n_cells)); f64 split2m, dense and twostage at degrees 1..11
// as f32's below (the dense pass's scratch at every degree), B1 and B2's
// update form only (no store, metric_bf16, prec_bf16, x_bf16, shape or
// block form); f32 on the tensor-core rungs: dense at degrees
// 1..11 (dense = 1: mats the bf16 fragment tables of the dense M, coeffs
// (24, n_cells); from p=5 scratch holds bp4_dense_scratch_len 16-byte
// words, else it is unused), and twostage at degrees 1..11 (dense = 0:
// mats the bf16 fragment tables of the 2D stage, coeffs (n_cells, 24)).
// gmetric: the streamed metric (6 Q3, n_cells), in bf16 where metric_bf16
// is set (f32, every rung), or null for the metric rebuilt from the
// coefficients by the chain `cofactor` (0 adjj, 1 jtj).
// shape: 0 BP4's (C = 3, Q = P + 2), else the shape flags of shapes.cuh
// (kShC1 one component, kShQ1 Q = P + 1): highest (f32, f64) and split2m,
// neither metric_bf16, prec_bf16 nor x_bf16 set; store (f32) and B2's
// block form at kShC1 only (shapes_block.cu: highest, and split2m dense
// with the metric streamed or rebuilt by adjj).
// store: d, h, d2, h2 in bf16 (f32, every rung).  prec_bf16
// (bp4_fused_iteration): prec in bf16; x_bf16: x and x2 in bf16 (every
// configuration above at shape 0, with store and metric_bf16 too; not in
// B2's block form).
extern "C" {

int bp4_partials_len(int degree, int ncz, int ncy, int ncx) {
  return 8 * bp4::node_blocks(make_grid(degree, ncz, ncy, ncx));
}

const char* bp4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bp4_matvec(int dtype, int rung, int degree, int shape, int dense,
               int cofactor,
               int store, int metric_bf16, const void* mats, const void* sz,
               const void* dz, const void* pds, const void* w3,
               const void* coeffs, const void* gmetric, const void* d,
               void* cells, void* h, void* scratch, int ncz, int ncy, int ncx,
               void* stream) {
  const Grid gr = make_grid(degree, ncz, ncy, ncx);
  auto st = static_cast<cudaStream_t>(stream);
#define BP4_MATVEC(T, P)                                                   \
  Launch<T, P>::matvec(                                                    \
      rung, shape, dense, cofactor, store,                                 \
      tables<T>(mats, sz, dz, pds, w3, coeffs, gmetric, metric_bf16), gr, \
      static_cast<const T*>(d), static_cast<T*>(cells), static_cast<T*>(h), \
      scratch, st)
#define BP4_DEGREES(T) BP4_SWITCH_DEGREE(BP4_MATVEC, T)
  if (dtype == 0) BP4_DEGREES(float)
  if (dtype == 1 && (!rung || rung == 2)) BP4_DEGREES(double)
#undef BP4_DEGREES
#undef BP4_MATVEC
  return -1;
}

}  // extern "C"

namespace {

// B2 on `gr` (the box; block = 1: a block's Grid, the 7 sums in scal2,
// `passes` as fused_iteration's)
int fused_entry(int dtype, int rung, int degree, int shape, int dense,
                int cofactor,
                int store, int metric_bf16, int prec_bf16, int x_bf16,
                const void* mats, const void* sz, const void* dz,
                const void* pds, const void* w3, const void* coeffs,
                const void* gmetric, const void* x, const void* g,
                const void* d, const void* h, const void* prec,
                const void* scal, void* x2, void* g2, void* d2, void* h2,
                void* scal2, void* cells, void* partials, void* scratch,
                const Grid& gr, int block, int passes, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define BP4_FUSED(T, P)                                                       \
  Launch<T, P>::fused(                                                        \
      rung, shape, dense, cofactor, store, prec_bf16, x_bf16,                 \
      tables<T>(mats, sz, dz, pds, w3, coeffs, gmetric, metric_bf16), gr,     \
      static_cast<const T*>(x), static_cast<const T*>(g),                     \
      static_cast<const T*>(d), static_cast<const T*>(h),                     \
      static_cast<const T*>(prec), static_cast<const T*>(scal),               \
      static_cast<T*>(x2), static_cast<T*>(g2), static_cast<T*>(d2),          \
      static_cast<T*>(h2), static_cast<T*>(scal2), static_cast<T*>(cells),    \
      static_cast<T*>(partials), scratch, block, passes, st)
#define BP4_DEGREES(T) BP4_SWITCH_DEGREE(BP4_FUSED, T)
  if (dtype == 0) BP4_DEGREES(float)
  if (dtype == 1 && (!rung || rung == 2)) BP4_DEGREES(double)
#undef BP4_DEGREES
#undef BP4_FUSED
  return -1;
}

}  // namespace

extern "C" {

int bp4_fused_iteration(int dtype, int rung, int degree, int shape,
                        int dense, int cofactor, int store, int metric_bf16,
                        int prec_bf16, int x_bf16, const void* mats,
                        const void* sz, const void* dz, const void* pds,
                        const void* w3, const void* coeffs,
                        const void* gmetric, const void* x, const void* g,
                        const void* d, const void* h, const void* prec,
                        const void* scal, void* x2, void* g2, void* d2,
                        void* h2, void* scal2, void* cells, void* partials,
                        void* scratch, int ncz, int ncy, int ncx,
                        void* stream) {
  return fused_entry(dtype, rung, degree, shape, dense, cofactor, store,
                     metric_bf16, prec_bf16, x_bf16, mats, sz, dz, pds, w3,
                     coeffs, gmetric, x, g, d, h, prec, scal, x2, g2, d2, h2,
                     scal2, cells, partials, scratch,
                     make_grid(degree, ncz, ncy, ncx), 0,
                     bp4::kCellPass | bp4::kNodePasses, stream);
}

// B2's block form: the arguments of bp4_fused_iteration (the shape among
// them: 0, or kShC1) on a block of ncz x ncy x ncx cells (n * degree + 1 nodes an axis, the top one a
// ghost or the Dirichlet face), then the block's lo, hi, own on z, y and
// x (bp4_operator.cuh's Grid); scal2 receives the 7 raw sums and a 0.
// Then the layer-range form: cbeg, cend the cells the cell pass runs over,
// and passes (1 the cell pass alone, 2 the assemble and finalize passes
// alone, 3 both: the iteration).  The cell pass writes x', g', d' at the
// nodes its cells own and their cell-local results, each independent of
// the range it was launched in, so two cell passes over [0, c) and
// [c, n_cells) and one node pass after them are bitwise the one call.
int bp4_fused_iteration_block(
    int dtype, int rung, int degree, int shape, int dense, int cofactor,
    int store,
    int metric_bf16, int prec_bf16, int x_bf16, const void* mats,
    const void* sz, const void* dz, const void* pds, const void* w3,
    const void* coeffs, const void* gmetric, const void* x, const void* g,
    const void* d, const void* h, const void* prec, const void* scal,
    void* x2, void* g2, void* d2, void* h2, void* scal2, void* cells,
    void* partials, void* scratch, int ncz, int ncy, int ncx, int zlo,
    int zhi, int zown, int ylo, int yhi, int yown, int xlo, int xhi,
    int xown, int cbeg, int cend, int passes, void* stream) {
  Grid gr = make_grid(degree, ncz, ncy, ncx);
  gr.cbeg = cbeg;
  gr.cend = cend;
  gr.zlo = zlo;
  gr.zhi = zhi;
  gr.zown = zown;
  gr.ylo = ylo;
  gr.yhi = yhi;
  gr.yown = yown;
  gr.xlo = xlo;
  gr.xhi = xhi;
  gr.xown = xown;
  return fused_entry(dtype, rung, degree, shape, dense, cofactor, store,
                     metric_bf16, prec_bf16, x_bf16, mats, sz, dz, pds, w3,
                     coeffs, gmetric, x, g, d, h, prec, scal, x2, g2, d2, h2,
                     scal2, cells, partials, scratch, gr, 1, passes, stream);
}

// C10: the f32 carry of B2's block form under a bf16 state
// (block_carry_kernel): after the cell pass, the assemble pass's
// unrounded sums on the block's top z face, from the cells scratch, into
// carry (C, Ny, Nx), C = n_components (3, or 1: BP3).  The block's Grid
// as bp4_fused_iteration_block's; f32.
int bp4_block_carry(int degree, int n_components, int ncz, int ncy, int ncx,
                    int zlo, int zhi, int zown, int ylo, int yhi, int yown,
                    int xlo, int xhi, int xown, const void* cells,
                    void* carry, void* stream) {
  Grid gr = make_grid(degree, ncz, ncy, ncx);
  gr.zlo = zlo;
  gr.zhi = zhi;
  gr.zown = zown;
  gr.ylo = ylo;
  gr.yhi = yhi;
  gr.yown = yown;
  gr.xlo = xlo;
  gr.xhi = xhi;
  gr.xown = xown;
  auto st = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const float*>(cells);
  const auto out = static_cast<float*>(carry);
#define BP4_CARRY(P) \
  bp4::launch_block_carry<P>(n_components, gr, c, out, st)
  switch (degree) {
    case 1: return BP4_CARRY(1);
    case 2: return BP4_CARRY(2);
    case 3: return BP4_CARRY(3);
    case 4: return BP4_CARRY(4);
    case 5: return BP4_CARRY(5);
    case 6: return BP4_CARRY(6);
    case 7: return BP4_CARRY(7);
    case 8: return BP4_CARRY(8);
    case 9: return BP4_CARRY(9);
    case 10: return BP4_CARRY(10);
    case 11: return BP4_CARRY(11);
  }
#undef BP4_CARRY
  return -1;
}

}  // extern "C"
