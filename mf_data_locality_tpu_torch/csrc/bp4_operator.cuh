// BP4 cell operator for Hopper (sm_90a): what the cell passes of the
// matvec (B1) and fused CG iteration (B2) in cg_fused.cu and of the apply
// family (B3-B6) in laplace_apply.cu share -- the metric rebuild
// (onthefly_metric), the lattice gather (cell_node), update4b at a cell's
// nodes (cell_input) and the assemble pass.
//
// What B1/B2 compute, per hex cell of the lattice (C = 3 components, degree
// P, Q = P + 2 Gauss points per direction: BP4; the shape flags below give
// C = 1, CEED BP3, and Q = P + 1), on the cell's (P+1)^3 node
// values u (the TPU kernel's _operator_block twostage branch with
// _metric_onthefly's adjj chain, mf_data_locality_tpu/ops/
// cg_fused_kernel.py:583-651, :178-265):
//
//   z stage     uS[qz] = sum_kz Sz[qz,kz] u[kz],  uD[qz] = sum_kz Dz[qz,kz] u[kz]
//   2D stage    gx, gy = [Dx2d; Dy2d] uS[qz],     gz = S2d uD[qz]
//   metric      J = pds . c24 (trilinear Jacobian), adj = det(J) J^-1,
//               G = w3 adj adj^T / det            (adjugate chain, "adjj"),
//               or C = J^T J, G = w3 adj(C) / sqrt(det C)  ("jtj", :219-241)
//   apply       t = G [gx, gy, gz]
//   backward    w1 = [Dx2d; Dy2d]^T [t0; t1],     w2 = S2d^T t2
//               v[kz] = sum_qz Sz[qz,kz] w1[qz] + Dz[qz,kz] w2[qz]
//   mask        v = 0 at Dirichlet nodes
//
// The "highest" rung (f32, f64) applies the same operator by 1D factors in
// x, y and z (apply_sumfac.cuh, whose note gives the tolerance); the f32
// "split2m" rung keeps the 2D stage as bf16 x bf16 products with f32
// accumulation on the tensor cores (cell_mma.cuh), because its rounding of
// the 2D entries defines that rung.  On both the Jacobian J = pds . c24 is
// exact FMA at the working type.  Deliberate difference: the TPU kernel
// evaluates it under every f32 rung as a split3 bf16 hi/lo product
// (cg_fused_kernel.py:208), whose intent is f32 class; exact f32 is that
// class without the emulation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace bp4 {

constexpr int kComps = 3;           // vector components of BP4
constexpr int kNodeThreads = 256;   // threads per block of the node passes
constexpr int kDots = 7;            // update3b sums (cg_fused_kernel.py:891)

// Input forms of the cell passes (apply_sumfac.cuh, apply_mma.cuh):
//   kCellBatch      B3, B4: u and out are cell batches (C P13, n_cells);
//   kLattice        B5, B6, B1: u is the lattice, gathered by cell_node
//                   times the mask; out the masked cell-local values
//                   (C, n_cells, P13);
//   kLatticeUpdate  B2: as kLattice, the input being update4b's d' at each
//                   (cell, node) (cell_input), whose owner cell writes x',
//                   g', d';
//   kLatticeUpdatePx  B2 as kLatticeUpdate, with P or x stored in bf16
//                   (io.prec_bf16, io.x_bf16; the fused solver's prec_dtype
//                   and x_dtype, cg_fused.py:57-70 of the JAX package).
//   kLatticeUpdateBlock  B2's block form (cg_fused_block.cu): as
//                   kLatticeUpdate on a rank's block of a (z), (z, y) or
//                   (z, y, x) rank mesh (a z-slab is a block of a (N,)
//                   mesh), its Dirichlet faces by the Grid's lo and hi on
//                   each axis (interior<true>); the dense passes only
//                   (apply_sumfac.cuh, apply_mma.cuh, apply_mma_hd.cuh), so
//                   that the other forms' instantiations stay as they were.
enum : int {
  kCellBatch = 0,
  kLattice = 1,
  kLatticeUpdate = 2,
  kLatticeUpdatePx = 3,
  kLatticeUpdateBlock = 4
};
__host__ __device__ constexpr bool is_update(int form) {
  return form >= kLatticeUpdate;
}
__host__ __device__ constexpr bool is_block(int form) {
  return form == kLatticeUpdateBlock;
}

// Shape flags of the instantiations beyond BP4's (C = 3 components, Q =
// P + 2 Gauss points a direction), in the passes' flag argument beside the
// storage flags (the sum-factorized pass's SB, the tensor-core passes'
// NP): kShC1 one component (CEED BP3), kShQ1 Q = P + 1 (the Gauss rule of
// deal.II's matrix-free programs, QGauss<dim>(fe_degree + 1)).  Without
// them a pass is the code it was; each shape's instantiations are built in
// shapes.cu, one object a degree and shape.  C is a constant of each
// instantiation: as a run-time field of CellIo, read so that one
// instantiation serves both counts, it moved the registers of five of
// BP4's P/x instantiations (PERF.md).
constexpr int kShC1 = 32, kShQ1 = 64, kShMask = kShC1 | kShQ1;

template <int P, int F = 0>
struct Shape {
  static constexpr int C = (F & kShC1) ? 1 : kComps;
  static constexpr int P1 = P + 1, Q = P + ((F & kShQ1) ? 1 : 2);
  static constexpr int P12 = P1 * P1, P13 = P12 * P1;
  static constexpr int Q2 = Q * Q, Q3 = Q2 * Q;
};

// Element i of a float array that holds bf16 values instead when `bf16` is
// set (warp-uniform): the metric stream and the bf16 state's d and h of
// the split3 and bf16 instantiations, whose storage is a runtime choice.
__device__ __forceinline__ float load_flex(const float* p, size_t i,
                                           bool bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : p[i];
}
__device__ __forceinline__ float ldg_flex(const float* p, size_t i,
                                          bool bf16) {
  return bf16 ? __bfloat162float(
                    __ldg(reinterpret_cast<const __nv_bfloat16*>(p) + i))
              : __ldg(p + i);
}
// v as it is stored: rounded to bf16 when `bf16` is set.
__device__ __forceinline__ float round_flex(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
__device__ __forceinline__ void store_flex(float* p, size_t i, float v,
                                           bool bf16) {
  if (bf16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    p[i] = v;
}
// Element i of a read-only T array (f32 or f64) that holds bf16 values
// instead when `bf16` is set (warp-uniform), upcast to T: B2's
// preconditioner and x under prec_dtype / x_dtype bf16.  In f32 one 32-bit
// load either way, of the word that holds element i (bf16: the pair
// i & ~1, i | 1), then its half or all of it: no branch around the load,
// so a batch of them issues back to back.  store_px rounds as torch's
// .to(bf16) does (an f64 value through f32).
template <typename T>
__device__ __forceinline__ T load_px(const T* p, size_t i, bool bf16) {
  if constexpr (sizeof(T) == 4) {
    const unsigned w =
        __ldg(reinterpret_cast<const unsigned*>(p) + (bf16 ? i >> 1 : i));
    return __uint_as_float(bf16 ? ((i & 1) ? (w & 0xffff0000u) : (w << 16))
                                : w);
  } else {
    return bf16 ? static_cast<T>(__bfloat162float(
                      reinterpret_cast<const __nv_bfloat16*>(p)[i]))
                : p[i];
  }
}
template <typename T>
__device__ __forceinline__ void store_px(T* p, size_t i, T v, bool bf16) {
  if (bf16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] =
        __float2bfloat16_rn(static_cast<float>(v));
  else
    p[i] = v;
}

// A value of the assemble pass's h and d stored as V (T, or bf16: the bf16
// state), and back at the working type T.
template <typename V, typename T>
__device__ __forceinline__ V to_store(T v) {
  if constexpr (std::is_same_v<V, __nv_bfloat16>)
    return __float2bfloat16_rn(v);
  else
    return v;
}
template <typename T, typename V>
__device__ __forceinline__ T to_acc(V v) {
  if constexpr (std::is_same_v<V, __nv_bfloat16>)
    return __bfloat162float(v);
  else
    return v;
}

// Storage flags of the instantiations that read a bf16 state or metric
// under a rung that had none (a template parameter: NP of the tensor-core
// passes, above the products a tile; SB of the sum-factorized pass), so
// that the instantiations without them are the code they were:
//   kSbState   the state (B3's u and output, B5/B6/B1's u, B1/B2's d and
//              h, B2's d') may be bf16, by the warp-uniform flag io.bf16
//              (B2's store flag), upcast at the load, rounded at the store;
//   kSbMetric  the streamed metric is bf16, fixed at compile time (no
//              runtime branch at the load), upcast at the load.
// And of the dense tensor-core passes' instantiations that rebuild the
// metric by the jtj chain (the adjj ones carry no flag):
//   kJtjChain  onthefly_metric<.., kJtj> in place of kAdjj.
// The tensor-core rungs' products a tile are rung_of(NP).
constexpr int kSbState = 4, kSbMetric = 8, kJtjChain = 16;
#define BP4_CAT_(a, b) a##b
#define BP4_CAT(a, b) BP4_CAT_(a, b)  // a##b after expanding both
__host__ __device__ constexpr int rung_of(int np) { return np & 3; }

// Element i of the streamed metric at storage SB: bf16 under kSbMetric,
// upcast to T.
template <int SB, typename T>
__device__ __forceinline__ T metric_ldg(const T* p, size_t i) {
  if constexpr (SB & kSbMetric)
    return static_cast<T>(__bfloat162float(
        __ldg(reinterpret_cast<const __nv_bfloat16*>(p) + i)));
  else
    return __ldg(p + i);
}

// f(std::integral_constant<int, NP>) for the tensor-core rung with NP
// products a tile (1 bf16, 2 split2m, 3 split3); -1 for any other.
template <typename F>
cudaError_t with_rung(int rung, F&& f) {
  switch (rung) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
  }
  return static_cast<cudaError_t>(-1);
}

// Read-only operator tables of B1/B2, device pointers at the working type T.
// split2m twostage (cell_mma.cuh): mats the bf16 fragment tables of the 2D
// stage, coeffs (n_cells, 24); split2m dense (apply_mma.cuh): mats the bf16
// fragment tables of the dense M, coeffs (24, n_cells), the cell fastest;
// highest (apply_sumfac.cuh): mats unused, coeffs (24, n_cells).
// Coordinate d's monomial coefficient k is entry d*8 + k of a cell.
// gmetric: the streamed metric (6 Q3, n_cells), or null: G rebuilt from the
// coefficients; stored in bf16 where metric_bf16 is set (the split3 and
// bf16 tensor-core passes read it with ldg_flex).
template <typename T>
struct OpTables {
  const T* mats;
  const T* sz;      // (Q, P1)
  const T* dz;      // (Q, P1)
  const T* pds;     // (Q3, 24): d(monomial k)/d(u_e) at e*8 + k
  const T* w3;      // (Q3,)
  const T* coeffs;
  const T* gmetric;
  int metric_bf16 = 0;
};

// The lattice of a pass.  The lo, hi, own of each axis: read by B2's
// block form only (interior<true>, the assemble pass's BLOCK): along z
// the planes z < zlo and z >= zhi hold Dirichlet nodes (or a dummy
// cell's), and the sums cover the planes [0, zown); likewise along y and
// x.  A block of a global lattice (parallel/dist_fused.py; the TPU
// kernel's z0, ncz_global and, with y_split / x_split, y0, x0,
// ncy_global, ncx_global, cg_fused_kernel.py:1200-1205, 1236-1266): on
// each axis lo = 1 on the first block and 0 after it, hi the local index
// of the global top face (<= 0 on a block of dummy cells only), own =
// n - 1 (the top face is a ghost of the upper block's face 0, which that
// block owns; on an axis the mesh does not split it is the Dirichlet top
// face, whose nodes add only zeros).  box_grid sets the box's values, 1,
// n - 1 and n on each axis.  cbeg, cend: the cells [cbeg, cend) that a
// cell pass of the block form runs over, read by those passes only (the
// layer-range form, the TPU kernel's step_range, cg_fused_kernel.py:
// 1211-1212: cells are z-major, so a range of z-layers [c0, c1) is the
// cells [c0 ncy ncx, c1 ncy ncx)); box_grid sets 0 and n_cells.
struct Grid {
  int ncz, ncy, ncx;  // cells per axis
  int nz, ny, nx;     // lattice nodes per axis
  int zlo, zhi, zown;
  int ylo, yhi, yown, xlo, xhi, xown;
  int cbeg, cend;
  __host__ __device__ int n_cells() const { return ncz * ncy * ncx; }
  __host__ __device__ int n_nodes() const { return nz * ny * nx; }
};

inline Grid box_grid(int degree, int ncz, int ncy, int ncx) {
  const int nz = degree * ncz + 1, ny = degree * ncy + 1,
            nx = degree * ncx + 1;
  return {ncz, ncy, ncx, nz, ny, nx, 1, nz - 1, nz,
          1,   ny - 1, ny, 1, nx - 1, nx, 0, ncz * ncy * ncx};
}

// A node off the Dirichlet faces: the box's (BLOCK false), or a block's
// (BLOCK: each axis's faces at its lo and hi, B2's block form).
template <bool BLOCK = false>
__device__ __forceinline__ bool interior(const Grid& gr, int z, int y, int x) {
  if constexpr (BLOCK)
    return z >= gr.zlo && z < gr.zhi && y >= gr.ylo && y < gr.yhi &&
           x >= gr.xlo && x < gr.xhi;
  else
    return z > 0 && z < gr.nz - 1 && y > 0 && y < gr.ny - 1 && x > 0 &&
           x < gr.nx - 1;
}

// The lattice node of local node k of a cell, and its mask value: the mask
// tensor's where one is given (B6), else the Dirichlet mask from the
// indices (B5: the box's; BLOCK: a block's).
template <int P, bool BLOCK = false, typename T>
__device__ __forceinline__ size_t cell_node(const Grid& gr, int cell, int k,
                                            const T* mask, T* m) {
  using S = Shape<P>;
  const int cx = cell % gr.ncx, cy = (cell / gr.ncx) % gr.ncy,
            cz = cell / (gr.ncx * gr.ncy);
  const int z = cz * P + k / S::P12, y = cy * P + (k / S::P1) % S::P1,
            x = cx * P + k % S::P1;
  const size_t node = (static_cast<size_t>(z) * gr.ny + y) * gr.nx + x;
  *m = mask ? mask[node] : (interior<BLOCK>(gr, z, y, x) ? T(1) : T(0));
  return node;
}

// Inversion chains of the rebuilt metric (benchmark.resolve_cofactor):
// "adjj" the adjugate of J, G = w adj adj^T / det J (the reference's
// do_invert form); "jtj" C = J^T J, G = w adj(C) / sqrt(det C)
// (cg_fused_kernel.py:219-241).  The two are one metric where det J > 0;
// models/bp4.build refuses jtj on a mesh with det J <= 0 at a q-point.
enum : int { kAdjj = 0, kJtj = 1 };
// the chain of a dense tensor-core instantiation NP (kJtjChain)
__host__ __device__ constexpr int chain_of(int np) {
  return (np & kJtjChain) ? kJtj : kAdjj;
}

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// Metric entries (00, 01, 02, 11, 12, 22) at one q-point, rebuilt from the
// cell's 24 trilinear coefficients: J = pds . c24 in exact FMA, then the
// COFACTOR chain.  `pq` is the q-point's row of pds (d(monomial k)/d(u_e)
// at e*8 + k), `c24` holds coordinate d's coefficient k at (d*8 + k)
// STRIDE.  A zero Jacobian (a cell past the end) gives G = 0: adjj guards
// det = 0, jtj det C <= 0, as the TPU kernel does for its padded rows.
template <int STRIDE = 1, int COFACTOR = kAdjj, typename T>
__device__ __forceinline__ void onthefly_metric(const T* pq, const T* c24,
                                                T w, T* g) {
  T J[3][3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      T a = T(0);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        a = fma(pq[e * 8 + k], c24[(d * 8 + k) * STRIDE], a);
      J[d][e] = a;
    }
  if constexpr (COFACTOR == kJtj) {
    T C[3][3];
#pragma unroll
    for (int e = 0; e < 3; ++e)
#pragma unroll
      for (int f = e; f < 3; ++f)
        C[e][f] = J[0][e] * J[0][f] + J[1][e] * J[1][f] + J[2][e] * J[2][f];
    const T c00 = C[0][0], c01 = C[0][1], c02 = C[0][2];
    const T c11 = C[1][1], c12 = C[1][2], c22 = C[2][2];
    const T adj[6] = {c11 * c22 - c12 * c12, c02 * c12 - c01 * c22,
                      c01 * c12 - c02 * c11, c00 * c22 - c02 * c02,
                      c01 * c02 - c00 * c12, c00 * c11 - c01 * c01};
    const T det = c00 * adj[0] + c01 * adj[1] + c02 * adj[2];
    const T scale = w * rsqrt_t(det <= T(0) ? T(1) : det);
#pragma unroll
    for (int r = 0; r < 6; ++r) g[r] = adj[r] * scale;
  } else {
    const T a = J[0][0], b = J[0][1], c = J[0][2];
    const T d = J[1][0], e = J[1][1], f = J[1][2];
    const T gg = J[2][0], h = J[2][1], i = J[2][2];
    const T adj[3][3] = {{e * i - f * h, c * h - b * i, b * f - c * e},
                         {f * gg - d * i, a * i - c * gg, c * d - a * f},
                         {d * h - e * gg, b * gg - a * h, a * e - b * d}};
    const T det = a * adj[0][0] + b * adj[1][0] + c * adj[2][0];
    const T scale = w / (det == T(0) ? T(1) : det);
    int r = 0;
#pragma unroll
    for (int e0 = 0; e0 < 3; ++e0)
#pragma unroll
      for (int f0 = e0; f0 < 3; ++f0, ++r)
        g[r] = (adj[e0][0] * adj[f0][0] + adj[e0][1] * adj[f0][1] +
                adj[e0][2] * adj[f0][2]) * scale;
  }
}

// The pds row of one q-point (24 words, 16-byte aligned) by 16-byte loads.
template <typename T>
__device__ __forceinline__ void load_pds_row(const T* row, T (&pq)[24]) {
  if constexpr (sizeof(T) == 4) {
    const float4* r = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float4 v = __ldg(r + k);
      pq[4 * k] = v.x;
      pq[4 * k + 1] = v.y;
      pq[4 * k + 2] = v.z;
      pq[4 * k + 3] = v.w;
    }
  } else {
    const double2* r = reinterpret_cast<const double2*>(row);
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const double2 v = __ldg(r + k);
      pq[2 * k] = v.x;
      pq[2 * k + 1] = v.y;
    }
  }
}

// The vectors of the B1 (d -> cells) and B2 (update4b, then d' -> cells)
// cell passes; B1 sets only d.  bf16: d, h and d2 hold bf16 values (the
// bf16 state; read by the bf16 rung's tensor-core passes, FLEX).
// prec_bf16, x_bf16: prec, or x and x2, hold bf16 values (read by the PX
// instantiations of B2's passes only).
template <typename T>
struct CellIo {
  const T *x, *g, *d, *h, *prec, *scal;
  T *x2, *g2, *d2;
  int bf16 = 0;
  int prec_bf16 = 0, x_bf16 = 0;
};

// update4b's reads of P and x and its write of x' (cg_fused_kernel.py:
// 836-858): at T, or (PX) through load_px / store_px by io.prec_bf16 and
// io.x_bf16; the arithmetic is the working type's either way, and x' is
// rounded where it is stored.
template <bool PX, typename T>
__device__ __forceinline__ T prec_at(const CellIo<T>& io, size_t node) {
  if constexpr (PX)
    return load_px(io.prec, node, io.prec_bf16);
  else
    return io.prec[node];
}
template <bool PX, typename T>
__device__ __forceinline__ T x_at(const CellIo<T>& io, size_t idx) {
  if constexpr (PX)
    return load_px(io.x, idx, io.x_bf16);
  else
    return io.x[idx];
}
template <bool PX, typename T>
__device__ __forceinline__ void set_x2(const CellIo<T>& io, size_t idx, T v) {
  if constexpr (PX)
    store_px(io.x2, idx, v, io.x_bf16);
  else
    io.x2[idx] = v;
}

// The operator input at local node (kz, ky, kx) of cell (cz, cy, cx),
// component c, zero at Dirichlet nodes: B1 d; B2 update4b's d'
// (cg_fused_kernel.py:836-858) from the scalars sc = (alpha, beta, c1,
// aob), and the node's owner cell writes x', g', d'.  FLEX (T float): d
// and h may be bf16 (io.bf16); then d' is stored in bf16 and the operator
// takes the stored, rounded d' (cg_fused_kernel.py:856).  PX: P and x by
// prec_at / x_at / set_x2.  BLOCK: a block's Dirichlet faces.
template <typename T, int P, bool FUSED, bool FLEX = false, bool PX = false,
          bool BLOCK = false>
__device__ __forceinline__ T cell_input(const CellIo<T>& io, const T (&sc)[4],
                                        const Grid& gr, int c, int cz, int cy,
                                        int cx, int kz, int ky, int kx) {
  const int z = cz * P + kz, y = cy * P + ky, xx = cx * P + kx;
  const size_t node = (static_cast<size_t>(z) * gr.ny + y) * gr.nx + xx;
  const size_t idx = c * static_cast<size_t>(gr.n_nodes()) + node;
  const bool in = interior<BLOCK>(gr, z, y, xx);
  if constexpr (FLEX) {
    const bool bf = io.bf16;
    if constexpr (!FUSED) {
      return in ? load_flex(io.d, idx, bf) : 0.f;
    } else {
      const float pv = prec_at<PX>(io, node), gv = io.g[idx],
                  dv = load_flex(io.d, idx, bf);
      const float gn = gv + sc[0] * load_flex(io.h, idx, bf);
      const float dn = round_flex(sc[1] * dv - pv * gn, bf);
      const bool owner = (kz < P || cz == gr.ncz - 1) &&
                         (ky < P || cy == gr.ncy - 1) &&
                         (kx < P || cx == gr.ncx - 1);
      if (owner) {
        set_x2<PX>(io, idx,
                   x_at<PX>(io, idx) + sc[2] * dv + sc[3] * (pv * gv));
        io.g2[idx] = gn;
        store_flex(io.d2, idx, dn, bf);
      }
      return in ? dn : 0.f;
    }
  } else if constexpr (!FUSED) {
    return in ? io.d[idx] : T(0);
  } else {
    const T pv = prec_at<PX>(io, node), gv = io.g[idx], dv = io.d[idx];
    const T gn = gv + sc[0] * io.h[idx];
    const T dn = sc[1] * dv - pv * gn;
    // each node is written by exactly one cell: the one it is local node
    // (k < P) of, or the last cell along an axis for the top face
    const bool owner = (kz < P || cz == gr.ncz - 1) &&
                       (ky < P || cy == gr.ncy - 1) &&
                       (kx < P || cx == gr.ncx - 1);
    if (owner) {
      set_x2<PX>(io, idx,
                 x_at<PX>(io, idx) + sc[2] * dv + sc[3] * (pv * gv));
      io.g2[idx] = gn;
      io.d2[idx] = dn;
    }
    return in ? dn : T(0);
  }
}

// The cells sharing lattice coordinate `z` along one axis with nc cells:
// fills (cell index, local node index) pairs in ascending cell order and
// returns their count (1 or 2).
template <int P>
__device__ __forceinline__ int axis_cells(int z, int nc, int* cs, int* ks) {
  const int c = z / P, k = z % P;
  if (k == 0 && c > 0) {
    cs[0] = c - 1;
    ks[0] = P;
    if (c < nc) {
      cs[1] = c;
      ks[1] = 0;
      return 2;
    }
    return 1;
  }
  cs[0] = c;
  ks[0] = k;
  return 1;
}

// Sum a node's cell contributions in a fixed order (deterministic, no atomics).
template <typename T, int P>
__device__ __forceinline__ T gather_node(const T* __restrict__ cells,
                                         const Grid& gr, int c, int z, int y,
                                         int x) {
  using S = Shape<P>;
  int zc[2], zk[2], yc[2], yk[2], xc[2], xk[2];
  const int nzc = axis_cells<P>(z, gr.ncz, zc, zk);
  const int nyc = axis_cells<P>(y, gr.ncy, yc, yk);
  const int nxc = axis_cells<P>(x, gr.ncx, xc, xk);
  const size_t base = static_cast<size_t>(c) * gr.n_cells();
  T s = T(0);
  for (int a = 0; a < nzc; ++a)
    for (int b = 0; b < nyc; ++b)
      for (int e = 0; e < nxc; ++e) {
        const int cell = (zc[a] * gr.ncy + yc[b]) * gr.ncx + xc[e];
        const int l = (zk[a] * S::P1 + yk[b]) * S::P1 + xk[e];
        s += cells[(base + cell) * S::P13 + l];
      }
  return s;
}

// Fixed-order tree sum of `kDots` values over the block (blockDim.x ==
// kNodeThreads); the result is valid in red[k][0].
template <typename T>
__device__ void block_sum(T (*red)[kNodeThreads], const T* v) {
  for (int k = 0; k < kDots; ++k) red[k][threadIdx.x] = v[k];
  __syncthreads();
  for (int s = kNodeThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      for (int k = 0; k < kDots; ++k) red[k][threadIdx.x] += red[k][threadIdx.x + s];
    __syncthreads();
  }
}

// The assemble pass: one thread per lattice node sums the node's <= 8
// cell-local contributions (cells[(c * n_cells + cell) * P13 + l]) in a
// fixed order, masks, and writes h; with DOTS it also writes per-block
// partials of the 7 update3b sums over d', g' as stored and h'
// (cg_fused_kernel.py:877-895).  BLOCK (B2's block form): a block's
// Dirichlet faces, and the sums over its owned nodes (z < gr.zown, y <
// gr.yown, x < gr.xown).  Replaces the TPU kernels' lane-roll consistency
// and z carry plane.  V: the storage of h and d (T, or bf16
// for the bf16 state: h is rounded where it is stored, and the sums read
// the stored d' and h').  PBF: prec holds bf16 values (prec_dtype bf16),
// upcast at the load.  NC: the vectors' components (kComps; 1 for BP3).
template <typename T, int P, bool DOTS, typename V = T, bool PBF = false,
          bool BLOCK = false, int NC = kComps>
__global__ void __launch_bounds__(kNodeThreads)
    assemble_kernel(Grid gr, const T* __restrict__ cells, V* __restrict__ h,
                    const T* __restrict__ g, const V* __restrict__ d,
                    const T* __restrict__ prec, T* __restrict__ partials) {
  __shared__ T red[DOTS ? kDots : 1][kNodeThreads];
  const int n_nodes = gr.n_nodes();
  const int node = blockIdx.x * kNodeThreads + threadIdx.x;
  T acc[kDots] = {};
  if (node < n_nodes) {
    const int x = node % gr.nx, y = (node / gr.nx) % gr.ny,
              z = node / (gr.nx * gr.ny);
    const bool in = interior<BLOCK>(gr, z, y, x);
    T pv = T(0);
    if constexpr (DOTS && PBF)
      pv = load_px(prec, node, true);
    else if constexpr (DOTS)
      pv = prec[node];
    for (int c = 0; c < NC; ++c) {
      const size_t idx = static_cast<size_t>(c) * n_nodes + node;
      const V hs = to_store<V>(in ? gather_node<T, P>(cells, gr, c, z, y, x)
                                  : T(0));
      h[idx] = hs;
      if constexpr (DOTS) {
        if constexpr (BLOCK) {
          if (z >= gr.zown || y >= gr.yown || x >= gr.xown) continue;
        }
        const T hv = to_acc<T>(hs), gv = g[idx], dv = to_acc<T>(d[idx]);
        const T ph = pv * hv, pg = pv * gv;
        acc[0] += dv * hv;
        acc[1] += hv * hv;
        acc[2] += gv * hv;
        acc[3] += gv * gv;
        acc[4] += gv * ph;
        acc[5] += hv * ph;
        acc[6] += gv * pg;
      }
    }
  }
  if constexpr (DOTS) {
    block_sum(red, acc);
    if (threadIdx.x == 0) {
      for (int k = 0; k < kDots; ++k) partials[blockIdx.x * 8 + k] = red[k][0];
      partials[blockIdx.x * 8 + kDots] = T(0);
    }
  }
}

inline int node_blocks(const Grid& gr) {
  return (gr.n_nodes() + kNodeThreads - 1) / kNodeThreads;
}

// The assemble pass of B5 and B6 with a bf16 state: h in bf16 at the TPU
// kernels' rounding points (laplace_pallas.py:671-693, 897-905 and the
// wrappers' y/x sums, :640-644, :748-790).  Per node, each (y cell, x
// cell) pair's z contributions (<= 2, from the masked cell-local f32
// results) are summed in f32 and rounded to bf16, as the TPU kernels add
// the z carry plane and store; then the pairs are summed in bf16, one
// rounding an add, in the wrappers' order: B6 (PIECES false,
// _from_zslab_form) along y, then along x; B5 (PIECES true,
// _from_piece_forms) the corner pieces mm, mp, pm, pp in turn (a cell's
// nodes below its top y and x faces, its top x face, its top y face, the
// corner).  BLOCK: a block's lattice, only summed (laplace_apply.cu).
template <int P, bool PIECES, bool BLOCK>
__global__ void __launch_bounds__(kNodeThreads)
    assemble_bf16_kernel(Grid gr, const float* __restrict__ cells,
                         __nv_bfloat16* __restrict__ h) {
  using S = Shape<P>;
  const int n_nodes = gr.n_nodes();
  const int node = blockIdx.x * kNodeThreads + threadIdx.x;
  if (node >= n_nodes) return;
  const int x = node % gr.nx, y = (node / gr.nx) % gr.ny,
            z = node / (gr.nx * gr.ny);
  const bool in = BLOCK || interior(gr, z, y, x);
  int zc[2], zk[2], yc[2], yk[2], xc[2], xk[2];
  const int nzc = axis_cells<P>(z, gr.ncz, zc, zk);
  const int nyc = axis_cells<P>(y, gr.ncy, yc, yk);
  const int nxc = axis_cells<P>(x, gr.ncx, xc, xk);
  for (int c = 0; c < kComps; ++c) {
    const size_t base = static_cast<size_t>(c) * gr.n_cells();
    float r[2][2];  // the z sums of each (y cell, x cell), as stored
    for (int b = 0; b < nyc; ++b)
      for (int e = 0; e < nxc; ++e) {
        float s = 0.f;
        for (int a = 0; a < nzc; ++a) {
          const int cell = (zc[a] * gr.ncy + yc[b]) * gr.ncx + xc[e];
          const int l = (zk[a] * S::P1 + yk[b]) * S::P1 + xk[e];
          s += cells[(base + cell) * S::P13 + l];
        }
        r[b][e] = round_flex(s, true);
      }
    float v = 0.f;
    if constexpr (PIECES) {
      for (int cls = 0; cls < 4; ++cls)  // mm, mp, pm, pp
        for (int b = 0; b < nyc; ++b)
          for (int e = 0; e < nxc; ++e)
            if ((yk[b] == P) == (cls >= 2) && (xk[e] == P) == (cls % 2 == 1))
              v = round_flex(v + r[b][e], true);
    } else {
      float ry[2];
      for (int e = 0; e < nxc; ++e)
        ry[e] = nyc == 2 ? round_flex(r[0][e] + r[1][e], true) : r[0][e];
      v = nxc == 2 ? round_flex(ry[0] + ry[1], true) : ry[0];
    }
    h[static_cast<size_t>(c) * n_nodes + node] =
        __float2bfloat16_rn(in ? v : 0.f);
  }
}

// C10: the f32 carry of B2's block form under a bf16 state.  The top z
// face of a block holds its partial sums owed to the upper rank; the TPU
// kernel emits that plane at f32 (carry_out_ref, cg_fused_kernel.py:
// 909-915) before any rounding, and only the add-back onto the upper
// rank's face 0 rounds (parallel/dist_fused.py:253, 428).  This pass writes
// the assemble pass's sums there at f32, unrounded, into carry (C, Ny,
// Nx): the value the assemble pass rounds into h' (the same sum in the
// same order).  The y and x faces travel as stored, as in the JAX package.
template <int P>
__global__ void __launch_bounds__(kNodeThreads)
    block_carry_kernel(Grid gr, const float* __restrict__ cells,
                       float* __restrict__ carry) {
  const int n = gr.ny * gr.nx;
  const int i = blockIdx.x * kNodeThreads + threadIdx.x;
  if (i >= n) return;
  const int x = i % gr.nx, y = i / gr.nx, z = gr.nz - 1;
  const bool in = interior<true>(gr, z, y, x);
  for (int c = 0; c < kComps; ++c)
    carry[static_cast<size_t>(c) * n + i] =
        in ? gather_node<float, P>(cells, gr, c, z, y, x) : 0.f;
}

}  // namespace bp4
