// The tensor-core primitives of the cell passes of the rungs split2m,
// split3 and bf16 (apply_mma.cuh: B3, B5, B6, B1/B2 dense; cell_mma.cuh,
// cell_mma_hd.cuh: B1, B2 twostage): one mma.sync m16n8k16 with bf16
// operands and f32 accumulation, and the split of f32 values into their
// bf16 stream parts.
//
// A rung is its number of products a tile, NP (laplace_pallas._mm,
// cg_fused_kernel._prestack / _stream_parts), with Mh = bf16(M), Ml =
// bf16(M - Mh), xh = bf16(x), xl = bf16(x - xh), all f32-accumulated:
//   NP = 1  bf16     xh Mh
//   NP = 2  split2m  xh Mh + xl Mh
//   NP = 3  split3   xh Mh + xl Mh + xh Ml  (the lo.lo product dropped)

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "bp4_operator.cuh"

namespace bp4 {

// c += a . b on one m16n8k16 tile: a row-major bf16 (4 registers), b
// column-major bf16 (2 registers), c f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The stream parts of two values, hi = bf16(x) and lo = bf16(x - hi) as
// laplace_pallas._mm splits a stream, each packed as bf16x2 (x0 in the
// low half).
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The stream parts of a rung with NP products: hi and lo as split_pair
// gives them; the bf16 rung (NP = 1) rounds to hi only (lo = 0, unused).
template <int NP>
__device__ __forceinline__ void stream_parts(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  if constexpr (NP == 1) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = 0u;
  } else {
    split_pair(x0, x1, hi, lo);
  }
}
// split2m's stream parts of two f64 values (the f64 form, kF64): hi =
// bf16(x) rounded through f32 (bp4_operator.cuh's bf16_of), lo = bf16(x -
// hi) from the f64 difference, as cg_fused_kernel._stream_parts splits an
// f64 stream.
template <int NP>
__device__ __forceinline__ void stream_parts(double x0, double x1,
                                             uint32_t& hi, uint32_t& lo) {
  static_assert(NP == 2, "the f64 form is split2m's");
  const __nv_bfloat16 h0 = bf16_of(x0), h1 = bf16_of(x1);
  const __nv_bfloat162 h = __halves2bfloat162(h0, h1),
                       l = __halves2bfloat162(lo_of(x0, h0), lo_of(x1, h1));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
}  // namespace bp4
