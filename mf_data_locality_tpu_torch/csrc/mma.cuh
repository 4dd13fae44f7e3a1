// The two tensor-core primitives of the split2m cell passes (apply_mma.cuh:
// B3, B5, B6; cell_mma.cuh: B1, B2): one mma.sync m16n8k16 with bf16
// operands and f32 accumulation, and the split of f32 values into their
// bf16 hi/lo stream parts.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

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

}  // namespace bp4
