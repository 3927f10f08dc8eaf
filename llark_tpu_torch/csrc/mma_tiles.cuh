// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// tile copies into shared memory and the bf16 mma.sync m16n8k16 product.
//
// mma.m16n8k16 fragments (lane = 4 * g + t): A (16x16, row-major) holds
// rows g and g+8 at columns 2t, 2t+1 (regs 0, 1) and 2t+8, 2t+9 (regs 2, 3);
// B (16x8) holds column g at rows 2t, 2t+1 (reg 0) and 2t+8, 2t+9 (reg 1);
// C (16x8, fp32) holds rows g (c0, c1) and g+8 (c2, c3) at columns 2t, 2t+1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace tiles {

// Copy rows [r0, r0 + ROWS) of NMAT [*, D] bf16 matrices (row stride `ss`
// elements) into shared memory with row stride `ldd`; rows at or past
// `limit` are zero. NT threads share the copy. All 16-byte loads are issued
// into registers before the first shared-memory store: the compiler cannot
// move a global load above a store through another pointer it might alias,
// so a load-store loop would pay one memory round trip per iteration.
template <int D, int ROWS, int NMAT, int NT>
__device__ __forceinline__ void load_tiles(bf16* const (&dst)[NMAT], int ldd,
                                           const bf16* const (&src)[NMAT],
                                           const long long (&ss)[NMAT], int r0,
                                           int limit) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int N = ROWS * CH / NT;
  static_assert(ROWS * CH % NT == 0, "whole copy rounds");
  uint4 val[NMAT][N];
#pragma unroll
  for (int m = 0; m < NMAT; ++m) {
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int i = threadIdx.x + it * NT;
      const int r = i / CH;
      val[m][it] = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < limit) {
        val[m][it] = *reinterpret_cast<const uint4*>(src[m] + (long long)(r0 + r) * ss[m] +
                                                     (i % CH) * 8);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < NMAT; ++m) {
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int i = threadIdx.x + it * NT;
      *reinterpret_cast<uint4*>(dst[m] + (i / CH) * ldd + (i % CH) * 8) = val[m][it];
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from separate addresses, the first in the low half
__device__ __forceinline__ uint32_t pack2(const bf16* lo, const bf16* hi) {
  return uint32_t(*reinterpret_cast<const unsigned short*>(lo)) |
         (uint32_t(*reinterpret_cast<const unsigned short*>(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b on the tensor cores: m16n8k16, bf16 inputs, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of 16 rows starting at `row0` of a row-major [*, ld] bf16
// matrix in shared memory, at columns [col0, col0 + 16).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base, int ld,
                                       int row0, int col0, int g, int t) {
  const bf16* p = base + (row0 + g) * ld + col0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tiles
