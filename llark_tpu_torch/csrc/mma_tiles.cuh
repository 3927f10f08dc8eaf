// Shared register-level pieces of the kernels: bf16 packing (the wgmma ones)
// and the quad reductions of a softmax row (flash_fwd.cu, flash_bwd.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace tiles {

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 floats (two float4 of neighbouring values) as 8 bf16s, in order
__device__ __forceinline__ uint4 pack_f8(const float4& lo, const float4& hi) {
  return make_uint4(pack_f2(lo.x, lo.y), pack_f2(lo.z, lo.w), pack_f2(hi.x, hi.y),
                    pack_f2(hi.z, hi.w));
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
