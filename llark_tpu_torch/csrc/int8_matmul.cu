// Int8 weight-only matrix product for Hopper (sm_90a):
//   y[M, N] = bf16((x[M, K] @ q[K, N]) * scale[N])
// x bf16, q int8 with N minor, scale fp32 per output channel.
//
// Replaces the TPU kernel `_int8_matmul_kernel` of
// llark_tpu/ops/int8_matmul.py (pallas_call in `int8_matmul`). Like it, the
// int8 bytes are the only weight bytes read from device memory, the convert
// to bf16 is exact and happens in registers, the accumulator is fp32 and
// the scale multiplies it before the one rounding. Unlike it, nothing is
// carried over block by block: the TPU grid keeps the whole contraction of
// an output tile in VMEM; here the contraction is tiled (and, at decode
// shapes, split across blocks). Bound by the weight bytes at decode shapes
// and by the tensor cores at admission shapes; wq_matmul.cuh says what the
// design does about both.

#include "wq_matmul.cuh"

namespace wq {

struct Int8 {
  static constexpr bool kGrouped = false;

  // bytes j of two words (neighbouring contraction rows) as one bf16 pair,
  // the earlier row in the low half
  static __device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi, int j) {
    return tiles::pack_f2((float)(signed char)(lo >> (8 * j)),
                          (float)(signed char)(hi >> (8 * j)));
  }

  static constexpr int kRows = 4;

  // the rows whose pairs are b0 (k + 2t, 2t + 1) and b1 (k + 2t + 8, 2t + 9)
  static __device__ __forceinline__ long long row(int k, int t, int r) {
    return k + 2 * t + (r & 1) + 8 * (r >> 1);
  }

  // byte j of the words is column group j
  static __device__ __forceinline__ void frags(const uint32_t (&raw)[4], uint32_t (&b0)[4],
                                               uint32_t (&b1)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b0[j] = pair(raw[0], raw[1], j);
      b1[j] = pair(raw[2], raw[3], j);
    }
  }
};

}  // namespace wq

// The split of the contraction that llark_int8_matmul expects for this shape.
extern "C" int llark_int8_matmul_splits(int m, int k, int n, int unit) {
  return wq::splits(m, k, n, unit);
}

// x [m, k] bf16, q [k, n] int8, scale [n] fp32, out [m, n] bf16, part
// [n_splits, m, n] fp32 scratch (unused with one split); k % 16 == 0,
// n % 8 == 0; all contiguous. Returns the cudaError_t of the launch.
extern "C" int llark_int8_matmul(const void* x, const void* q, const void* scale, void* out,
                                 void* part, int m, int k, int n, int n_splits, void* stream) {
  return wq::launch<wq::Int8>(x, q, scale, out, part, m, k, n, 16, n_splits,
                          static_cast<cudaStream_t>(stream));
}
