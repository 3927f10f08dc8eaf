// Int8 weight-only matrix product for Hopper (sm_90a):
//   y[M, N] = (x[M, K] @ q[K, N]) * scale[N]   in x's dtype
// x bf16 or fp32, q int8 with N minor, scale fp32 per output channel.
//
// Replaces the TPU kernel `_int8_matmul_kernel` of
// llark_tpu/ops/int8_matmul.py (pallas_call in `int8_matmul`). Like it, the
// int8 bytes are the only weight bytes read from device memory, the convert
// to bf16 is exact and happens in registers, the accumulator is fp32 and
// the scale multiplies it before the one rounding. Unlike it, nothing is
// carried over block by block: the TPU grid keeps the whole contraction of
// an output tile in VMEM; here the contraction streams through a ring in
// shared memory (and, at decode shapes, is split across blocks, the last
// block of a tile adding the partial sums). Bound by the weight bytes at
// decode shapes and by the tensor cores at admission shapes; wq_matmul.cuh
// says what the design does about both.

#include "wq_matmul.cuh"

namespace wq {

struct Int8 {
  static constexpr bool kGrouped = false;
  static constexpr int kRowsPer16 = 16;  // one stored row per contraction row
  static constexpr int kPad = 16;        // rows 2t of a warp's reads on distinct banks

  // byte j of two words of biased bytes (v + 128; neighbouring contraction
  // rows) as one bf16 pair, the earlier row in the low half: 0x4B0000 | u is
  // the float 2^23 + u, minus 2^23 + 128 gives v exactly, and an integer of
  // at most 8 significant bits keeps its value in the top half of its float
  static __device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi, int j) {
    const float flo = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7650 | j)) - 8388736.f;
    const float fhi = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7650 | j)) - 8388736.f;
    return __byte_perm(__float_as_uint(flo), __float_as_uint(fhi), 0x7632);
  }

  // The A fragments of both m64 tiles for k16 step ks: rows 16ks + 2t, 2t
  // + 1, 2t + 8, 2t + 9 of the ring tile at this lane's 4 channels. Byte 2T
  // of a word is row g of tile T, byte 2T + 1 its row g + 8.
  template <int PITCH>
  static __device__ __forceinline__ void frags(const unsigned char* wt, int ks, int t,
                                               uint32_t (&a)[2][4]) {
    const unsigned char* p = wt + (16 * ks + 2 * t) * PITCH;
    const uint32_t u0 = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
    const uint32_t u1 = *reinterpret_cast<const uint32_t*>(p + PITCH) ^ 0x80808080u;
    const uint32_t u2 = *reinterpret_cast<const uint32_t*>(p + 8 * PITCH) ^ 0x80808080u;
    const uint32_t u3 = *reinterpret_cast<const uint32_t*>(p + 9 * PITCH) ^ 0x80808080u;
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      a[tt][0] = pair(u0, u1, 2 * tt);
      a[tt][1] = pair(u0, u1, 2 * tt + 1);
      a[tt][2] = pair(u2, u3, 2 * tt);
      a[tt][3] = pair(u2, u3, 2 * tt + 1);
    }
  }
};

}  // namespace wq

// The split of the contraction that llark_int8_matmul expects for this shape.
extern "C" int llark_int8_matmul_splits(int m, int k, int n, int unit) {
  return wq::splits<wq::Int8>(m, k, n, unit);
}

// x [m, k] bf16 (x_f32 = 0) or fp32, q [k, n] int8, scale [n] fp32, out [m,
// n] in x's dtype; part [n_splits, m, n] fp32 and counters (MAX_COUNTERS
// int32 zeros) the workspace of a split contraction (unused with one
// split); k % 16 == 0, n % 8 == 0; all contiguous, x and scale 16-byte
// aligned, q 8-byte aligned (vec16: 16-byte aligned rows). Returns the
// cudaError_t of the launch.
extern "C" int llark_int8_matmul(const void* x, const void* q, const void* scale, void* out,
                                 void* part, void* counters, int m, int k, int n, int n_splits,
                                 int x_f32, int vec16, void* stream) {
  return wq::launch<wq::Int8>(x, q, scale, out, part, counters, m, k, n, 16, n_splits, x_f32,
                              vec16, static_cast<cudaStream_t>(stream));
}
