// Int4 weight-only matrix product for Hopper (sm_90a):
//   y[M, D] = x[M, H] @ (sext(nibble[H, D]) * scale[H / group, D])   in x's dtype
// x bf16 or fp32; q4 [H/2, D] int8 in the pair layout (packed row r holds
// original row 2r in the low nibble and 2r + 1 in the high one), D minor;
// scale fp32 per group of `group` contraction rows and output channel.
//
// Replaces the TPU kernel `_int4_matmul_kernel` of
// llark_tpu/ops/int4_matmul.py (pallas_call in `int4_matmul`). Like it,
// only the packed bytes and the scales are read from device memory and the
// nibbles are unpacked in registers. Two things differ. The TPU kernel
// splits the activations into even and odd columns to avoid an interleave;
// here one packed byte already is one register of the tensor cores' A
// operand (contraction rows 2t and 2t + 1 of one channel), so x is read as
// it is. And the TPU kernel rounds nibble * scale to bf16 before the
// product; this kernel feeds the exact nibbles to the tensor cores, keeps
// one fp32 accumulator per scale group and multiplies it by the fp32 scale
// at the group's end (what `_dense_int4_cols` does for the cols layout):
// one multiply per output and group instead of one per weight, and no
// rounding of the weights. Bound by the packed bytes at decode shapes and
// by the tensor cores at admission shapes; wq_matmul.cuh says what the
// design does about both.

#include "wq_matmul.cuh"

namespace wq {

struct Int4 {
  static constexpr bool kGrouped = true;
  static constexpr int kRowsPer16 = 8;  // a packed row holds two contraction rows
  static constexpr int kPad = 32;       // rows t of a warp's reads on distinct banks

  // A word of 4 packed bytes (4 channels of one packed row) as 4 bf16 pairs.
  // v ^ 8 maps a nibble's two's complement value v in [-8, 7] to v + 8 in
  // [0, 15]; 0x4300 | u is the bf16 128 + u, exactly; minus 136 gives v.
  static __device__ __forceinline__ void unpack(uint32_t word, uint32_t (&b)[4]) {
    word ^= 0x88888888u;
    const uint32_t lo = word & 0x0F0F0F0Fu;         // byte j: row 2r of channel j
    const uint32_t hi = (word >> 4) & 0x0F0F0F0Fu;  // byte j: row 2r + 1
    const uint32_t bias = 0x43084308u;              // bf16 pair (136, 136)
    const uint32_t sel[4] = {0x4400u, 0x5511u, 0x6622u, 0x7733u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // low half 0x4300 | lo_j, high half 0x4300 | hi_j
      const uint32_t u = (__byte_perm(lo, hi, sel[j]) & 0x00FF00FFu) | 0x43004300u;
      const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u),
                                       *reinterpret_cast<const __nv_bfloat162*>(&bias));
      b[j] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }

  // The A fragments of both m64 tiles for k16 step ks: packed rows 8ks + t
  // (contraction rows 2t, 2t + 1) and 8ks + t + 4 (2t + 8, 2t + 9) of the
  // ring tile at this lane's 4 channels. Byte 2T of a word is row g of
  // tile T, byte 2T + 1 its row g + 8.
  template <int PITCH>
  static __device__ __forceinline__ void frags(const unsigned char* wt, int ks, int t,
                                               uint32_t (&a)[2][4]) {
    const unsigned char* p = wt + (8 * ks + t) * PITCH;
    uint32_t b0[4], b1[4];
    unpack(*reinterpret_cast<const uint32_t*>(p), b0);
    unpack(*reinterpret_cast<const uint32_t*>(p + 4 * PITCH), b1);
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      a[tt][0] = b0[2 * tt];
      a[tt][1] = b0[2 * tt + 1];
      a[tt][2] = b1[2 * tt];
      a[tt][3] = b1[2 * tt + 1];
    }
  }
};

}  // namespace wq

// The split of the contraction that llark_int4_matmul expects for this shape.
extern "C" int llark_int4_matmul_splits(int m, int h, int d, int group) {
  return wq::splits<wq::Int4>(m, h, d, group);
}

// x [m, h] bf16 (x_f32 = 0) or fp32, q4 [h/2, d] int8, scale [h/group, d]
// fp32, out [m, d] in x's dtype; part [n_splits, m, d] fp32 and counters
// (MAX_COUNTERS int32 zeros) the workspace of a split contraction (unused
// with one split); group % 16 == 0, h % group == 0, d % 8 == 0; all
// contiguous, x and scale 16-byte aligned, q4 8-byte aligned (vec16:
// 16-byte aligned rows). Returns the cudaError_t of the launch.
extern "C" int llark_int4_matmul(const void* x, const void* q4, const void* scale, void* out,
                                 void* part, void* counters, int m, int h, int d, int group,
                                 int n_splits, int x_f32, int vec16, void* stream) {
  return wq::launch<wq::Int4>(x, q4, scale, out, part, counters, m, h, d, group, n_splits, x_f32,
                              vec16, static_cast<cudaStream_t>(stream));
}
