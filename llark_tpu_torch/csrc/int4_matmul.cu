// Int4 weight-only matrix product for Hopper (sm_90a):
//   y[M, D] = bf16(x[M, H] @ (sext(nibble[H, D]) * scale[H / group, D]))
// x bf16; q4 [H/2, D] int8 in the pair layout (packed row r holds original
// row 2r in the low nibble and 2r + 1 in the high one), D minor; scale fp32
// per group of `group` contraction rows and output channel.
//
// Replaces the TPU kernel `_int4_matmul_kernel` of
// llark_tpu/ops/int4_matmul.py (pallas_call in `int4_matmul`). Like it,
// only the packed bytes and the scales are read from device memory and the
// nibbles are unpacked in registers. Two things differ. The TPU kernel
// splits the activations into even and odd columns to avoid an interleave;
// here one packed byte already is one register of the tensor cores' B
// operand (rows 2t and 2t + 1 of one column), so x is read as it is. And
// the TPU kernel rounds nibble * scale to bf16 before the product; this
// kernel feeds the exact nibbles to the tensor cores, keeps one fp32
// accumulator per scale group and multiplies it by the fp32 scale at the
// group's end (what `_dense_int4_cols` does for the cols layout): one
// multiply per output and group instead of one per weight, and no rounding
// of the weights. Bound by the packed bytes at decode shapes and by the
// tensor cores at admission shapes; wq_matmul.cuh says what the design does
// about both.

#include "wq_matmul.cuh"

namespace wq {

struct Int4 {
  static constexpr bool kGrouped = true;

  // A word of 4 packed bytes (4 columns of one packed row) as 4 bf16 pairs.
  // v ^ 8 maps a nibble's two's complement value v in [-8, 7] to v + 8 in
  // [0, 15]; 0x4300 | u is the bf16 128 + u, exactly; minus 136 gives v.
  static __device__ __forceinline__ void unpack(uint32_t word, uint32_t (&b)[4]) {
    word ^= 0x88888888u;
    const uint32_t lo = word & 0x0F0F0F0Fu;         // byte j: row 2r of column j
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

  static constexpr int kRows = 2;

  // packed rows k/2 + t (original rows k + 2t, 2t + 1: b0) and k/2 + t + 4
  // (b1)
  static __device__ __forceinline__ long long row(int k, int t, int r) {
    return k / 2 + t + 4 * r;
  }

  static __device__ __forceinline__ void frags(const uint32_t (&raw)[2], uint32_t (&b0)[4],
                                               uint32_t (&b1)[4]) {
    unpack(raw[0], b0);
    unpack(raw[1], b1);
  }
};

}  // namespace wq

// The split of the contraction that llark_int4_matmul expects for this shape.
extern "C" int llark_int4_matmul_splits(int m, int h, int d, int group) {
  return wq::splits(m, h, d, group);
}

// x [m, h] bf16, q4 [h/2, d] int8, scale [h/group, d] fp32, out [m, d] bf16,
// part [n_splits, m, d] fp32 scratch (unused with one split);
// group % 16 == 0, h % group == 0, d % 8 == 0; all contiguous. Returns the
// cudaError_t of the launch.
extern "C" int llark_int4_matmul(const void* x, const void* q4, const void* scale, void* out,
                                 void* part, int m, int h, int d, int group, int n_splits,
                                 void* stream) {
  return wq::launch<wq::Int4>(x, q4, scale, out, part, m, h, d, group, n_splits,
                          static_cast<cudaStream_t>(stream));
}
