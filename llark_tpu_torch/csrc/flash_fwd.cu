// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax state.
//
// Replaces the TPU kernel llark_tpu/ops/attention.py `_flash_fwd_kernel`
// (reached through `flash_attention_fwd`): blocked online-softmax attention
// with causal tile skip plus in-tile triangle, per-row kv_lengths, in-kernel
// ALiBi `|slope| * (k_pos - q_pos)`, GQA (q head h reads kv head h / group)
// and zeros for fully masked rows. With an `lse` pointer it also writes the
// per-row log-sum-exp of the scaled, biased scores ([B, H, Sq] fp32, natural
// log) that the backward (flash_bwd.cu) rebuilds the probabilities from; a
// row that sees no key gets +0.7 * FLT_MAX there, so exp(s - lse) is 0.
//
// What bounds it on the H100: at the serving prefill shape ([B, 32, 384, 128]
// causal) the work is ~4.8 GFLOP against ~50 MB of q/k/v/o, so the least time
// is the memory side (~15 us at 3.35 TB/s); the tensor cores could do the
// FLOPs in ~5 us. The design reads each K/V tile once per 64-row query tile,
// skips every tile past the causal diagonal or past the row's live length
// (no bytes, no FLOPs), and keeps the S x S scores out of device memory.
// Both products run on the tensor cores as mma.sync m16n8k16 (bf16 in, fp32
// accumulate) with the FlashAttention-2 register layout: each warp keeps its
// 16 query rows' Q fragments, scores and running output in registers, does
// the online softmax there (row statistics reduced across the 4 lanes that
// share a row), and feeds the probabilities back as the A operand of P.V
// without a trip through shared memory. Only the K and V tiles pass through
// shared memory. wgmma, TMA, cp.async pipelining and warp specialisation
// are left for later work.
//
// Layout: one thread block of 4 warps per (q tile of 64 rows, head, batch
// row); warp w owns query rows [16w, 16w + 16) of the tile.
//
// mma.m16n8k16 fragments (lane = 4 * g + t): A (16x16, row-major) holds
// rows g and g+8 at columns 2t, 2t+1 (regs 0, 1) and 2t+8, 2t+9 (regs 2, 3);
// B (16x8) holds column g at rows 2t, 2t+1 (reg 0) and 2t+8, 2t+9 (reg 1);
// C (16x8, fp32) holds rows g (c0, c1) and g+8 (c2, c3) at columns 2t, 2t+1
// (mma_tiles.cuh).

#include <float.h>

#include "mma_tiles.cuh"

namespace {

using namespace tiles;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int NTHREADS = 128;

// Shared-memory plan: Q, K and V tiles, rows padded by 16 bytes so the
// fragment loads of a warp fall on distinct banks.
template <int D>
struct Plan {
  static constexpr int LD = D + 8;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(BQ) * LD * 2;
  static constexpr size_t v_off = k_off + size_t(BK) * LD * 2;
  static constexpr size_t bytes = v_off + size_t(BK) * LD * 2;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ kv_lengths,
                 const float* __restrict__ slopes, int group, int Sq, int Sk,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_ss, int causal,
                 float scale) {
  using P = Plan<D>;
  constexpr int LD = P::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + P::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + P::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + P::v_off);

  // heaviest (latest) causal tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  const int kv_len = min(max(kv_lengths[b], 0), Sk);
  const float slope = slopes != nullptr ? fabsf(slopes[h]) : 0.f;

  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;
  {
    bf16* const dst[1] = {sQ};
    const bf16* const src[1] = {q + b * q_sb + h * q_sh};
    const long long ss[1] = {q_ss};
    load_tiles<D, BQ, 1, NTHREADS>(dst, LD, src, ss, q0, Sq);
  }
  __syncthreads();

  // this warp's Q rows as A fragments, one per 16 columns of D
  uint32_t qf[D / 16][4];
  {
    const bf16* qrow = sQ + (warp * 16 + g) * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = ld32(qrow + kk * 16);
      qf[kk][1] = ld32(qrow + 8 * LD + kk * 16);
      qf[kk][2] = ld32(qrow + kk * 16 + 8);
      qf[kk][3] = ld32(qrow + 8 * LD + kk * 16 + 8);
    }
  }

  // running state of rows g and g + 8 of the warp; l is this lane's partial
  // sum over its columns (the 4 lanes of a row share m, so the partial sums
  // rescale consistently and are added up once at the end)
  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // keys past the row's live length, or (causal) past the tile's last
  // query, are never read
  int k_end = kv_len;
  if (causal) k_end = min(k_end, min(q0 + BQ, Sq));
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    {
      // rows at or past kv_len are masked below; zero-filling them also
      // keeps 0 * non-finite out of the P.V product
      bf16* const dst[2] = {sK, sV};
      const bf16* const src[2] = {kb, vb};
      const long long ss[2] = {k_ss, v_ss};
      load_tiles<D, BK, 2, NTHREADS>(dst, LD, src, ss, k0, kv_len);
    }
    __syncthreads();

    // S = Q K^T: 16 rows x BK keys as BK/8 C fragments
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const bf16* krow = sK + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma16816(s[j], qf[kk], ld32(krow), ld32(krow + 8));
      }
    }

    // scale, ALiBi, masks; the tile's row maxima
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = kpos < kv_len && (!causal || kpos <= qpos[r]);
        const float val = s[j][e] * scale + slope * (float)(kpos - qpos[r]);
        s[j][e] = ok ? val : -INFINITY;
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = m_new == -INFINITY ? 1.f : __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[j][e] == -INFINITY ? 0.f : __expf(s[j][e] - m[r]);
        s[j][e] = p;
        l[r] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: the probabilities (rounded to bf16) are the A fragments,
    // 16 keys per step
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint32_t pa[4] = {
          pack_f2(s[2 * ks][0], s[2 * ks][1]), pack_f2(s[2 * ks][2], s[2 * ks][3]),
          pack_f2(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          pack_f2(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const bf16* vrow = sV + (ks * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* vp = vrow + n * 8;
        mma16816(acc[n], pa, pack2(vp, vp + LD), pack2(vp + 8 * LD, vp + 9 * LD));
      }
    }
  }

  // normalise; a row that saw no key (l == 0) writes zeros
  bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    if (lse != nullptr && t == 0 && qpos[r] < Sq) {
      lse[((long long)b * gridDim.y + h) * Sq + qpos[r]] =
          lsum > 0.f ? m[r] + logf(lsum) : 0.7f * FLT_MAX;
    }
    if (qpos[r] < Sq) {
      bf16* orow = ob + (long long)qpos[r] * o_ss + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* kv_lengths, const float* slopes, int B, int H,
                   int Hkv, int Sq, int Sk, const long long* st, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = Plan<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, kv_lengths, slopes,
      H / Hkv, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], causal, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. q [B,H,Sq,D], k/v [B,Hkv,Sk,D], o
// [B,H,Sq,D], all bf16 with unit stride in D; `strides` holds the
// (batch, head, seq) element strides of q, k, v, o in that order. `lse`
// ([B,H,Sq] fp32, contiguous) and `slopes` may be null (no log-sum-exp, no
// ALiBi). Returns the launch's cudaError_t.
extern "C" int llark_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, const int* kv_lengths,
                               const float* slopes, int B, int H, int Hkv,
                               int Sq, int Sk, int D, const long long* strides,
                               int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, lse, kv_lengths, slopes, B, H, Hkv, Sq, Sk,
                      strides, causal, scale, s);
  if (D == 128)
    return launch<128>(q, k, v, o, lse, kv_lengths, slopes, B, H, Hkv, Sq, Sk,
                       strides, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
