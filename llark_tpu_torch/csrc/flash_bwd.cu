// Flash-attention backward for Hopper (sm_90a): a dq kernel and a dk/dv
// kernel, bf16 in, fp32 accumulate.
//
// Replaces the TPU kernels llark_tpu/ops/attention.py `_flash_bwd_dq_kernel`
// and `_flash_bwd_dkv_kernel` (reached through `flash_attention_bwd`). Both
// rebuild the probabilities from q, k and the forward's per-row log-sum-exp
// (flash_fwd.cu) instead of reading an S x S matrix, then
//   p  = exp(s * scale + |slope| * (k_pos - q_pos) - lse)   (0 where masked)
//   ds = p * (dO . v^T - delta) * scale,   delta = rowsum(dO * O)
//   dq = ds . k,   dk = ds^T . q,   dv = p^T . dO
// with the forward's masks: causal, per-row kv_lengths, ALiBi, GQA. delta is
// a [B, H, Sq] fp32 reduction the caller computes beforehand, as the JAX
// package does.
//
// What bounds them on the H100: at the training shape ([2, 32, 1024, 128]
// causal) each kernel does ~2x the forward's products (~13 GFLOP together
// with half the pairs masked) against ~50 MB of q/k/v/dO/outputs, so both
// are bound by the tensor cores (~13 us at 989 TF/s) well before memory
// (~15 us at 3.35 TB/s only if every input were read once). The design
// keeps every S x S quantity in registers, skips tiles past the causal
// diagonal or past the live length, and runs all four products per tile
// pair on the tensor cores as mma.sync m16n8k16 (p and ds rounded to bf16
// only as operands). wgmma, TMA and pipelining are left for later work.
//
// dq kernel: one block of 4 warps per (q tile of 64 rows, head, batch row);
// warp w owns query rows [16w, 16w + 16) and keeps their dq accumulator in
// registers while it walks the K/V tiles up to the causal or live limit.
//
// dk/dv kernel: one block of 4 warps per (k tile of 64 keys, kv head, batch
// row); warp w owns keys [16w, 16w + 16) and keeps their dk and dv
// accumulators in registers. The TPU kernel carried them across a
// sequential grid axis over the q blocks; Hopper blocks run in no order, so
// the block itself loops over the q tiles (32 rows each, from the first one
// that reaches the tile on the causal diagonal) and, for GQA, over the q
// heads that share its kv head: dk/dv come out already summed over the
// group. Keys at or past kv_len get exact zeros.
//
// Scores are computed transposed there (keys as rows): S^T = K Q^T, so the
// row statistics lse and delta are per column and come from shared memory.

#include <float.h>

#include "mma_tiles.cuh"

namespace {

using namespace tiles;

constexpr int NTHREADS = 128;
constexpr int DQ_BQ = 64;  // dq kernel: query rows per block
constexpr int DQ_BK = 64;  // dq kernel: keys per tile
constexpr int KV_BK = 64;  // dk/dv kernel: keys per block
constexpr int KV_BQ = 32;  // dk/dv kernel: query rows per tile
constexpr float NO_KEY_LSE = 0.7f * FLT_MAX;

// Shared memory of the dq kernel: Q, dO (the block's rows), K and V tiles,
// rows padded by 16 bytes so a warp's fragment loads fall on distinct banks.
template <int D>
struct DqPlan {
  static constexpr int LD = D + 8;
  static constexpr size_t tile = size_t(64) * LD * 2;
  static constexpr size_t bytes = 4 * tile;
};

// Shared memory of the dk/dv kernel: K, V (the block's keys), a Q and a dO
// tile, and that tile's lse and delta.
template <int D>
struct KvPlan {
  static constexpr int LD = D + 8;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + size_t(KV_BK) * LD * 2;
  static constexpr size_t q_off = v_off + size_t(KV_BK) * LD * 2;
  static constexpr size_t do_off = q_off + size_t(KV_BQ) * LD * 2;
  static constexpr size_t lse_off = do_off + size_t(KV_BQ) * LD * 2;
  static constexpr size_t delta_off = lse_off + KV_BQ * 4;
  static constexpr size_t bytes = delta_off + KV_BQ * 4;
};

struct Strides {
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, do_b, do_h, do_s;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, const int* __restrict__ kv_lengths,
                    const float* __restrict__ slopes, int group, int Sq, int Sk,
                    Strides st, int causal, float scale) {
  using P = DqPlan<D>;
  constexpr int LD = P::LD;
  constexpr int BQ = DQ_BQ, BK = DQ_BK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + P::tile);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * P::tile);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * P::tile);

  // heaviest (latest) causal tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kv_len = min(max(kv_lengths[b], 0), Sk);
  const float slope = slopes != nullptr ? fabsf(slopes[h]) : 0.f;

  {
    bf16* const dst[2] = {sQ, sdO};
    const bf16* const src[2] = {q + b * st.q_b + h * st.q_h, dout + b * st.do_b + h * st.do_h};
    const long long ss[2] = {st.q_s, st.do_s};
    load_tiles<D, BQ, 2, NTHREADS>(dst, LD, src, ss, q0, Sq);
  }

  // rows g and g + 8 of the warp; a row past Sq gets lse = +BIG (p = 0)
  const long long row_base = ((long long)b * gridDim.y + h) * Sq;
  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_lse[r] = qpos[r] < Sq ? lse[row_base + qpos[r]] : NO_KEY_LSE;
    row_delta[r] = qpos[r] < Sq ? delta[row_base + qpos[r]] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int k_end = kv_len;
  if (causal) k_end = min(k_end, min(q0 + BQ, Sq));
  const int n_tiles = (k_end + BK - 1) / BK;
  const bf16* kb = k + b * st.k_b + hk * st.k_h;
  const bf16* vb = v + b * st.v_b + hk * st.v_h;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    {
      // rows at or past kv_len are zero, so masked products stay finite
      bf16* const dst[2] = {sK, sV};
      const bf16* const src[2] = {kb, vb};
      const long long ss[2] = {st.k_s, st.v_s};
      load_tiles<D, BK, 2, NTHREADS>(dst, LD, src, ss, k0, kv_len);
    }
    __syncthreads();

    // S = Q K^T, then P in place
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sQ, LD, warp * 16, kk * 16, g, t);
      mma_cols<BK / 8>(s, a, sK, LD, kk * 16, g, t);
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = kpos < kv_len && (!causal || kpos <= qpos[r]);
        const float val = s[j][e] * scale + slope * (float)(kpos - qpos[r]);
        s[j][e] = ok ? __expf(val - row_lse[r]) : 0.f;
      }
    }

    // dP = dO V^T, then dS = P (dP - delta) scale in place of P
    float dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sdO, LD, warp * 16, kk * 16, g, t);
      mma_cols<BK / 8>(dp, a, sV, LD, kk * 16, g, t);
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = s[j][e] * (dp[j][e] - row_delta[e >> 1]) * scale;
      }
    }

    // dQ += dS K, 16 keys per step
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      pack_a(a, s[2 * ks], s[2 * ks + 1]);
      mma_rows<D>(acc, a, sK, LD, ks * 16, g, t);
    }
  }

  // dq is contiguous [B, H, Sq, D]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] < Sq) {
      bf16* row = dq + (row_base + qpos[r]) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     const int* __restrict__ kv_lengths, const float* __restrict__ slopes,
                     int group, int Sq, int Sk, Strides st, int causal, float scale) {
  using P = KvPlan<D>;
  constexpr int LD = P::LD;
  constexpr int BQ = KV_BQ, BK = KV_BK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + P::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + P::v_off);
  bf16* sQ = reinterpret_cast<bf16*>(smem + P::q_off);
  bf16* sdO = reinterpret_cast<bf16*>(smem + P::do_off);
  float* s_lse = reinterpret_cast<float*>(smem + P::lse_off);
  float* s_delta = reinterpret_cast<float*>(smem + P::delta_off);

  // causal: the earliest key tiles see the most queries; they go first
  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y * group;
  const int k0 = kt * BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kv_len = min(max(kv_lengths[b], 0), Sk);
  const long long out_base = ((long long)b * gridDim.y + hk) * Sk;

  // this warp's keys g and g + 8, rows of its dk/dv accumulators
  const int kpos[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }

  if (k0 < kv_len) {
    {
      bf16* const dst[2] = {sK, sV};
      const bf16* const src[2] = {k + b * st.k_b + hk * st.k_h, v + b * st.v_b + hk * st.v_h};
      const long long ss[2] = {st.k_s, st.v_s};
      load_tiles<D, BK, 2, NTHREADS>(dst, LD, src, ss, k0, kv_len);
    }
    // queries before k0 see none of this tile's keys under the causal mask
    const int q_first = causal ? k0 / BQ : 0;
    const int n_qt = (Sq + BQ - 1) / BQ;
    for (int h = hk * group; h < (hk + 1) * group; ++h) {
      const float slope = slopes != nullptr ? fabsf(slopes[h]) : 0.f;
      const long long row_base = ((long long)b * H + h) * Sq;
      const bf16* qh = q + b * st.q_b + h * st.q_h;
      const bf16* doh = dout + b * st.do_b + h * st.do_h;
      for (int qt = q_first; qt < n_qt; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();  // every warp is done with the previous Q/dO tile
        {
          bf16* const dst[2] = {sQ, sdO};
          const bf16* const src[2] = {qh, doh};
          const long long ss[2] = {st.q_s, st.do_s};
          load_tiles<D, BQ, 2, NTHREADS>(dst, LD, src, ss, q0, Sq);
        }
        if (threadIdx.x < BQ) {
          const int qp = q0 + threadIdx.x;
          s_lse[threadIdx.x] = qp < Sq ? lse[row_base + qp] : NO_KEY_LSE;
          s_delta[threadIdx.x] = qp < Sq ? delta[row_base + qp] : 0.f;
        }
        __syncthreads();

        // S^T = K Q^T (keys x queries), then P^T in place
        float s[BQ / 8][4];
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          load_a(a, sK, LD, warp * 16, kk * 16, g, t);
          mma_cols<BQ / 8>(s, a, sQ, LD, kk * 16, g, t);
        }
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kpos[e >> 1];
            const int qi = j * 8 + 2 * t + (e & 1);
            const int qp = q0 + qi;
            const bool ok = kp < kv_len && qp < Sq && (!causal || kp <= qp);
            const float val = s[j][e] * scale + slope * (float)(kp - qp);
            s[j][e] = ok ? __expf(val - s_lse[qi]) : 0.f;
          }
        }

        // dV += P^T dO, 16 queries per step
#pragma unroll
        for (int ks = 0; ks < BQ / 16; ++ks) {
          uint32_t a[4];
          pack_a(a, s[2 * ks], s[2 * ks + 1]);
          mma_rows<D>(dv_acc, a, sdO, LD, ks * 16, g, t);
        }

        // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) scale in place
        float dp[BQ / 8][4];
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          load_a(a, sV, LD, warp * 16, kk * 16, g, t);
          mma_cols<BQ / 8>(dp, a, sdO, LD, kk * 16, g, t);
        }
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = j * 8 + 2 * t + (e & 1);
            s[j][e] = s[j][e] * (dp[j][e] - s_delta[qi]) * scale;
          }
        }

        // dK += dS^T Q
#pragma unroll
        for (int ks = 0; ks < BQ / 16; ++ks) {
          uint32_t a[4];
          pack_a(a, s[2 * ks], s[2 * ks + 1]);
          mma_rows<D>(dk_acc, a, sQ, LD, ks * 16, g, t);
        }
      }
    }
  }

  // dk, dv are contiguous [B, Hkv, Sk, D]; keys at or past kv_len are zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] < Sk) {
      const bool live = kpos[r] < kv_len;
      bf16* krow = dk + (out_base + kpos[r]) * D + 2 * t;
      bf16* vrow = dv + (out_base + kpos[r]) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(krow + n * 8) = __floats2bfloat162_rn(
            live ? dk_acc[n][2 * r] : 0.f, live ? dk_acc[n][2 * r + 1] : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(vrow + n * 8) = __floats2bfloat162_rn(
            live ? dv_acc[n][2 * r] : 0.f, live ? dv_acc[n][2 * r + 1] : 0.f);
      }
    }
  }
}

Strides unpack(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, const int* kv_lengths,
                      const float* slopes, int B, int H, int Hkv, int Sq, int Sk,
                      const long long* strides, int causal, float scale, cudaStream_t stream) {
  const size_t smem = DqPlan<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ, H, B);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), kv_lengths, slopes,
      H / Hkv, Sq, Sk, unpack(strides), causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       const int* kv_lengths, const float* slopes, int B, int H, int Hkv,
                       int Sq, int Sk, const long long* strides, int causal, float scale,
                       cudaStream_t stream) {
  const size_t smem = KvPlan<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + KV_BK - 1) / KV_BK, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), kv_lengths, slopes, H / Hkv, Sq, Sk, unpack(strides), causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. q, dout [B,H,Sq,D] and k, v
// [B,Hkv,Sk,D], bf16 with unit stride in D; `strides` holds the (batch,
// head, seq) element strides of q, k, v, dout in that order. lse and delta
// are contiguous [B,H,Sq] fp32; dq [B,H,Sq,D] and dk, dv [B,Hkv,Sk,D] are
// contiguous bf16 outputs. `slopes` may be null (no ALiBi). Each returns its
// launch's cudaError_t.
extern "C" int llark_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  void* dq, const int* kv_lengths, const float* slopes, int B,
                                  int H, int Hkv, int Sq, int Sk, int D,
                                  const long long* strides, int causal, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, kv_lengths, slopes, B, H, Hkv, Sq,
                         Sk, strides, causal, scale, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, kv_lengths, slopes, B, H, Hkv, Sq,
                          Sk, strides, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int llark_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   void* dk, void* dv, const int* kv_lengths,
                                   const float* slopes, int B, int H, int Hkv, int Sq, int Sk,
                                   int D, const long long* strides, int causal, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, kv_lengths, slopes, B, H, Hkv,
                          Sq, Sk, strides, causal, scale, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, kv_lengths, slopes, B, H, Hkv,
                           Sq, Sk, strides, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
