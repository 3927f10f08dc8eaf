// Flash-attention backward for Hopper (sm_90a): one pass over the visible
// (key tile, query tile) pairs that yields dq, dk and dv, bf16 or fp32 in
// (fp32 q, k, v, dO rounded to bf16 as they are staged; O read as it is),
// fp32 accumulate, on wgmma, the gradients in the inputs' dtype.
//
// Replaces the TPU kernels llark_tpu/ops/attention.py `_flash_bwd_dq_kernel`
// and `_flash_bwd_dkv_kernel` (called at :536 and :570) and the delta
// reduction before them (:522-527). The probabilities are rebuilt from q, k
// and the forward's per-row log-sum-exp (flash_fwd.cu), never stored:
//   p  = exp(s * scale + |slope| * (k_pos - q_pos) - lse)   (0 where masked)
//   ds = p * (dO . v^T - delta) * scale,   delta = rowsum(dO * O)
//   dq = ds . k,   dk = ds^T . q,   dv = p^T . dO
// with the forward's masks: causal, per-row kv_lengths, ALiBi, GQA (dk/dv
// summed over the q heads of a kv head).
//
// What bounds it on the H100: five products of 2 * D FLOPs per visible
// (query, key) pair. At the training shape ([2, 32, 1024, 128] causal,
// kv_len [1024, 700]) that is 40.8 GFLOP, 0.0413 ms at 989 TF/s, against
// ~129 MB that must move (q, dO, O once, k and v to each row's kv_len,
// lse, and dq, dk, dv once), 0.0385 ms at 3.35 TB/s: the tensor cores
// bound it. The design:
//   * three kernels on one stream: `flash_bwd_pre` reads dO and O once and
//     writes delta [B, H, Sq] fp32, and zeroes an fp32 dq accumulator
//     [B, H, Sq, D]; `flash_bwd_kernel` does the products; `flash_bwd_dq`
//     rounds the accumulator to bf16 dq;
//   * one block of two warpgroups per (128-key tile, kv head, batch row),
//     the key tiles that the causal mask leaves the most queries first. Each
//     warpgroup owns 64 keys and keeps their dk and dv accumulators in
//     registers. The block loads K and V once and walks the 64-row query
//     tiles from the causal diagonal on, for each q head of its GQA group,
//     so dk and dv come out summed over the group;
//   * per query tile five products, each once: S^T = K Q^T and dP^T =
//     V dO^T (wgmma, both operands from shared memory), then P^T (exp2 on
//     the special-function unit, the mask tests skipped on tiles no mask
//     touches) while dP^T still runs, and dS^T; dV += P^T dO and dK += dS^T Q
//     take P^T and dS^T as register A operands (the accumulator layout of
//     the first products is the A layout of the next) with dO and Q as
//     transposed shared-memory B operands; dS^T goes to shared memory once
//     and dQ's partial dS K is split over the two warpgroups along D
//     (64 x D/2 each), read as a transposed A and a transposed B. No
//     product is left on mma.sync;
//   * the partial dq of each (key tile, query tile) pair is added into the
//     fp32 accumulator with 16-byte vector atomics (`atomicAdd` on float4),
//     the scheme of FlashAttention-2/3. The order of those fp32 sums varies
//     from run to run, so dq is not bitwise reproducible (dk and dv are);
//   * Q, dO, lse and delta stream through a two-stage ring in shared memory
//     filled by cp.async 16-byte copies (4-byte for lse, delta), so query
//     tile i + 1 loads while tile i computes. Rows at or past Sq or kv_len
//     are zero-filled and masked with a select, so no masked value can turn
//     into NaN. Keys at or past kv_len get exact zeros in dk and dv.
// What is left on the table (H100, PERF.md): one block per SM (255
// registers a thread) runs each tile's phases in order, so the tensor cores
// idle through the exponentials, the atomics and three barriers a tile.
// Measured no faster: a three-stage ring, one warpgroup per block (two
// blocks an SM), dQ carried into the next tile, TMA bulk reductions for dq;
// alone, wgmma streams from this layout run about as fast as from
// 128-byte swizzled tiles.
// Shared-memory tiles use wgmma's layout without swizzle (wgmma.cuh).

#include "mma_tiles.cuh"
#include "wgmma.cuh"

namespace {

using namespace hopper;
using tiles::pack_f2;

constexpr int NWG = 2;          // warpgroups per block, 64 keys each
constexpr int NT = 128 * NWG;
constexpr int BK = 64 * NWG;    // keys per block
constexpr int BQ = 64;          // query rows per tile
constexpr int STAGES = 2;       // depth of the Q / dO / lse / delta ring

// shared memory: K, V (the block's keys), the ring of Q, dO, lse, delta
// tiles, and dS^T ([BK keys, BQ queries] bf16)
template <int D>
struct Plan {
  static constexpr int RB = D * 16;  // bytes per 8-row block of a [*, D] tile
  static constexpr size_t kv_tile = size_t(BK) * D * 2;
  static constexpr size_t q_tile = size_t(BQ) * D * 2;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + kv_tile;
  static constexpr size_t q_off = v_off + kv_tile;
  static constexpr size_t do_off = q_off + STAGES * q_tile;
  static constexpr size_t ds_off = do_off + STAGES * q_tile;
  static constexpr size_t lse_off = ds_off + size_t(BK) * BQ * 2;
  static constexpr size_t delta_off = lse_off + STAGES * BQ * 4;
  static constexpr size_t bytes = delta_off + STAGES * BQ * 4;
};

constexpr int DS_RB = BQ * 16;  // bytes per 8-key block of dS^T

struct Strides {
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s, do_b, do_h, do_s;
};

// rows [r0, r0 + ROWS) of a [*, D] matrix (row stride ss) into a bf16
// core-matrix tile; rows at or past `limit` are zeros. bf16 (T = bf16):
// cp.async copies, waited for with the block's cp.async groups. fp32: every
// chunk (8 values, two 16-byte loads) of a round is loaded into registers
// before the first store, converted to bf16 and stored; the block's
// fence_proxy_async and barrier before the products cover the stores.
template <class T, int D, int ROWS>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const T* src, long long ss,
                                          int r0, int limit) {
  constexpr int CH = D / 8;
  constexpr int N = ROWS * CH / NT;
  static_assert(ROWS * CH % NT == 0, "whole copy rounds");
  auto row_of = [](int i) { return ((i >> 3) / CH) * 8 + (i & 7); };
  auto col_of = [](int i) { return ((i >> 3) % CH) * 8; };
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int i = threadIdx.x + it * NT;
      const int r = row_of(i);
      const bool ok = r0 + r < limit;
      const T* p = ok ? src + (long long)(r0 + r) * ss + col_of(i) : src;
      cp_async16(dst + i * 16, p, ok);
    }
  } else {
    constexpr int R = N < 4 ? N : 4;  // chunks a round, to bound the registers
#pragma unroll
    for (int it0 = 0; it0 < N; it0 += R) {
      float4 v[R][2];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int i = threadIdx.x + (it0 + u) * NT;
        const int r = row_of(i);
        v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < limit) {
          const float4* p = reinterpret_cast<const float4*>(src + (long long)(r0 + r) * ss + col_of(i));
          v[u][0] = p[0];
          v[u][1] = p[1];
        }
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int i = threadIdx.x + (it0 + u) * NT;
        *reinterpret_cast<uint4*>(dst + i * 16) = tiles::pack_f8(v[u][0], v[u][1]);
      }
    }
  }
}

// 8 neighbouring values of a bf16 or fp32 row as floats; with `as_bf16`
// fp32 values are rounded to bf16 first, as the products see them
__device__ __forceinline__ void load8f(float (&f)[8], const bf16* p, bool) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x, f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load8f(float (&f)[8], const float* p, bool as_bf16) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  if (as_bf16) {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(__float2bfloat16(f[i]));
  }
}

// two neighbouring values into a bf16 or fp32 row
__device__ __forceinline__ void store2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

template <class T, int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq_acc, T* __restrict__ dk, T* __restrict__ dv,
                 const int* __restrict__ kv_lengths, const float* __restrict__ slopes,
                 int group, int Sq, int Sk, Strides st, int causal, float scale) {
  using P = Plan<D>;
  constexpr int RB = P::RB;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sK = smem + P::k_off;
  unsigned char* sV = smem + P::v_off;
  unsigned char* sDS = smem + P::ds_off;
  float* s_lse = reinterpret_cast<float*>(smem + P::lse_off);
  float* s_delta = reinterpret_cast<float*>(smem + P::delta_off);

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BK;  // z = 0 first: under the causal mask the most queries
  const int Hkv = gridDim.x;
  const int H = Hkv * group;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kv_len = min(max(kv_lengths[b], 0), Sk);

  // queries before k0 see none of these keys under the causal mask
  const int q_first = causal ? k0 / BQ : 0;
  const int per_head = max((Sq + BQ - 1) / BQ - q_first, 0);
  const int n_it = k0 < kv_len ? group * per_head : 0;

  // this thread's keys (accumulator rows): kpos[0] and kpos[0] + 8
  const int krow = wg * 64 + warp * 16 + g;
  const int kpos[2] = {k0 + krow, k0 + krow + 8};
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // the Q, dO, lse and delta tiles of iteration `it` into ring stage `stg`
  auto prefetch = [&](int it, int stg) {
    const int h = hk * group + it / per_head;
    const int q0 = (q_first + it % per_head) * BQ;
    copy_tile<T, D, BQ>(smem + P::q_off + stg * P::q_tile, q + b * st.q_b + h * st.q_h, st.q_s,
                        q0, Sq);
    copy_tile<T, D, BQ>(smem + P::do_off + stg * P::q_tile, dout + b * st.do_b + h * st.do_h,
                        st.do_s, q0, Sq);
    if (tid < 2 * BQ) {
      const int i = tid & (BQ - 1);
      const float* src = (tid < BQ ? lse : delta) + ((long long)b * H + h) * Sq;
      const bool ok = q0 + i < Sq;
      cp_async4((tid < BQ ? s_lse : s_delta) + stg * BQ + i, ok ? src + q0 + i : src, ok);
    }
  };

  // add this warpgroup's dQ partial (64 rows x DQN columns) into the fp32
  // accumulator, 4 neighbouring columns per lane: the even lane of a pair
  // takes row g, the odd one g + 8
  constexpr int DQN = D / NWG;
  float dqp[DQN / 2];
  auto add_dq = [&](int h, int q0) {
    const long long row_base = ((long long)b * H + h) * Sq;
    const bool even = (t & 1) == 0;
    const int qr = q0 + warp * 16 + g + (even ? 0 : 8);
#pragma unroll
    for (int j = 0; j < DQN / 8; ++j) {
      const float x0 = __shfl_xor_sync(0xffffffffu, even ? dqp[4 * j + 2] : dqp[4 * j], 1);
      const float x1 = __shfl_xor_sync(0xffffffffu, even ? dqp[4 * j + 3] : dqp[4 * j + 1], 1);
      const float4 val = even ? make_float4(dqp[4 * j], dqp[4 * j + 1], x0, x1)
                              : make_float4(x0, x1, dqp[4 * j + 2], dqp[4 * j + 3]);
      if (qr < Sq) {
        atomicAdd(reinterpret_cast<float4*>(dq_acc + (row_base + qr) * D + wg * DQN + j * 8 +
                                            2 * (t & 2)),
                  val);
      }
    }
  };

  if (n_it > 0) {
    copy_tile<T, D, BK>(sK, k + b * st.k_b + hk * st.k_h, st.k_s, k0, kv_len);
    copy_tile<T, D, BK>(sV, v + b * st.v_b + hk * st.v_h, st.v_s, k0, kv_len);
    prefetch(0, 0);
    cp_async_commit();
  }

  for (int it = 0; it < n_it; ++it) {
    const int stg = it % STAGES;
    if (it + 1 < n_it) prefetch(it + 1, (it + 1) % STAGES);
    cp_async_commit();
    cp_async_wait<1>();  // this iteration's tiles (and K, V) have landed
    fence_proxy_async();
    __syncthreads();

    const int h = hk * group + it / per_head;
    const int q0 = (q_first + it % per_head) * BQ;
    const float slope = slopes != nullptr ? fabsf(slopes[h]) : 0.f;
    const unsigned char* sQ = smem + P::q_off + stg * P::q_tile;
    const unsigned char* sdO = smem + P::do_off + stg * P::q_tile;
    const float* lse_t = s_lse + stg * BQ;
    const float* delta_t = s_delta + stg * BQ;

    // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 queries
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<0, 0>(s, make_desc(sK + wg * 8 * RB + kk * 256, 128, RB),
                     make_desc(sQ + kk * 256, 128, RB), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<0, 0>(dp, make_desc(sV + wg * 8 * RB + kk * 256, 128, RB),
                     make_desc(sdO + kk * 256, 128, RB), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T is done; dP^T may still run
    fence_regs(s);

    // P^T in place of S^T, and as bf16 A operands (one per 16 queries)
    uint32_t pa[4][4], dsa[4][4];
    // exp2 of s * scale * log2(e) + ALiBi * log2(e) - lse * log2(e); a tile
    // that no mask touches skips the tests
    const bool interior = (!causal || q0 >= k0 + BK - 1) && k0 + BK <= kv_len && q0 + BQ <= Sq;
    const float scale2 = scale * 1.4426950408889634f, slope2 = slope * 1.4426950408889634f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kpos[e >> 1];
        const int qi = j * 8 + 2 * t + (e & 1);
        const int qp = q0 + qi;
        const float x = fmaf(s[4 * j + e], scale2,
                             fmaf(slope2, (float)(kp - qp), -lse_t[qi] * 1.4426950408889634f));
        const float pe = ex2(x);
        s[4 * j + e] = interior || (kp < kv_len && qp < Sq && (!causal || kp <= qp)) ? pe : 0.f;
      }
      pa[j >> 1][(j & 1) * 2] = pack_f2(s[4 * j], s[4 * j + 1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_f2(s[4 * j + 2], s[4 * j + 3]);
    }
    // dV += P^T dO while dP^T finishes
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks) {
      wgmma_rs<1>(dv_acc, pa[ks], make_desc(sdO + ks * 2 * RB, RB, 128), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is done
    fence_regs(dp);

    // dS^T, as bf16 A operands and into shared memory for dQ
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dsv[e] = s[4 * j + e] * (dp[4 * j + e] - delta_t[j * 8 + 2 * t + (e & 1)]) * scale;
      }
      dsa[j >> 1][(j & 1) * 2] = pack_f2(dsv[0], dsv[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack_f2(dsv[2], dsv[3]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kr = krow + 8 * r;
        *reinterpret_cast<uint32_t*>(sDS + ((kr >> 3) * (BQ / 8) + j) * 128 + (kr & 7) * 16 +
                                     t * 4) = dsa[j >> 1][(j & 1) * 2 + r];
      }
    }

    // dK += dS^T Q, 16 queries per step
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks) {
      wgmma_rs<1>(dk_acc, dsa[ks], make_desc(sQ + ks * 2 * RB, RB, 128), 1);
    }
    wgmma_commit();
    fence_proxy_async();
    __syncthreads();  // dS^T of every warpgroup is in shared memory

    // dQ[:, wg * DQN : (wg + 1) * DQN] = dS K[:, those columns], over the
    // block's keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_ss<1, 1>(dqp, make_desc(sDS + kk * 2 * DS_RB, DS_RB, 128),
                     make_desc(sK + wg * (DQN / 8) * 128 + kk * 2 * RB, RB, 128), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqp);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fence_regs(pa[i]);
      fence_regs(dsa[i]);
    }
    add_dq(h, q0);
    __syncthreads();  // the ring stage and dS^T may be overwritten
  }

  // dk, dv are contiguous [B, Hkv, Sk, D]; keys at or past kv_len are zeros
  const long long out_base = ((long long)b * Hkv + hk) * Sk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] < Sk) {
      const bool live = kpos[r] < kv_len;
      T* krow_p = dk + (out_base + kpos[r]) * D + 2 * t;
      T* vrow_p = dv + (out_base + kpos[r]) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        store2(krow_p + j * 8, live ? dk_acc[4 * j + 2 * r] : 0.f,
               live ? dk_acc[4 * j + 2 * r + 1] : 0.f);
        store2(vrow_p + j * 8, live ? dv_acc[4 * j + 2 * r] : 0.f,
               live ? dv_acc[4 * j + 2 * r + 1] : 0.f);
      }
    }
  }
}

// delta = rowsum(dO * O) in fp32, and the dq accumulator's rows zeroed.
// D / 8 threads per row, each 8 elements of dO and of O.
template <class T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_pre(const T* __restrict__ out, const T* __restrict__ dout,
              float* __restrict__ delta, float* __restrict__ dq_acc, int H, int Sq,
              long long n_rows, Strides st) {
  constexpr int TPR = D / 8;
  const long long row = (long long)blockIdx.x * (256 / TPR) + threadIdx.x / TPR;
  const int c = threadIdx.x % TPR;
  float sum = 0.f;
  if (row < n_rows) {
    const long long bh = row / Sq;
    const long long s = row % Sq;
    const long long b = bh / H, h = bh % H;
    // dO as dP = dO . v^T sees it (rounded to bf16), O as the forward wrote
    // it: for a row that sees one key, O is that key's rounded v, and
    // dP - delta is 0 as in exact arithmetic
    float of[8], df[8];
    load8f(of, out + b * st.o_b + h * st.o_h + s * st.o_s + c * 8, false);
    load8f(df, dout + b * st.do_b + h * st.do_h + s * st.do_s + c * 8, true);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += of[i] * df[i];
    float4* acc = reinterpret_cast<float4*>(dq_acc + row * D + c * 8);
    acc[0] = acc[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < n_rows && c == 0) delta[row] = sum;
}

// dq = bf16(dq_acc), 8 elements a thread
__global__ void __launch_bounds__(256)
flash_bwd_dq(const float* __restrict__ dq_acc, bf16* __restrict__ dq, long long n8) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n8) return;
  const float4* src = reinterpret_cast<const float4*>(dq_acc) + 2 * i;
  const float4 a = src[0], b = src[1];
  uint4 o;
  o.x = pack_f2(a.x, a.y);
  o.y = pack_f2(a.z, a.w);
  o.z = pack_f2(b.x, b.y);
  o.w = pack_f2(b.z, b.w);
  reinterpret_cast<uint4*>(dq)[i] = o;
}

Strides unpack(const long long* s) {
  return Strides{s[0], s[1], s[2],  s[3],  s[4],  s[5],  s[6], s[7],
                 s[8], s[9], s[10], s[11], s[12], s[13], s[14]};
}

template <class T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* delta, float* dq_acc, void* dq,
                   void* dk, void* dv, const int* kv_lengths, const float* slopes, int B,
                   int H, int Hkv, int Sq, int Sk, const long long* strides, int causal,
                   float scale, cudaStream_t stream) {
  const Strides st = unpack(strides);
  const long long n_rows = (long long)B * H * Sq;
  constexpr int rows_per_block = 256 / (D / 8);
  flash_bwd_pre<T, D><<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block), 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, dq_acc, H, Sq, n_rows, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = Plan<D>::bytes;
  err = cudaFuncSetAttribute(flash_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B, (Sk + BK - 1) / BK);
  flash_bwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq_acc, static_cast<T*>(dk),
      static_cast<T*>(dv), kv_lengths, slopes, H / Hkv, Sq, Sk, st, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // fp32: the accumulator is dq itself (dq_acc == dq), nothing to round
  if (sizeof(T) == 4) return cudaSuccess;

  const long long n8 = n_rows * D / 8;
  flash_bwd_dq<<<(unsigned)((n8 + 255) / 256), 256, 0, stream>>>(dq_acc, static_cast<bf16*>(dq),
                                                                  n8);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. q, out, dout [B,H,Sq,D] and k, v
// [B,Hkv,Sk,D], all bf16 (f32 = 0) or all fp32 (f32 = 1: rounded to bf16 as
// they are staged for the products), unit stride in D, 16-byte aligned
// rows; `strides` holds the (batch, head, seq) element strides of q, k, v,
// out, dout in that order. lse is contiguous [B,H,Sq] fp32. delta [B,H,Sq]
// and dq_acc [B,H,Sq,D] are contiguous fp32 scratch the kernels fill; dq
// [B,H,Sq,D] and dk, dv [B,Hkv,Sk,D] are contiguous outputs in the inputs'
// dtype (fp32: dq_acc must be dq, which the accumulator then is). Sq and Sk
// must be positive. `slopes` may be null (no ALiBi). Returns the first
// launch's non-zero cudaError_t, else 0.
extern "C" int llark_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                               const void* dout, const float* lse, float* delta, float* dq_acc,
                               void* dq, void* dk, void* dv, const int* kv_lengths,
                               const float* slopes, int B, int H, int Hkv, int Sq, int Sk, int D,
                               const long long* strides, int causal, float scale, int f32,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32 && dq_acc != dq) return (int)cudaErrorInvalidValue;
#define BWD_LAUNCH(T, DD)                                                                     \
  launch<T, DD>(q, k, v, out, dout, lse, delta, dq_acc, dq, dk, dv, kv_lengths, slopes, B, H, \
                Hkv, Sq, Sk, strides, causal, scale, s)
  if (D == 64) return f32 ? BWD_LAUNCH(float, 64) : BWD_LAUNCH(bf16, 64);
  if (D == 128) return f32 ? BWD_LAUNCH(float, 128) : BWD_LAUNCH(bf16, 128);
#undef BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}
