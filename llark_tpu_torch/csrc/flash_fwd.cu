// Flash-attention forward for Hopper (sm_90a), bf16 or fp32 in (fp32 q, k,
// v rounded to bf16 as they are staged, o written in fp32), fp32 softmax
// state, both products on wgmma.
//
// Replaces the TPU kernel llark_tpu/ops/attention.py `_flash_fwd_kernel`
// (reached through `flash_attention_fwd`, called at :319): blocked
// online-softmax attention with causal tile skip plus in-tile triangle,
// per-row kv_lengths (keys at or past a row's length are never read),
// in-kernel ALiBi `|slope| * (k_pos - q_pos)`, GQA (q head h reads kv head
// h / group) and zeros for a row that sees no key. With an `lse` pointer it
// also writes the per-row log-sum-exp of the scaled, biased scores ([B, H,
// Sq] fp32, natural log) that the backward (flash_bwd.cu) rebuilds the
// probabilities from; a row that sees no key gets +0.7 * FLT_MAX there, so
// exp(s - lse) is 0.
//
// What bounds it on the H100: two products of 2 * D FLOPs per visible
// (query, key) pair against q and o once and k, v up to each row's live
// length. At the training shape ([2, 32, 1024, 128] causal, kv_len [1024,
// 700]) that is 16.3 GFLOP, 0.0165 ms at 989 TF/s, against ~62 MB, 0.0185
// ms at 3.35 TB/s; at the serving prefill ([1, 32, 384, 128], causal, ~300
// live keys) ~11 MB and 1.4 GFLOP: the bytes bound both, narrowly at the
// training shape. The design:
//   * one block of two warpgroups per (128 query rows, head, batch row),
//     or of one warpgroup per 64 rows where blocks of two would leave SMs
//     idle (`launch`); each warpgroup owns 64 query rows and keeps their
//     output accumulator (64 x D fp32) and softmax state in registers. The
//     grid runs the query tiles of one batch row's heads together, the ones
//     with the most keys under the causal mask first, so the blocks in
//     flight share their K/V tiles in L2;
//   * Q is copied once; K and V stream through a two-stage ring of 64-key
//     tiles. Every thread copies its share of a tile with cp.async 16-byte
//     copies and arrives on the stage's `full` mbarrier when they land; each
//     warp arrives on `empty` once its products have read the tile, and the
//     stage is refilled when every warpgroup of the block has, so two need
//     not run in step. Rows at or past kv_len are zero-filled and their scores
//     selected to -inf before the exponential; keys past the causal
//     diagonal of the block's last row are never loaded, and a warpgroup
//     skips a tile that lies wholly past its own rows;
//   * every tile is kept in wgmma's 128-byte swizzle (wgmma.cuh), so a warp
//     copies whole 128-byte rows from device memory and writes them to
//     shared memory without bank conflicts. In the unswizzled core-matrix
//     layout a warp's copy spans 8 rows, 64 bytes each, and the K/V stream
//     held the kernel well below SDPA's flash backend;
//   * S = Q K^T by wgmma with both operands in shared memory (K-major), the
//     online softmax on the fp32 accumulator (rows 16w + g and 16w + g + 8 of
//     the warpgroup, shared by the 4 lanes of a quad), exp2 on the
//     special-function unit with scale * log2(e) folded into the scores and
//     the ALiBi slope, and the mask tests skipped on tiles no mask touches;
//   * O += P V by wgmma with P rounded to bf16 in registers as the A operand
//     (two neighbouring n8 blocks of S's accumulator are one k16 A operand)
//     and V read as the MN-major B operand from the same tile. No product
//     is left on mma.sync;
//   * the output goes through the warpgroup's own rows of the Q tile and out
//     as whole 16-byte row chunks;
//   * each build fits two blocks on an SM (two warpgroups: 128 registers a
//     thread, a few spilled, and 97 KB of shared memory a block at D =
//     128), so one block's loads and epilogue overlap the other's products.
// Measured no faster (H100, PERF.md): the unswizzled layout with four-row
// copies (bank conflicts), one warpgroup of 64 rows a block on grids that
// fill the card, three warpgroups, 128-key tiles, a three-stage ring (one
// block an SM), a build with no register cap (one block an SM), S of tile
// j + 1 issued before the softmax of tile j, the two warpgroups taking
// turns through named barriers, Q as a register operand, and a persistent
// grid that prefetched the next tile's Q and K/V across work items (its
// static schedule left SMs idle).

#include <float.h>

#include "mma_tiles.cuh"
#include "wgmma.cuh"

namespace {

using namespace hopper;
using tiles::pack_f2;
using tiles::quad_max;
using tiles::quad_sum;

// a block is NWG warpgroups of 64 query rows each (NWG 1 or 2: `launch`)
constexpr int BK = 64;         // keys per tile
constexpr int STAGES = 2;      // depth of the K/V ring
constexpr int MIN_BLOCKS = 2;  // blocks each build fits on one SM (registers)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// shared memory: the block's Q rows and the K and V rings, each an [*, D]
// bf16 tile in the 128-byte swizzle; then the ring's mbarriers. Every tile
// starts on a 1024-byte boundary.
template <int D, int BQ>
struct Plan {
  static constexpr size_t kv_tile = size_t(BK) * D * 2;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(BQ) * D * 2;
  static constexpr size_t v_off = k_off + STAGES * kv_tile;
  static constexpr size_t bar_off = v_off + STAGES * kv_tile;
  static constexpr size_t bytes = bar_off + 2 * STAGES * sizeof(uint64_t);
};

struct Strides {
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
};

// A [ROWS, D] bf16 tile in wgmma's 128-byte swizzle: column half hc (64
// columns, 128 bytes a row) at hc * ROWS * 128, row r at r * 128 within
// it, its 16-byte chunk c at chunk c ^ (r % 8).
template <int ROWS>
__device__ __forceinline__ int swizzled(int hc, int r, int c) {
  return hc * ROWS * 128 + r * 128 + ((c ^ (r & 7)) << 4);
}

// rows [r0, r0 + ROWS) of a [*, D] matrix (row stride ss) into a swizzled
// bf16 tile; rows at or past `limit` are zeros. A warp fills whole 128-byte
// rows: 4 rows, 8 chunks each. NT: the block's threads. bf16 (T = bf16):
// cp.async copies, which arrive on the stage's barrier when they land. fp32:
// every chunk (8 values, two 16-byte loads) is loaded into registers before
// the first store, converted to bf16 and stored, and the stores are fenced
// for wgmma's reads; the caller then arrives on the barrier itself.
template <class T, int D, int ROWS, int NT>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const T* src, long long ss,
                                          int r0, int limit) {
  constexpr int N = ROWS * D / 8;
  static_assert(N % NT == 0, "whole copy rounds");
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int it = 0; it < N / NT; ++it) {
      const int i = threadIdx.x + it * NT;
      const int hc = i / (ROWS * 8), r = (i / 8) % ROWS, c = i % 8;
      const bool ok = r0 + r < limit;
      const T* p = ok ? src + (long long)(r0 + r) * ss + hc * 64 + c * 8 : src;
      cp_async16(dst + swizzled<ROWS>(hc, r, c), p, ok);
    }
  } else {
    // in rounds of at most 4 chunks a thread, to bound the registers
    constexpr int R = N / NT < 4 ? N / NT : 4;
#pragma unroll
    for (int it0 = 0; it0 < N / NT; it0 += R) {
      float4 v[R][2];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int i = threadIdx.x + (it0 + u) * NT;
        const int hc = i / (ROWS * 8), r = (i / 8) % ROWS, c = i % 8;
        v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < limit) {
          const float4* p = reinterpret_cast<const float4*>(src + (long long)(r0 + r) * ss + hc * 64 + c * 8);
          v[u][0] = p[0];
          v[u][1] = p[1];
        }
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int i = threadIdx.x + (it0 + u) * NT;
        const int hc = i / (ROWS * 8), r = (i / 8) % ROWS, c = i % 8;
        *reinterpret_cast<uint4*>(dst + swizzled<ROWS>(hc, r, c)) = tiles::pack_f8(v[u][0], v[u][1]);
      }
    }
    fence_proxy_async();
  }
}

// wgmma descriptor of a swizzled tile: K-major (Q, K: the 16 columns of a
// k16 step lie in one 128-byte row; 8-row groups 1024 bytes apart) or
// MN-major (V: 64-column halves lbo apart, 8-key groups 1024 bytes apart)
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  return make_desc(p, lbo, 1024) | (uint64_t(1) << 62);
}

// the 128 threads of warpgroup `wg` meet (named barriers 1 and 2)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0) {
    bar_sync(1, 128);
  } else {
    bar_sync(2, 128);
  }
}

template <class T, int D, int NWG>
__global__ void __launch_bounds__(128 * NWG, MIN_BLOCKS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 const int* __restrict__ kv_lengths, const float* __restrict__ slopes,
                 int group, int Sq, int Sk, Strides st, int causal, float scale2) {
  constexpr int NT = 128 * NWG;
  constexpr int BQ = 64 * NWG;  // query rows per block
  using P = Plan<D, BQ>;
  constexpr int CH = D / 8;  // 16-byte chunks per bf16 row
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sQ = smem + P::q_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::bar_off);
  uint64_t* empty = full + STAGES;
  if (smem_addr(smem) & 1023) __trap();  // the swizzle is of absolute addresses

  // x: q head; y: query tile, the most keys under the causal mask first;
  // z: batch row
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int H = gridDim.x;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kv_len = min(max(kv_lengths[b], 0), Sk);
  const float slope2 = slopes != nullptr ? fabsf(slopes[h]) * LOG2E : 0.f;
  const T* kb = k + b * st.k_b + hk * st.k_h;
  const T* vb = v + b * st.v_b + hk * st.v_h;

  // keys at or past the row's live length, or (causal) past the block's
  // last query, are never read
  const int wq0 = q0 + wg * 64;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, min(q0 + BQ, Sq));
  const int n_tiles = max((k_end + BK - 1) / BK, 0);

  // The ring: tile j sits in stage j % STAGES. Every thread copies its
  // share of a tile and arrives on the stage's `full` barrier when its
  // copies land; each warp arrives on `empty` once its products have read
  // the tile. Before a warpgroup consumes tile j it copies tile j + 1 into
  // the stage that tile j - 1 held, once every warpgroup has released it.
  if (tid < STAGES) {
    mbar_init(full + tid, NT);
    mbar_init(empty + tid, NT / 32);
  }
  __syncthreads();
  auto load = [&](int tile) {
    const int stg = tile % STAGES;
    if (tile >= STAGES) mbar_wait(empty + stg, (tile / STAGES - 1) & 1);
    copy_tile<T, D, BK, NT>(smem + P::k_off + stg * P::kv_tile, kb, st.k_s, tile * BK, kv_len);
    copy_tile<T, D, BK, NT>(smem + P::v_off + stg * P::kv_tile, vb, st.v_s, tile * BK, kv_len);
    if constexpr (F32) {
      mbar_arrive(full + stg);
    } else {
      cp_async_arrive(full + stg);
    }
  };
  if (n_tiles > 0) {
    copy_tile<T, D, BQ, NT>(sQ, q + b * st.q_b + h * st.q_h, st.q_s, q0, Sq);
    load(0);
  }

  // this thread's rows: qpos[0] and qpos[0] + 8
  const int qpos[2] = {wq0 + warp * 16 + g, wq0 + warp * 16 + g + 8};
  float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
  float l[2] = {0.f, 0.f};              // this lane's share of the row sum
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load(j + 1);
    const int stg = j % STAGES;
    if (causal && j * BK > wq0 + 63) {
      // the block's last tile, wholly past this warpgroup's rows: nothing
      // to compute, and no later tile to wait for
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stg);
      continue;
    }
    mbar_wait(full + stg, (j / STAGES) & 1);
    fence_proxy_async();

    // S = Q K^T: this warpgroup's 64 rows x 64 keys, 16 columns of D a step
    float s[32];
    const unsigned char* sK = smem + P::k_off + stg * P::kv_tile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<0, 0>(s, desc_sw128(sQ + swizzled<BQ>(kk / 4, wg * 64, 0) + (kk % 4) * 32, 16),
                     desc_sw128(sK + swizzled<BK>(kk / 4, 0, 0) + (kk % 4) * 32, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale, ALiBi and masks in log2 units; the new row maxima. A tile no
    // mask touches (every key live and, causal, at or before the
    // warpgroup's first row) skips the tests.
    const int k0 = j * BK;
    const bool interior = k0 + BK <= kv_len && (!causal || k0 + BK - 1 <= wq0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kp = k0 + jj * 8 + 2 * t + (e & 1);
        const float x = fmaf(s[4 * jj + e], scale2, slope2 * (float)(kp - qpos[r]));
        const bool ok = interior || (kp < kv_len && (!causal || kp <= qpos[r]));
        s[4 * jj + e] = ok ? x : -INFINITY;
        mx[r] = fmaxf(mx[r], s[4 * jj + e]);
      }
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = m_new == -INFINITY ? 1.f : ex2(m[r] - m_new);
      m[r] = m_new;
      mb[r] = m_new == -INFINITY ? 0.f : m_new;  // exp2(-inf - mb) = 0, never NaN
      l[r] *= alpha[r];
    }
    // P = exp2(s - m) as bf16 A operands of 16 keys each: two neighbouring
    // n8 blocks of S's accumulator
    uint32_t pa[4][4];
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(s[4 * jj + e] - mb[e >> 1]);
        l[e >> 1] += p[e];
      }
      pa[jj >> 1][(jj & 1) * 2] = pack_f2(p[0], p[1]);
      pa[jj >> 1][(jj & 1) * 2 + 1] = pack_f2(p[2], p[3]);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
    }

    // O += P V, 16 keys a step
    const unsigned char* sV = smem + P::v_off + stg * P::kv_tile;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      wgmma_rs<1>(acc, pa[ks], desc_sw128(sV + swizzled<BK>(0, ks * 16, 0), BK * 128), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_regs(pa[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stg);
  }

  // normalise (a row that saw no key, l == 0, writes zeros). bf16: into
  // this warpgroup's own rows of the Q tile, in its swizzle, so that neither
  // these 4-byte writes nor the 16-byte reads below meet a bank twice; then
  // out in whole 16-byte chunks. fp32: straight from the registers.
  auto o_at = [&](int row, int c) {
    return sQ + swizzled<BQ>(c / 8, wg * 64 + row, c % 8);
  };
  float* lse_row = lse != nullptr ? lse + ((long long)b * H + h) * Sq : nullptr;
  T* ob = o + b * st.o_b + h * st.o_h;
  if constexpr (!F32) warpgroup_sync(wg);  // every warp is done reading its Q rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    if (lse_row != nullptr && t == 0 && qpos[r] < Sq) {
      lse_row[qpos[r]] = lsum > 0.f ? (m[r] + log2f(lsum)) * LN2 : 0.7f * FLT_MAX;
    }
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      const float x0 = acc[4 * n + 2 * r] * inv, x1 = acc[4 * n + 2 * r + 1] * inv;
      if constexpr (F32) {
        if (qpos[r] < Sq) {
          *reinterpret_cast<float2*>(ob + (long long)qpos[r] * st.o_s + 8 * n + 2 * t) =
              make_float2(x0, x1);
        }
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o_at(row, n) + 4 * t) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
  if constexpr (!F32) {
    warpgroup_sync(wg);
#pragma unroll
    for (int i = tid & 127; i < 64 * CH; i += 128) {
      const int row = i / CH, c = i % CH;
      if (wq0 + row < Sq) {
        *reinterpret_cast<uint4*>(ob + (long long)(wq0 + row) * st.o_s + c * 8) =
            *reinterpret_cast<const uint4*>(o_at(row, c));
      }
    }
  }
}

template <class T, int D, int NWG>
cudaError_t launch_as(const void* q, const void* k, const void* v, void* o, float* lse,
                      const int* kv_lengths, const float* slopes, int B, int H, int Hkv, int Sq,
                      int Sk, const Strides& st, int causal, float scale, cudaStream_t stream) {
  constexpr int BQ = 64 * NWG;
  const size_t smem = Plan<D, BQ>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (Sq + BQ - 1) / BQ, B);
  flash_fwd_kernel<T, D, NWG><<<grid, 128 * NWG, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, kv_lengths, slopes, H / Hkv, Sq, Sk, st, causal,
      scale * LOG2E);
  return cudaGetLastError();
}

// Blocks of two warpgroups share each K/V tile between 128 query rows; a
// grid of them that would leave SMs idle (the serving prefill: 96 blocks on
// 132 SMs) runs as twice as many blocks of one warpgroup instead.
template <class T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const int* kv_lengths, const float* slopes, int B, int H, int Hkv, int Sq,
                   int Sk, const long long* s, int causal, float scale, cudaStream_t stream) {
  static int sms[64] = {};  // by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
  const long long blocks_of_two = (long long)H * B * ((Sq + 127) / 128);
  if (blocks_of_two < sms[dev]) {
    return launch_as<T, D, 1>(q, k, v, o, lse, kv_lengths, slopes, B, H, Hkv, Sq, Sk, st, causal,
                           scale, stream);
  }
  return launch_as<T, D, 2>(q, k, v, o, lse, kv_lengths, slopes, B, H, Hkv, Sq, Sk, st, causal,
                         scale, stream);
}

}  // namespace

// C entry point, bound with ctypes. q [B,H,Sq,D], k/v [B,Hkv,Sk,D], o
// [B,H,Sq,D], all bf16 (f32 = 0) or all fp32 (f32 = 1: rounded to bf16 as
// they are staged, o written in fp32), with unit stride in D and 16-byte
// aligned rows; `strides` holds the (batch, head, seq) element strides of
// q, k, v, o in that order. `lse` ([B,H,Sq] fp32, contiguous) and `slopes`
// may be null (no log-sum-exp, no ALiBi). Returns the launch's cudaError_t.
extern "C" int llark_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, const int* kv_lengths,
                               const float* slopes, int B, int H, int Hkv,
                               int Sq, int Sk, int D, const long long* strides,
                               int causal, float scale, int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD_LAUNCH(T, DD)                                                                   \
  launch<T, DD>(q, k, v, o, lse, kv_lengths, slopes, B, H, Hkv, Sq, Sk, strides, causal, scale, s)
  if (D == 64) return f32 ? FWD_LAUNCH(float, 64) : FWD_LAUNCH(bf16, 64);
  if (D == 128) return f32 ? FWD_LAUNCH(float, 128) : FWD_LAUNCH(bf16, 128);
#undef FWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}
