// Split-KV flash decode for Hopper (sm_90a): short-query attention over a
// KV cache that is dense or paged, in the query's dtype (bf16 or fp32) or
// int8.
//
// Replaces the TPU kernels llark_tpu/ops/decode_attention.py
// `_decode_kernel_all_heads` (all_heads=True) and `_decode_kernel`
// (all_heads=False), both reached through `flash_decode_attention`, in all
// four of its cache modes. The two TPU layouts differ only in how they
// amortise grid-cell overhead; one Hopper kernel computes the same
// function for both: per-row live lengths, per-row first-query positions
// with the in-window causal mask for Sq > 1, ALiBi and GQA.
//
// What bounds it on the H100: a decode step does ~4 FLOPs per cache byte,
// far below the ~295 FLOP/byte ridge, so the least time is the live K+V
// bytes over 3.35 TB/s (B=8, 32 kv heads, ~320 live positions, D=128:
// ~42 MB, ~12.5 us; half that from an int8 cache). The design reads only
// live bytes, once: the grid is (KV splits of TK positions, kv heads x row
// chunks, batch rows), fixed by shapes; a split that starts past its row's
// live length exits before touching memory, and each block computes all
// group*Sq query rows of its kv head (up to MAX_ROWS), so a cache tile is
// read once per GQA group. One split per 64-key tile gives enough blocks
// to fill 132 SMs at batch 1. A second small kernel merges the per-split
// (m, l, acc) partials with the usual log-sum-exp rescale; it is launched as
// a programmatic dependent of the first, so its launch overlaps the first's
// last blocks.
//
// bf16 queries (decode_split_kernel), one block of 4 warps a split:
//  * staging: cp.async 16-byte copies straight into shared memory, every
//    copy of the split in flight at once, in two commit groups: Q, K (and
//    the int8 scales) first, then V. The scores start when the first group
//    has landed, while V is still in flight. Rows past the live length are
//    zero-filled, never read.
//  * S = Q K^T and O = P V on the tensor cores (mma.sync m16n8k16, bf16 in,
//    fp32 accumulators); the block's rows are padded to 16-row m-tiles (one
//    row in Llama-2-7B decode). Warp w computes the scores of keys 16w ..
//    16w + 15 for every row; the row max goes across warps through shared
//    memory; P (scaled by V's int8 scale, then split into a bf16 high part
//    and the bf16 rounding of the rest, so P V keeps fp32 precision: a bf16
//    P alone moves a row by up to 2^-8 of its norm) goes through shared
//    memory, and warp w computes output columns w*D/4 .. (w+1)*D/4 - 1 over
//    all 64 keys. No serial shuffle chain per key, no loop over rows.
//  * fragments are read with plain shared-memory loads, not ldmatrix: each
//    lane's K fragment is 4 neighbouring values of one key's row (the
//    contraction order is permuted alike in Q, which the sum does not see),
//    and its V fragment 4 (D=128) or 2 (D=64) neighbouring columns of keys
//    2t, 2t+1, 2t+8, 2t+9, paired across rows in registers (the output
//    columns are permuted alike and put back when written). So a lane of an
//    int8 cache reads whole bytes and converts them exactly to bf16 in
//    registers (0x4B000000 | (v ^ 0x80) is the float 2^23 + 128 + v), with
//    no bf16 copy of the tile. Rows are padded so that every such load is
//    free of bank conflicts.
//  * int8: K's per-position scale multiplies each score column in fp32
//    after the product; V's is folded into P before P is rounded, and l is
//    summed from the unscaled probabilities, as the TPU kernel does.
//  * paged: each pool block the split touches is resolved once (its table
//    entry, clipped into the pool) before the copies are issued.
//  * shared memory follows the template and the row count: K and V tiles,
//    then Q rows (bf16) for the padded row count, which P reuses.
// fp32 queries (decode_split_fp32_kernel, no served model runs them) keep
// the CUDA-core dots in fp32 on a block of D threads.
//
// The cache modes change only how a split stages its rows (one template
// per (D, q's dtype, the cache's dtype, PAGED)):
//  * int8 (the TPU kernel's `quant`): K and V are read as int8 with fp32
//    per-position scales staged beside them. Scores are (q.k) * k_scale,
//    then ALiBi, then the mask. Rows past the live length are not loaded:
//    their values and scales are zero, so no garbage scale can turn 0 into
//    NaN.
//  * paged (block tables over a pool [N, Hkv, bs, D]): logical position p
//    of row b lives at pool[tables[b, p / bs], h, p % bs]. A split may span
//    several pool blocks (bs < TK) or part of one (bs > TK), and any block
//    size works. A split past the live length exits before reading, so
//    table entries past a row's live blocks are never read. A block id
//    outside the pool is clipped into it, as the JAX gather clips
//    (mode="clip"): bad tables give wrong values, never a read outside the
//    pool.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"
#include "wgmma.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using tiles::pack_f2;
using tiles::quad_max;
using tiles::quad_sum;

constexpr int TK = 64;        // cache positions per split
constexpr int MAX_ROWS = 32;  // query rows (of one kv head) per block
constexpr int TC_THREADS = 128;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

__device__ __forceinline__ void from_float(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }

// Programmatic dependent launch: once every block of the split kernel has
// passed launch_dependents (or exited), the combine grid may start; its
// wait_for_primary returns when the split grid has finished and its writes
// are visible. The combine's launch then overlaps the split's last blocks.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Byte strides of one cache operand (k, v, or a scale tensor): dense
// [B, Hkv, S(, D)] takes (batch, head, position); a paged pool
// [N, Hkv, bs(, D)] takes (block, head, offset in block).
struct Strides {
  long long outer, head, pos;
};

// Byte offset of logical cache position `p` of batch row `b`, kv head `hk`,
// in an operand with strides `st`. Paged: p's block comes from the row's
// table, clipped to the pool's n_pool blocks; the offset inside a pool block
// is 32-bit (max_paged_block_size).
template <bool PAGED>
__device__ __forceinline__ long long row_offset(const Strides& st, const int* tables,
                                                int max_blocks, int bs, int n_pool, int b,
                                                int hk, int p) {
  if (PAGED) {
    const int blk = min(max(tables[(long long)b * max_blocks + p / bs], 0), n_pool - 1);
    return (long long)blk * st.outer + (hk * (int)st.head + (p % bs) * (int)st.pos);
  }
  return (long long)b * st.outer + hk * st.head + (long long)p * st.pos;
}

// ---------------------------------------------------------------------------
// bf16 queries: both products on the tensor cores
// ---------------------------------------------------------------------------

// d += a * b, m16n8k16, bf16 in, fp32 accumulate. Lane 4g + t: a = rows g,
// g + 8 at contraction slots 2t, 2t + 1 (a[0], a[1]) and 2t + 8, 2t + 9
// (a[2], a[3]); b = column g at slots 2t, 2t + 1 (b[0]) and 2t + 8, 2t + 9
// (b[1]); d = rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at columns 2t,
// 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// byte jlo of `lo` and byte jhi of `hi` (int8 values biased by ^ 0x80) as
// one bf16 pair, the first in the low half: 0x4B0000 | u is the float
// 2^23 + u, minus 2^23 + 128 gives the value exactly, and an integer of at
// most 8 significant bits keeps it in the top half of its float
__device__ __forceinline__ uint32_t byte_pair(uint32_t lo, int jlo, uint32_t hi, int jhi) {
  const float flo = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7650 | jlo)) - 8388736.f;
  const float fhi = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7650 | jhi)) - 8388736.f;
  return __byte_perm(__float_as_uint(flo), __float_as_uint(fhi), 0x7632);
}

// Shared memory of one split: the K and V tiles (TK rows each), then the
// Q rows of the padded row count (bf16), which P's high and low parts
// (bf16, rows of TK + 8) replace once the scores are done. Every row
// pitch keeps the fragment loads below free of bank conflicts.
template <int D, class T>
struct TcPlan {
  static constexpr int K_PITCH = (D + 16) * (int)sizeof(T);
  static constexpr int V_PITCH = D * (int)sizeof(T) + 16;
  static constexpr int Q_PITCH = 2 * D + 32;
  static constexpr int P_PITCH = 2 * (TK + 8);
  static constexpr int ROW_BYTES = Q_PITCH > 2 * P_PITCH ? Q_PITCH : 2 * P_PITCH;
  static constexpr size_t v_off = size_t(TK) * K_PITCH;
  static constexpr size_t q_off = v_off + size_t(TK) * V_PITCH;
  static constexpr size_t bytes(int rows_pad) { return q_off + size_t(rows_pad) * ROW_BYTES; }
};

// K fragment of one n8 tile and k16 step: 4 neighbouring values of the key
// row at p (contraction slots 2t, 2t + 1 | 2t + 8, 2t + 9 hold values
// 4t, 4t + 1 | 4t + 2, 4t + 3)
template <class T>
__device__ __forceinline__ void k_frag(const unsigned char* p, uint32_t (&b)[2]) {
  if constexpr (sizeof(T) == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    b[0] = w.x;
    b[1] = w.y;
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
    b[0] = byte_pair(w, 0, w, 1);
    b[1] = byte_pair(w, 2, w, 3);
  }
}

// V fragments of NT n8 tiles and one k16 step: p points at key 2t's row,
// column n0 + NT g; tile i takes column n0 + NT g + i of keys 2t, 2t + 1
// (b[i][0]) and 2t + 8, 2t + 9 (b[i][1])
template <class T, int NT, int PITCH>
__device__ __forceinline__ void v_frags(const unsigned char* p, uint32_t (&b)[NT][2]) {
  constexpr int BYTES = NT * (int)sizeof(T);
  const int rows[4] = {0, PITCH, 8 * PITCH, 9 * PITCH};
  uint32_t w[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if constexpr (BYTES == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p + rows[r]);
      w[r][0] = u.x;
      w[r][1] = u.y;
    } else if constexpr (BYTES == 4) {
      w[r][0] = *reinterpret_cast<const uint32_t*>(p + rows[r]);
    } else {
      w[r][0] = *reinterpret_cast<const uint16_t*>(p + rows[r]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // keys 2t, 2t + 1, then 2t + 8, 2t + 9
    const int r0 = 2 * h, r1 = 2 * h + 1;
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
        b[i][h] = __byte_perm(w[r0][i / 2], w[r1][i / 2], i % 2 ? 0x7632 : 0x5410);
    } else {
#pragma unroll
      for (int i = 0; i < NT; ++i)
        b[i][h] = byte_pair(w[r0][0] ^ 0x80808080u, i, w[r1][0] ^ 0x80808080u, i);
    }
  }
}

// Block: 4 warps. T: the cache's dtype (bf16, or int8 with scales).
template <int D, class T, bool PAGED>
__global__ void __launch_bounds__(TC_THREADS)
decode_split_kernel(const bf16* __restrict__ q, const char* __restrict__ k,
                    const char* __restrict__ v, const char* __restrict__ k_scale,
                    const char* __restrict__ v_scale, const int* __restrict__ tables,
                    const int* __restrict__ kv_lengths, const int* __restrict__ q_positions,
                    const float* __restrict__ slopes, float* __restrict__ part_acc,
                    float* __restrict__ part_m, float* __restrict__ part_l, int H, int Hkv,
                    int Sq, int S, int n_splits, int row_chunks, int bs, int max_blocks,
                    int n_pool, long long q_sb, long long q_sh, long long q_ss, Strides k_st,
                    Strides v_st, Strides ks_st, Strides vs_st, float scale) {
  using Plan = TcPlan<D, T>;
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
  constexpr int NT = D / 32;  // n8 tiles of output columns a warp
  const int split = blockIdx.x;
  const int hk = blockIdx.y / row_chunks;
  const int row0 = (blockIdx.y % row_chunks) * MAX_ROWS;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int rows = min(MAX_ROWS, group * Sq - row0);
  const int kv_len = min(max(kv_lengths[b], 0), S);
  const int k0 = split * TK;
  if (k0 >= kv_len) return;  // past the live length: read nothing
  launch_dependents();
  const int n = min(TK, kv_len - k0);
  const int n_mt = (rows + 15) / 16;  // 16-row m-tiles

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sK = smem;
  unsigned char* sV = smem + Plan::v_off;
  unsigned char* sQ = smem + Plan::q_off;
  unsigned char* sP = sQ;  // P's high part, then its low part
  __shared__ float sKs[TK], sVs[TK];  // int8: the split's per-position scales
  __shared__ int sQpos[MAX_ROWS];
  __shared__ float sSlope[MAX_ROWS];
  __shared__ float sMax[4][MAX_ROWS], sSum[4][MAX_ROWS];  // per warp and row
  __shared__ int sBlk[TK];  // paged: the pool blocks the split touches

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;

  // group 1: the block's query rows (zeros up to the m-tiles' 16-row
  // boundary), K, the scales. Block row r is query (head hk*group + gq,
  // position j) with row0 + r = gq * Sq + j.
  constexpr int QCH = D / 8;  // 16-byte chunks of a bf16 row
  for (int i = tid; i < n_mt * 16 * QCH; i += TC_THREADS) {
    const int r = i / QCH, c = i % QCH;
    const bool ok = r < rows;
    const int gq = (row0 + r) / Sq, j = (row0 + r) % Sq;
    const bf16* src = ok ? q + b * q_sb + (hk * group + gq) * q_sh + j * q_ss + c * 8 : q;
    cp_async16(sQ + r * Plan::Q_PITCH + c * 16, src, ok);
  }
  if (tid < rows) {
    const int gq = (row0 + tid) / Sq;
    const int j = (row0 + tid) % Sq;
    sQpos[tid] = q_positions[b] + j;
    sSlope[tid] = slopes != nullptr ? fabsf(slopes[hk * group + gq]) : 0.f;
  }
  const int blk0 = PAGED ? k0 / bs : 0;
  if constexpr (PAGED) {
    // each pool block of the split, resolved once; positions below the
    // live length only, so no table entry past them is read
    if (tid <= (k0 + n - 1) / bs - blk0)
      sBlk[tid] = min(max(tables[(long long)b * max_blocks + blk0 + tid], 0), n_pool - 1);
    __syncthreads();
  }
  auto offset = [&](const Strides& st, int p) -> long long {
    if (PAGED)
      return (long long)sBlk[p / bs - blk0] * st.outer +
             (hk * (int)st.head + (p % bs) * (int)st.pos);
    return (long long)b * st.outer + hk * st.head + (long long)p * st.pos;
  };
  constexpr int CH = D * (int)sizeof(T) / 16;  // 16-byte chunks of a cache row
#pragma unroll
  for (int it = 0; it < TK * CH / TC_THREADS; ++it) {
    const int i = tid + it * TC_THREADS;
    const int r = i / CH, c = i % CH;
    const bool ok = r < n;
    cp_async16(sK + r * Plan::K_PITCH + c * 16, ok ? k + offset(k_st, k0 + r) + c * 16 : k, ok);
  }
  if constexpr (INT8) {
    const int r = tid % TK;
    const bool ok = r < n;
    if (tid < TK)
      cp_async4(sKs + r, ok ? k_scale + offset(ks_st, k0 + r) : k_scale, ok);
    else
      cp_async4(sVs + r, ok ? v_scale + offset(vs_st, k0 + r) : v_scale, ok);
  }
  cp_async_commit();
  // group 2: V
#pragma unroll
  for (int it = 0; it < TK * CH / TC_THREADS; ++it) {
    const int i = tid + it * TC_THREADS;
    const int r = i / CH, c = i % CH;
    const bool ok = r < n;
    cp_async16(sV + r * Plan::V_PITCH + c * 16, ok ? v + offset(v_st, k0 + r) + c * 16 : v, ok);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // S = Q K^T: warp w takes keys 16w .. 16w + 15 (two n8 tiles) of every row
  float s[2][2][4] = {};
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t bk[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      k_frag<T>(sK + (16 * warp + 8 * j + g) * Plan::K_PITCH + (16 * ks + 4 * t) * sizeof(T),
                bk[j]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt < n_mt) {
        const unsigned char* qr = sQ + (16 * mt + g) * Plan::Q_PITCH + (16 * ks + 4 * t) * 2;
        const uint2 lo = *reinterpret_cast<const uint2*>(qr);
        const uint2 hi = *reinterpret_cast<const uint2*>(qr + 8 * Plan::Q_PITCH);
        const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
        mma_bf16(s[mt][0], a, bk[0]);
        mma_bf16(s[mt][1], a, bk[1]);
      }
    }
  }

  // scale, int8 K scale, ALiBi, masks; the row max over the warp's keys
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * mt + 8 * h + g;
      const bool live_row = mt < n_mt && row < rows;
      const int qp = live_row ? sQpos[row] : 0;
      const float slope = live_row ? sSlope[row] : 0.f;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 16 * warp + 8 * j + 2 * t + e;
          const int kpos = k0 + key;
          float x = s[mt][j][2 * h + e] * scale;
          if (INT8) x *= sKs[key];
          // Sq > 1 adds the in-window causal mask
          const bool ok = live_row && key < n && (Sq == 1 || kpos <= qp);
          x = ok ? x + slope * (float)(kpos - qp) : -INFINITY;
          s[mt][j][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = quad_max(mx);
      if (t == 0 && mt < n_mt) sMax[warp][row] = mx;
    }
  }
  __syncthreads();  // every warp's maxima; every read of Q is done

  // P = exp(S - m) over the split; l from the unscaled probabilities; int8
  // folds V's scale into P; P is stored as bf16 high + low parts
  const int rows_pad = 16 * n_mt;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (mt >= n_mt) continue;
      const int row = 16 * mt + 8 * h + g;
      const float m = fmaxf(fmaxf(sMax[0][row], sMax[1][row]), fmaxf(sMax[2][row], sMax[3][row]));
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[mt][j][2 * h + e];
          p[e] = x == -INFINITY ? 0.f : __expf(x - m);
          l += p[e];
          if (INT8) p[e] *= sVs[16 * warp + 8 * j + 2 * t + e];
        }
        const uint32_t hi = pack_f2(p[0], p[1]);
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&hi);
        const uint32_t lo = pack_f2(p[0] - __low2float(hv), p[1] - __high2float(hv));
        const int off = row * Plan::P_PITCH + (16 * warp + 8 * j + 2 * t) * 2;
        *reinterpret_cast<uint32_t*>(sP + off) = hi;
        *reinterpret_cast<uint32_t*>(sP + rows_pad * Plan::P_PITCH + off) = lo;
      }
      l = quad_sum(l);
      if (t == 0) sSum[warp][row] = l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // V has landed; P and the sums are written

  // O = P V: warp w takes output columns n0 .. n0 + D/4 - 1 over all keys
  const int n0 = warp * (D / 4);
  float o[2][NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < TK / 16; ++ks) {
    uint32_t bv[NT][2];
    v_frags<T, NT, Plan::V_PITCH>(
        sV + (16 * ks + 2 * t) * Plan::V_PITCH + (n0 + NT * g) * sizeof(T), bv);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= n_mt) continue;
#pragma unroll
      for (int part = 0; part < 2; ++part) {  // P's high, then low part
        const unsigned char* pr = sP + part * rows_pad * Plan::P_PITCH +
                                  (16 * mt + g) * Plan::P_PITCH + (16 * ks + 2 * t) * 2;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(pr),
                               *reinterpret_cast<const uint32_t*>(pr + 8 * Plan::P_PITCH),
                               *reinterpret_cast<const uint32_t*>(pr + 16),
                               *reinterpret_cast<const uint32_t*>(pr + 8 * Plan::P_PITCH + 16)};
#pragma unroll
        for (int i = 0; i < NT; ++i) mma_bf16(o[mt][i], a, bv[i]);
      }
    }
  }

  // the partials: accumulator (row, tile i, column 2t + e) is output column
  // n0 + NT (2t + e) + i, so a lane writes 2 NT neighbouring columns
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * mt + 8 * h + g;
      if (mt >= n_mt || row >= rows) continue;
      const int gq = (row0 + row) / Sq;
      const int j = (row0 + row) % Sq;
      const long long idx = ((long long)(b * H + hk * group + gq) * Sq + j) * n_splits + split;
      float* dst = part_acc + idx * D + n0 + 2 * NT * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (NT == 4) {
          *reinterpret_cast<float4*>(dst + 4 * e) =
              make_float4(o[mt][0][2 * h + e], o[mt][1][2 * h + e], o[mt][2][2 * h + e],
                          o[mt][3][2 * h + e]);
        } else {
          *reinterpret_cast<float2*>(dst + 2 * e) =
              make_float2(o[mt][0][2 * h + e], o[mt][1][2 * h + e]);
        }
      }
    }
  }
  if (tid < rows) {
    const int gq = (row0 + tid) / Sq;
    const int j = (row0 + tid) % Sq;
    const long long idx = ((long long)(b * H + hk * group + gq) * Sq + j) * n_splits + split;
    part_m[idx] = fmaxf(fmaxf(sMax[0][tid], sMax[1][tid]), fmaxf(sMax[2][tid], sMax[3][tid]));
    part_l[idx] = sSum[0][tid] + sSum[1][tid] + sSum[2][tid] + sSum[3][tid];
  }
}

// ---------------------------------------------------------------------------
// fp32 queries: the dots in fp32 on the CUDA cores
// ---------------------------------------------------------------------------

template <int D, class T>
struct Smem {
  static constexpr size_t kv_bytes = 2 * size_t(TK) * D * sizeof(T);
  static constexpr size_t p_off = kv_bytes + size_t(MAX_ROWS) * D * 4;
  static constexpr size_t bytes = p_off + size_t(MAX_ROWS) * TK * 4;
};

// Block: D threads (D/32 warps). Thread d owns output dimension d. T: the
// cache's dtype (fp32, or int8 with scales).
template <int D, class T, bool PAGED>
__global__ void __launch_bounds__(D)
decode_split_fp32_kernel(const float* __restrict__ q, const char* __restrict__ k,
                         const char* __restrict__ v, const char* __restrict__ k_scale,
                         const char* __restrict__ v_scale, const int* __restrict__ tables,
                         const int* __restrict__ kv_lengths, const int* __restrict__ q_positions,
                         const float* __restrict__ slopes, float* __restrict__ part_acc,
                         float* __restrict__ part_m, float* __restrict__ part_l, int H,
                         int Hkv, int Sq, int S, int n_splits, int row_chunks, int bs,
                         int max_blocks, int n_pool, long long q_sb, long long q_sh,
                         long long q_ss, Strides k_st, Strides v_st, Strides ks_st,
                         Strides vs_st, float scale) {
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
  constexpr int NW = D / 32;
  constexpr int E = D / 32;  // key elements per lane in the score dot
  const int split = blockIdx.x;
  const int hk = blockIdx.y / row_chunks;
  const int row0 = (blockIdx.y % row_chunks) * MAX_ROWS;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int rows = min(MAX_ROWS, group * Sq - row0);
  const int kv_len = min(max(kv_lengths[b], 0), S);
  const int k0 = split * TK;
  if (k0 >= kv_len) return;  // past the live length: read nothing
  launch_dependents();
  const int n = min(TK, kv_len - k0);

  // dynamic shared memory: K and V rows of the split (fp32 or int8), the
  // block's query rows (fp32, pre-scaled) and their scores / probabilities
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + TK * D;
  float (*sQ)[D] = reinterpret_cast<float (*)[D]>(smem + 2 * size_t(TK) * D * sizeof(T));
  float (*sP)[TK] = reinterpret_cast<float (*)[TK]>(smem + Smem<D, T>::p_off);
  __shared__ int sQpos[MAX_ROWS];
  __shared__ float sSlope[MAX_ROWS];
  __shared__ float sM[MAX_ROWS];
  __shared__ float sL[MAX_ROWS];
  __shared__ float sKs[TK];  // int8: the split's per-position scales
  __shared__ float sVs[TK];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // stage the split's live K and V rows (zero past the live length) and
  // the block's query rows. Every global load is issued into registers
  // before the first shared-memory store: the compiler cannot move a load
  // above a store through a pointer it might alias, so a load-store loop
  // would pay one memory round trip per iteration.
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = D / PER;          // chunks per row
  constexpr int NC = TK * CH / D;      // chunks per thread
  uint4 kr[NC], vr[NC];
#pragma unroll
  for (int it = 0; it < NC; ++it) {
    const int i = tid + it * D;
    const int r = i / CH;
    kr[it] = vr[it] = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) {
      const int col = (i % CH) * 16;
      const int p = k0 + r;
      kr[it] = *reinterpret_cast<const uint4*>(
          k + row_offset<PAGED>(k_st, tables, max_blocks, bs, n_pool, b, hk, p) + col);
      vr[it] = *reinterpret_cast<const uint4*>(
          v + row_offset<PAGED>(v_st, tables, max_blocks, bs, n_pool, b, hk, p) + col);
    }
  }
  float ksr = 0.f, vsr = 0.f;
  if (INT8 && tid < n) {
    const int p = k0 + tid;
    ksr = *reinterpret_cast<const float*>(
        k_scale + row_offset<PAGED>(ks_st, tables, max_blocks, bs, n_pool, b, hk, p));
    vsr = *reinterpret_cast<const float*>(
        v_scale + row_offset<PAGED>(vs_st, tables, max_blocks, bs, n_pool, b, hk, p));
  }
  // block row r is query (head hk*group + g, position j) with
  // row0 + r = g * Sq + j; thread d loads element d of every row
  float qv[MAX_ROWS];
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    if (r < rows) {
      const int g = (row0 + r) / Sq;
      const int j = (row0 + r) % Sq;
      qv[r] = q[b * q_sb + (hk * group + g) * q_sh + j * q_ss + tid];
    }
  }
#pragma unroll
  for (int it = 0; it < NC; ++it) {
    const int i = tid + it * D;
    *reinterpret_cast<uint4*>(sK + (i / CH) * D + (i % CH) * PER) = kr[it];
    *reinterpret_cast<uint4*>(sV + (i / CH) * D + (i % CH) * PER) = vr[it];
  }
  if (INT8 && tid < TK) {
    sKs[tid] = ksr;
    sVs[tid] = vsr;
  }
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    if (r < rows) sQ[r][tid] = qv[r] * scale;
  }
  if (tid < rows) {
    const int g = (row0 + tid) / Sq;
    const int j = (row0 + tid) % Sq;
    sQpos[tid] = q_positions[b] + j;
    sSlope[tid] = slopes != nullptr ? fabsf(slopes[hk * group + g]) : 0.f;
  }
  __syncthreads();

  // scores: warp w takes keys w, w + NW, ...; each lane holds E elements
  for (int kk = warp; kk < TK; kk += NW) {
    const int kpos = k0 + kk;
    if (kk < n) {
      float kv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kv[e] = to_float(sK[kk * D + lane * E + e]);
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += sQ[r][lane * E + e] * kv[e];
        part = warp_sum(part);
        if (lane == 0) {
          if (INT8) part *= sKs[kk];
          const int qp = sQpos[r];
          // kpos < kv_len holds by construction; Sq > 1 adds the in-window
          // causal mask
          const bool ok = Sq == 1 || kpos <= qp;
          sP[r][kk] = ok ? part + sSlope[r] * (float)(kpos - qp) : -INFINITY;
        }
      }
    } else if (lane == 0) {
      for (int r = 0; r < rows; ++r) sP[r][kk] = -INFINITY;
    }
  }
  __syncthreads();

  // softmax over the split, one warp per row; int8 folds V's scale into
  // the probabilities after l is summed from the unscaled ones
  for (int r = warp; r < rows; r += NW) {
    const float s0 = sP[r][lane];
    const float s1 = sP[r][lane + 32];
    const float m = warp_max(fmaxf(s0, s1));
    const float p0 = s0 == -INFINITY ? 0.f : __expf(s0 - m);
    const float p1 = s1 == -INFINITY ? 0.f : __expf(s1 - m);
    sP[r][lane] = INT8 ? p0 * sVs[lane] : p0;
    sP[r][lane + 32] = INT8 ? p1 * sVs[lane + 32] : p1;
    const float l = warp_sum(p0 + p1);
    if (lane == 0) {
      sM[r] = m;
      sL[r] = l;
    }
  }
  __syncthreads();

  // partial output of each row: acc = sum_k p[r][k] * V[k][d]
  for (int r = 0; r < rows; ++r) {
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < TK; kk += 2) {
      acc0 += sP[r][kk] * to_float(sV[kk * D + tid]);
      acc1 += sP[r][kk + 1] * to_float(sV[(kk + 1) * D + tid]);
    }
    const int g = (row0 + r) / Sq;
    const int j = (row0 + r) % Sq;
    const long long idx = ((long long)(b * H + hk * group + g) * Sq + j) * n_splits + split;
    part_acc[idx * D + tid] = acc0 + acc1;
    if (tid == 0) {
      part_m[idx] = sM[r];
      part_l[idx] = sL[r];
    }
  }
}

// Merge the live splits of one (batch row, head, query position).
template <int D, class QT>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const int* __restrict__ kv_lengths, QT* __restrict__ out,
                      int H, int Sq, int S, int n_splits) {
  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int kv_len = min(max(kv_lengths[b], 0), S);
  const int n_live = (kv_len + TK - 1) / TK;
  const long long idx0 = ((long long)(b * H + h) * Sq + j) * n_splits;
  wait_for_primary();
  float m_star = -INFINITY;
  for (int s = 0; s < n_live; ++s) m_star = fmaxf(m_star, part_m[idx0 + s]);
  float l = 0.f;
  float a = 0.f;
  if (m_star != -INFINITY) {
    for (int s = 0; s < n_live; ++s) {
      const float ms = part_m[idx0 + s];
      if (ms == -INFINITY) continue;  // every key of that split was masked
      const float w = __expf(ms - m_star);
      l += w * part_l[idx0 + s];
      a += w * part_acc[(idx0 + s) * D + tid];
    }
  }
  // a row that saw no key writes zeros
  from_float(out + (((long long)b * H + h) * Sq + j) * D + tid, l > 0.f ? a / l : 0.f);
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale;
  const int *tables, *kv_lengths, *q_positions;
  const float* slopes;
  float *part_acc, *part_m, *part_l;
  void* out;
  int B, H, Hkv, Sq, S, bs, max_blocks, n_pool;
  const long long* st;
  float scale;
};

constexpr int MAX_DEVICES = 64;

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per device
// (a repeat by a racing thread is harmless).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int D, class QT, class T, bool PAGED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n_splits = (a.S + TK - 1) / TK;
  const int rows = (a.H / a.Hkv) * a.Sq;
  const int row_chunks = (rows + MAX_ROWS - 1) / MAX_ROWS;
  dim3 grid(n_splits, a.Hkv * row_chunks, a.B);
  const long long* st = a.st;
  const Strides k_st{st[3], st[4], st[5]}, v_st{st[6], st[7], st[8]};
  const Strides ks_st{st[9], st[10], st[11]}, vs_st{st[12], st[13], st[14]};
  static bool smem_set[MAX_DEVICES];
  cudaError_t err;
  if constexpr (std::is_same<QT, bf16>::value) {
    // the block's rows, padded to whole m-tiles
    const int rows_pad = (min(rows, MAX_ROWS) + 15) / 16 * 16;
    auto kernel = decode_split_kernel<D, T, PAGED>;
    err = allow_smem(kernel, TcPlan<D, T>::bytes(MAX_ROWS), smem_set);
    if (err != cudaSuccess) return err;
    kernel<<<grid, TC_THREADS, TcPlan<D, T>::bytes(rows_pad), stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const char*>(a.k),
        static_cast<const char*>(a.v), static_cast<const char*>(a.k_scale),
        static_cast<const char*>(a.v_scale), a.tables, a.kv_lengths, a.q_positions, a.slopes,
        a.part_acc, a.part_m, a.part_l, a.H, a.Hkv, a.Sq, a.S, n_splits, row_chunks, a.bs,
        a.max_blocks, a.n_pool, st[0], st[1], st[2], k_st, v_st, ks_st, vs_st, a.scale);
  } else {
    auto kernel = decode_split_fp32_kernel<D, T, PAGED>;
    err = allow_smem(kernel, Smem<D, T>::bytes, smem_set);
    if (err != cudaSuccess) return err;
    kernel<<<grid, D, Smem<D, T>::bytes, stream>>>(
        static_cast<const float*>(a.q), static_cast<const char*>(a.k),
        static_cast<const char*>(a.v), static_cast<const char*>(a.k_scale),
        static_cast<const char*>(a.v_scale), a.tables, a.kv_lengths, a.q_positions, a.slopes,
        a.part_acc, a.part_m, a.part_l, a.H, a.Hkv, a.Sq, a.S, n_splits, row_chunks, a.bs,
        a.max_blocks, a.n_pool, st[0], st[1], st[2], k_st, v_st, ks_st, vs_st, a.scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Sq, a.H, a.B);
  cfg.blockDim = dim3(D);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<D, QT>, a.part_acc, a.part_m,
                            a.part_l, a.kv_lengths, static_cast<QT*>(a.out), a.H, a.Sq,
                            a.S, n_splits);
}

template <int D, class QT>
cudaError_t launch_cache(const Args& a, bool int8, bool paged, cudaStream_t s) {
  if (int8)
    return paged ? launch<D, QT, int8_t, true>(a, s) : launch<D, QT, int8_t, false>(a, s);
  return paged ? launch<D, QT, QT, true>(a, s) : launch<D, QT, QT, false>(a, s);
}

template <int D>
cudaError_t launch_mode(const Args& a, bool f32, bool int8, bool paged, cudaStream_t s) {
  return f32 ? launch_cache<D, float>(a, int8, paged, s) : launch_cache<D, bf16>(a, int8, paged, s);
}

}  // namespace

// Number of KV splits for a cache of S logical positions (sizes the partials).
extern "C" int llark_flash_decode_splits(int S) { return (S + TK - 1) / TK; }

// C entry point, bound with ctypes. q [B,H,Sq,D] bf16 (f32 = 0) or fp32
// (f32 = 1), element strides in `strides[0..2]`; a bf16 q's rows unit
// stride and 16-byte aligned. k/v: a dense cache
// [B,Hkv,S,D] or, with `tables` non-null, a pool [n_pool,Hkv,bs,D] read
// through int32 tables [B,max_blocks] (S = max_blocks * bs; block ids are
// clipped to [0, n_pool)); in q's dtype, or int8 with fp32 scales k_scale/v_scale
// [B,Hkv,S] (paged: [n_pool,Hkv,bs]); unit stride in D, rows 16-byte
// aligned. kv_lengths count live positions per row and are clamped to
// [0, S]; positions past a row's length are never read.
// `strides[3..14]` hold the (outer, head, position) BYTE strides of k, v,
// k_scale and v_scale in that order. Partials: part_acc
// [B,H,Sq,splits,D], part_m/part_l [B,H,Sq,splits] fp32. out is a
// contiguous [B,H,Sq,D] tensor in q's dtype. `slopes` may be null. Returns
// the launches' cudaError_t.
extern "C" int llark_flash_decode(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale,
                                  const int* tables, const int* kv_lengths,
                                  const int* q_positions, const float* slopes,
                                  float* part_acc, float* part_m, float* part_l, void* out,
                                  int B, int H, int Hkv, int Sq, int S, int D, int bs,
                                  int max_blocks, int n_pool, const long long* strides,
                                  float scale, int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, k_scale, v_scale, tables, kv_lengths, q_positions, slopes,
               part_acc, part_m, part_l, out, B, H, Hkv, Sq, S, bs, max_blocks,
               n_pool, strides, scale};
  const bool int8 = k_scale != nullptr;
  const bool paged = tables != nullptr;
  if (D == 64) return launch_mode<64>(a, f32, int8, paged, s);
  if (D == 128) return launch_mode<128>(a, f32, int8, paged, s);
  return (int)cudaErrorInvalidValue;
}
