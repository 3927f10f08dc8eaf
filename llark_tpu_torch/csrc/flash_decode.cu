// Split-KV flash decode for Hopper (sm_90a): short-query attention over a
// KV cache that is dense or paged, in the query's dtype (bf16 or fp32, read
// as it is: the dots are fp32 on the CUDA cores) or int8.
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
// bytes over 3.35 TB/s (B=4, 32 kv heads, ~400 live positions, D=128:
// ~26 MB, ~8 us; half that from an int8 cache). The design reads only live
// bytes, once: the grid is (KV splits of TK positions, kv heads x row
// chunks, batch rows); a split that starts past its row's live length
// exits before touching memory, and each block computes all group*Sq query
// rows of its kv head, so a cache tile is read once per GQA group. A block
// stages its split's K and V rows in shared memory with 16-byte loads that
// are all in flight together, so its latency is one memory round trip
// rather than one per key. One split per 64-key tile gives enough blocks
// to fill 132 SMs at batch 1. A second small kernel merges the per-split
// (m, l, acc) partials with the usual log-sum-exp rescale.
// The dot products run on the CUDA cores in fp32: at Sq*group <= 32 rows
// the tensor cores would idle on memory anyway.
//
// The cache modes change only how a split stages its rows (one template
// per (D, q's dtype, the cache's dtype, PAGED)):
//  * int8 (the TPU kernel's `quant`): K and V are read as int8, 16 values
//    per 16-byte load, with fp32 per-position scales staged beside them.
//    Scores are (q.k) * k_scale, then ALiBi, then the mask; m and l come
//    from the unscaled probabilities and the accumulator sums
//    p * v_scale * v, V's scale folded in before masking as the TPU kernel
//    does. Rows past the live length are not loaded: their values and
//    scales are zero, so no garbage scale can turn 0 into NaN.
//  * paged (block tables over a pool [N, Hkv, bs, D]): logical position p
//    of row b lives at pool[tables[b, p / bs], h, p % bs]. Each staged row
//    resolves its own address, so a split may span several pool blocks
//    (bs < TK) or part of one (bs > TK), and any block size works. A split
//    past the live length exits before reading, so table entries past a
//    row's live blocks are never read. A block id outside the pool is
//    clipped into it, as the JAX gather clips (mode="clip"): bad tables give
//    wrong values, never a read outside the pool.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TK = 64;        // cache positions per split
constexpr int MAX_ROWS = 32;  // query rows (of one kv head) per block

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

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

__device__ __forceinline__ void from_float(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }

// Byte strides of one cache operand (k, v, or a scale tensor): dense
// [B, Hkv, S(, D)] takes (batch, head, position); a paged pool
// [N, Hkv, bs(, D)] takes (block, head, offset in block).
struct Strides {
  long long outer, head, pos;
};

template <int D, class T>
struct Smem {
  static constexpr size_t kv_bytes = 2 * size_t(TK) * D * sizeof(T);
  static constexpr size_t p_off = kv_bytes + size_t(MAX_ROWS) * D * 4;
  static constexpr size_t bytes = p_off + size_t(MAX_ROWS) * TK * 4;
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

// Block: D threads (D/32 warps). Thread d owns output dimension d. QT: q's
// dtype (bf16 or fp32); T: the cache's (q's, or int8 with scales).
template <int D, class QT, class T, bool PAGED>
__global__ void __launch_bounds__(D)
decode_split_kernel(const QT* __restrict__ q, const char* __restrict__ k,
                    const char* __restrict__ v, const char* __restrict__ k_scale,
                    const char* __restrict__ v_scale, const int* __restrict__ tables,
                    const int* __restrict__ kv_lengths, const int* __restrict__ q_positions,
                    const float* __restrict__ slopes, float* __restrict__ part_acc,
                    float* __restrict__ part_m, float* __restrict__ part_l, int H,
                    int Hkv, int Sq, int S, int n_splits, int row_chunks, int bs,
                    int max_blocks, int n_pool, long long q_sb, long long q_sh,
                    long long q_ss, Strides k_st, Strides v_st, Strides ks_st, Strides vs_st, float scale) {
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
  const int n = min(TK, kv_len - k0);

  // dynamic shared memory: K and V rows of the split (bf16 or int8), the
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
      qv[r] = to_float(q[b * q_sb + (hk * group + g) * q_sh + j * q_ss + tid]);
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

template <int D, class QT, class T, bool PAGED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n_splits = (a.S + TK - 1) / TK;
  const int rows = (a.H / a.Hkv) * a.Sq;
  const int row_chunks = (rows + MAX_ROWS - 1) / MAX_ROWS;
  dim3 grid(n_splits, a.Hkv * row_chunks, a.B);
  const size_t smem = Smem<D, T>::bytes;
  auto kernel = decode_split_kernel<D, QT, T, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long* st = a.st;
  kernel<<<grid, D, smem, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const char*>(a.k),
      static_cast<const char*>(a.v), static_cast<const char*>(a.k_scale),
      static_cast<const char*>(a.v_scale), a.tables, a.kv_lengths, a.q_positions,
      a.slopes, a.part_acc, a.part_m, a.part_l, a.H, a.Hkv, a.Sq, a.S, n_splits,
      row_chunks, a.bs, a.max_blocks, a.n_pool, st[0], st[1], st[2],
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, Strides{st[12], st[13], st[14]}, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<D, QT><<<dim3(a.Sq, a.H, a.B), D, 0, stream>>>(
      a.part_acc, a.part_m, a.part_l, a.kv_lengths, static_cast<QT*>(a.out), a.H,
      a.Sq, a.S, n_splits);
  return cudaGetLastError();
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
// (f32 = 1), element strides in `strides[0..2]`. k/v: a dense cache
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
