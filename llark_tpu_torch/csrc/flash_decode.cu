// Split-KV flash decode for Hopper (sm_90a): short-query attention over a
// dense bf16 KV cache.
//
// Replaces the TPU kernels llark_tpu/ops/decode_attention.py
// `_decode_kernel_all_heads` (all_heads=True) and `_decode_kernel`
// (all_heads=False), both reached through `flash_decode_attention`. The two
// TPU layouts differ only in how they amortise grid-cell overhead; one
// Hopper kernel computes the same function for both: per-row live lengths,
// per-row first-query positions with the in-window causal mask for Sq > 1,
// ALiBi and GQA.
//
// What bounds it on the H100: a decode step does ~4 FLOPs per cache byte,
// far below the ~295 FLOP/byte ridge, so the least time is the live K+V
// bytes over 3.35 TB/s (B=4, 32 kv heads, ~400 live positions, D=128:
// ~26 MB, ~8 us). The design reads only live bytes, once: the grid is
// (KV splits of TK positions, kv heads x row chunks, batch rows); a split
// that starts past its row's live length exits before touching memory, and
// each block computes all group*Sq query rows of its kv head, so a cache
// tile is read once per GQA group. A block stages its split's K and V rows
// in shared memory with 16-byte loads that are all in flight together, so
// its latency is one memory round trip rather than one per key. One split
// per 64-key tile gives enough blocks to fill 132 SMs at batch 1. A second
// small kernel merges the per-split (m, l, acc) partials with the usual
// log-sum-exp rescale.
// The dot products run on the CUDA cores in fp32: at Sq*group <= 32 rows
// the tensor cores would idle on memory anyway.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int D>
struct Smem {
  static constexpr size_t p_off = 2 * size_t(TK) * D * 2 + size_t(MAX_ROWS) * D * 4;
  static constexpr size_t bytes = p_off + size_t(MAX_ROWS) * TK * 4;
};

// Block: D threads (D/32 warps). Thread d owns output dimension d.
template <int D>
__global__ void __launch_bounds__(D)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ kv_lengths,
                    const int* __restrict__ q_positions,
                    const float* __restrict__ slopes, float* __restrict__ part_acc,
                    float* __restrict__ part_m, float* __restrict__ part_l, int H,
                    int Hkv, int Sq, int S, int n_splits, int row_chunks,
                    long long q_sb, long long q_sh, long long q_ss,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss, float scale) {
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

  // dynamic shared memory: K and V rows of the split (bf16), the block's
  // query rows (fp32, pre-scaled) and their scores / probabilities
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TK * D;
  float (*sQ)[D] = reinterpret_cast<float (*)[D]>(sV + TK * D);
  float (*sP)[TK] = reinterpret_cast<float (*)[TK]>(smem + Smem<D>::p_off);
  __shared__ int sQpos[MAX_ROWS];
  __shared__ float sSlope[MAX_ROWS];
  __shared__ float sM[MAX_ROWS];
  __shared__ float sL[MAX_ROWS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;

  // stage the split's live K and V rows (zero past the live length) and
  // the block's query rows. Every global load is issued into registers
  // before the first shared-memory store: the compiler cannot move a load
  // above a store through a pointer it might alias, so a load-store loop
  // would pay one memory round trip per iteration.
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int NC = TK * CH / D;
  uint4 kr[NC], vr[NC];
#pragma unroll
  for (int it = 0; it < NC; ++it) {
    const int i = tid + it * D;
    const int r = i / CH;
    kr[it] = vr[it] = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) {
      kr[it] = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * k_ss + (i % CH) * 8);
      vr[it] = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * v_ss + (i % CH) * 8);
    }
  }
  // block row r is query (head hk*group + g, position j) with
  // row0 + r = g * Sq + j; thread d loads element d of every row
  float qv[MAX_ROWS];
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    if (r < rows) {
      const int g = (row0 + r) / Sq;
      const int j = (row0 + r) % Sq;
      qv[r] = __bfloat162float(q[b * q_sb + (hk * group + g) * q_sh + j * q_ss + tid]);
    }
  }
#pragma unroll
  for (int it = 0; it < NC; ++it) {
    const int i = tid + it * D;
    *reinterpret_cast<uint4*>(sK + (i / CH) * D + (i % CH) * 8) = kr[it];
    *reinterpret_cast<uint4*>(sV + (i / CH) * D + (i % CH) * 8) = vr[it];
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
      for (int e = 0; e < E; ++e) kv[e] = __bfloat162float(sK[kk * D + lane * E + e]);
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += sQ[r][lane * E + e] * kv[e];
        part = warp_sum(part);
        if (lane == 0) {
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

  // softmax over the split, one warp per row
  for (int r = warp; r < rows; r += NW) {
    const float s0 = sP[r][lane];
    const float s1 = sP[r][lane + 32];
    const float m = warp_max(fmaxf(s0, s1));
    const float p0 = s0 == -INFINITY ? 0.f : __expf(s0 - m);
    const float p1 = s1 == -INFINITY ? 0.f : __expf(s1 - m);
    sP[r][lane] = p0;
    sP[r][lane + 32] = p1;
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
      acc0 += sP[r][kk] * __bfloat162float(sV[kk * D + tid]);
      acc1 += sP[r][kk + 1] * __bfloat162float(sV[(kk + 1) * D + tid]);
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
template <int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const int* __restrict__ kv_lengths, bf16* __restrict__ out,
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
  out[(((long long)b * H + h) * Sq + j) * D + tid] = __float2bfloat16(l > 0.f ? a / l : 0.f);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_lengths, const int* q_positions,
                   const float* slopes, float* part_acc, float* part_m,
                   float* part_l, void* out, int B, int H, int Hkv, int Sq,
                   int S, const long long* st, float scale, cudaStream_t stream) {
  const int n_splits = (S + TK - 1) / TK;
  const int rows = (H / Hkv) * Sq;
  const int row_chunks = (rows + MAX_ROWS - 1) / MAX_ROWS;
  dim3 grid(n_splits, Hkv * row_chunks, B);
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<D><<<grid, D, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kv_lengths, q_positions, slopes, part_acc,
      part_m, part_l, H, Hkv, Sq, S, n_splits, row_chunks, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<D><<<dim3(Sq, H, B), D, 0, stream>>>(
      part_acc, part_m, part_l, kv_lengths, static_cast<bf16*>(out), H, Sq, S,
      n_splits);
  return cudaGetLastError();
}

}  // namespace

// Number of KV splits for a cache of S positions (sizes the partials).
extern "C" int llark_flash_decode_splits(int S) { return (S + TK - 1) / TK; }

// C entry point, bound with ctypes. q [B,H,Sq,D] bf16; k/v cache
// [B,Hkv,S,D] bf16, unit stride in D; `strides` holds the (batch, head, seq)
// element strides of q, k, v in that order. Partials: part_acc
// [B,H,Sq,splits,D], part_m/part_l [B,H,Sq,splits] fp32. out is a
// contiguous [B,H,Sq,D] bf16 tensor. `slopes` may be null. Returns the
// launches' cudaError_t.
extern "C" int llark_flash_decode(const void* q, const void* k, const void* v,
                                  const int* kv_lengths, const int* q_positions,
                                  const float* slopes, float* part_acc,
                                  float* part_m, float* part_l, void* out, int B,
                                  int H, int Hkv, int Sq, int S, int D,
                                  const long long* strides, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, kv_lengths, q_positions, slopes, part_acc,
                      part_m, part_l, out, B, H, Hkv, Sq, S, strides, scale, s);
  if (D == 128)
    return launch<128>(q, k, v, kv_lengths, q_positions, slopes, part_acc,
                       part_m, part_l, out, B, H, Hkv, Sq, S, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
