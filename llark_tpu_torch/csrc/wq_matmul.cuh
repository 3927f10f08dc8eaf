// The tile loop shared by the two weight-only quantized products
// (int8_matmul.cu, int4_matmul.cu): y[M, N] = x[M, K] @ W[K, N] with x in
// bf16, W stored in 8 or 4 bits with N minor, and an fp32 accumulator.
//
// What bounds it. At decode shapes (M = 1 or 8) every weight byte is used
// once: the product is bound by the weight bytes, so nothing but the stored
// bytes may cross device memory and enough loads must be in flight. At
// admission shapes (M in the thousands) it is bound by the tensor cores.
//
// Design. The weights never pass through shared memory. mma.m16n8k16 sums
// over its 16 contraction slots and labels its 8 output columns only by
// position, so a lane may feed it any 8 columns as long as the result is
// read back the same way. Lane (g, t) of a warp loads V 4-byte words per
// weight row in one load: the 4 * V neighbouring columns nw + 4V g .. of
// the rows its B fragment needs (k + 2t, 2t + 1, 2t + 8, 2t + 9). Byte j
// of those words is column slot g of column group j: 4 * V products per
// 16-row step, one per byte, cover the warp's 32 * V columns, and each
// weight row is read as whole 32-byte sectors. In the accumulators lane
// (g, t) then holds rows g and g + 8 at the 8 * V neighbouring columns
// nw + 8V t .. (group j gives columns j and 4V + j), which leave as
// 16-byte stores.
//
// The activations go through shared memory (every warp of a block needs
// the same x tile): 16 rows x up to 512 columns for M <= 16, so that a
// decode-shape block synchronises once or twice and then streams weights;
// 64 rows x 128 columns above that. The weight loads are software-
// pipelined: while one batch of four 16-row steps is multiplied, the words
// of the next batch are already in flight. A block is 4 warps side by
// side. For M <= 16 (V = 2, 256 columns a block) the contraction is split
// across blocks so that the card is full (N = 4096 gives only 16 column
// blocks for 132 SMs); the partial sums go to an fp32 scratch tensor and a
// second kernel adds them in split order: deterministic, unlike atomics, so
// a greedy near-tie cannot flip from run to run. Above that V = 1 and a
// block holds 64 rows (the accumulators fill the registers). M and N tails
// are masked (N % 8 == 0).

#pragma once

#include "mma_tiles.cuh"

namespace wq {

constexpr int NT = 128;      // threads per block: 4 warps side by side
constexpr int SMALL_M = 16;  // up to here: one 16-row tile, split contraction
constexpr int V_SMALL = 2;  // 4-byte words a lane loads per weight row, M <= 16
constexpr int V_LARGE = 1;      // and above
constexpr int TARGET_BLOCKS = 4 * 132;  // about four blocks per SM of an H100
constexpr int MIN_SPLIT_ROWS = 512;

// How many blocks share the contraction of an [m, k] x [k, n] product;
// each takes whole `unit`s of rows (16 for int8, the scale group for int4).
inline int splits(int m, int k, int n, int unit) {
  if (m > SMALL_M) return 1;
  const int bn = 4 * 32 * V_SMALL;
  const int col_blocks = (n + bn - 1) / bn;
  int s = TARGET_BLOCKS / col_blocks;
  if (s > k / MIN_SPLIT_ROWS) s = k / MIN_SPLIT_ROWS;
  if (s > k / unit) s = k / unit;
  return s < 1 ? 1 : s;
}

// Copy x[m0 : m0 + ROWS, k0 : k0 + BK] into shared memory (row stride
// BK + 8); rows at or past m and columns at or past kend are zero. All
// 16-byte loads are issued before the first store: the compiler cannot move
// a global load above a store through another pointer it might alias, so a
// load-store loop would pay one memory round trip per iteration.
template <int ROWS, int BK>
__device__ __forceinline__ void load_x(bf16* xs, const bf16* __restrict__ x, int m,
                                       int k_total, int m0, int k0, int kend) {
  constexpr int LD = BK + 8;
  constexpr int CH = BK / 8;  // 16-byte chunks per row
  constexpr int N = ROWS * CH / NT;
  static_assert(ROWS * CH % NT == 0, "whole copy rounds");
  uint4 val[N];
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / CH;
    const int c = (i % CH) * 8;
    val[it] = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < m && k0 + c < kend) {
      val[it] = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * k_total + k0 + c);
    }
  }
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int i = threadIdx.x + it * NT;
    *reinterpret_cast<uint4*>(xs + (i / CH) * LD + (i % CH) * 8) = val[it];
  }
}

// V neighbouring 4-byte words in one load
__device__ __forceinline__ void load_words(uint32_t (&v)[1], const int8_t* p) {
  v[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ void load_words(uint32_t (&v)[2], const int8_t* p) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = r.x, v[1] = r.y;
}
__device__ __forceinline__ void load_words(uint32_t (&v)[4], const int8_t* p) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
}

// The weight words of the U steps from row k, for this lane's 4 * V
// columns: raw[u][i][r] is word i of the r-th row the step's B fragments
// need. Zeros for a dead lane and for steps at or past kend.
template <int U, int V, class W>
__device__ __forceinline__ void load_batch(uint32_t (&raw)[U][V][W::kRows],
                                           const int8_t* __restrict__ w, int n, int k, int kend,
                                           int col, bool live, int t) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int r = 0; r < W::kRows; ++r) {
      uint32_t words[V];
#pragma unroll
      for (int i = 0; i < V; ++i) words[i] = 0u;
      if (live && k + 16 * u < kend) {
        load_words(words, w + W::row(k + 16 * u, t, r) * n + col);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) raw[u][i][r] = words[i];
    }
  }
}

// 8 neighbouring fp32 values, 32-byte aligned
__device__ __forceinline__ void load8(float* v, const float* __restrict__ p) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// W supplies the format:
//   W::kGrouped  false: `scale` is [N], applied once to the finished sum;
//                true: `scale` is [K / unit, N], and each group of `unit`
//                rows has its own fp32 accumulator, scaled at the group's
//                end into the running total;
//   W::kRows     stored rows a lane reads per 16-row step;
//   W::row()     the r-th of them, for the step from row k and lane t;
//   W::frags()   one word of each of those rows (4 columns) as B fragments
//                (b0, b1 of 4 column groups).
// V is the number of words (4 columns each) a lane loads per row. Grid:
// (column blocks of 128 * V, row blocks of 16 * MT, splits of the
// contraction). With one split the block writes bf16 `out`; with more it
// writes its unrounded partial sums to `part` [splits, M, N] for
// wq_combine_kernel (for an ungrouped format still without the scale).
template <int MT, int V, class W>
__global__ void __launch_bounds__(NT)
wq_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, bf16* __restrict__ out,
                 float* __restrict__ part, int m, int k_total, int n, int unit, int n_splits) {
  constexpr int BM = 16 * MT;
  constexpr int BK = MT == 1 ? 512 : 128;
  constexpr int LD = BK + 8;
  constexpr int U = 4;     // 16-row steps per batch of weight loads
  constexpr int NJ = 4 * V;  // column groups (products per step and row tile)
  static_assert(BK % (16 * U) == 0, "whole batches per x tile");
  __shared__ __align__(16) bf16 xs[BM * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * BM;
  const int nw = (blockIdx.x * 4 + warp) * 32 * V;
  const int col = nw + NJ * g;       // the 4 * V weight columns this lane loads
  const int col_out = nw + 2 * NJ * t;  // the 8 * V output columns this lane holds
  const bool live = col < n;

  // this block's share of the contraction, in whole units
  const int units = k_total / unit;
  const int kbeg = (int)((long long)units * blockIdx.z / n_splits) * unit;
  const int kend = (int)((long long)units * (blockIdx.z + 1) / n_splits) * unit;
  const int steps_per_unit = unit / 16;

  float acc[MT][NJ][4];
  float tot[MT][NJ][4];  // grouped formats only
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f, tot[mt][j][i] = 0.f;
    }
  }
  float gs[2 * NJ];  // the open group's scales at this lane's output columns
#pragma unroll
  for (int i = 0; i < 2 * NJ; ++i) gs[i] = 0.f;
  int in_unit = 0;
  int group = kbeg / unit;

  // The weight words of one batch of U steps are in flight while the batch
  // before it is multiplied: the compiler does not move the loads of a later
  // step above the products of an earlier one by itself. (A deeper ring of
  // batches was tried: its registers cost more resident blocks than the
  // extra loads in flight gained.)
  uint32_t cur[U][V][W::kRows], nxt[U][V][W::kRows];
  load_batch<U, V, W>(cur, w, n, kbeg, kend, col, live, t);
  for (int k = kbeg; k < kend; k += 16 * U) {
    load_batch<U, V, W>(nxt, w, n, k + 16 * U, kend, col, live, t);
    const int ks0 = (k - kbeg) % BK;  // a batch never straddles two x tiles
    if (ks0 == 0) {
      __syncthreads();  // the last tile's readers are done
      load_x<BM, BK>(xs, x, m, k_total, m0, k, kend);
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + 16 * u < kend) {
        if (W::kGrouped && in_unit == 0) {
          // in flight until the group ends
#pragma unroll
          for (int c = 0; c < V; ++c) {
            if (col_out + 8 * c < n) load8(gs + 8 * c, scale + (long long)group * n + col_out + 8 * c);
          }
        }
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) tiles::load_a(a[mt], xs, LD, mt * 16, ks0 + 16 * u, g, t);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          uint32_t b0[4], b1[4];
          W::frags(cur[u][i], b0, b1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int j = 0; j < 4; ++j) tiles::mma16816(acc[mt][4 * i + j], a[mt], b0[j], b1[j]);
          }
        }
        if (W::kGrouped && ++in_unit == steps_per_unit) {
          // the group ends: its sum, times its scale, joins the total
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                tot[mt][j][i] += gs[j + NJ * (i & 1)] * acc[mt][j][i];
                acc[mt][j][i] = 0.f;
              }
            }
          }
          in_unit = 0;
          ++group;
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
#pragma unroll
        for (int r = 0; r < W::kRows; ++r) cur[u][i][r] = nxt[u][i][r];
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + mt * 16 + g + 8 * half;
      if (row >= m) continue;
      // column group j holds this lane's columns j (slot 2t) and NJ + j
      // (slot 2t + 1)
      float v[2 * NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        v[j] = W::kGrouped ? tot[mt][j][2 * half] : acc[mt][j][2 * half];
        v[NJ + j] = W::kGrouped ? tot[mt][j][2 * half + 1] : acc[mt][j][2 * half + 1];
      }
#pragma unroll
      for (int c = 0; c < V; ++c) {  // 8 columns at a time
        const int c0 = col_out + 8 * c;
        if (c0 >= n) continue;
        const float* vc = v + 8 * c;
        if (n_splits > 1) {
          float4* p = reinterpret_cast<float4*>(part + ((long long)blockIdx.z * m + row) * n + c0);
          p[0] = make_float4(vc[0], vc[1], vc[2], vc[3]);
          p[1] = make_float4(vc[4], vc[5], vc[6], vc[7]);
        } else {
          float cs[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
          if (!W::kGrouped) load8(cs, scale + c0);
          uint4 o;
          o.x = tiles::pack_f2(vc[0] * cs[0], vc[1] * cs[1]);
          o.y = tiles::pack_f2(vc[2] * cs[2], vc[3] * cs[3]);
          o.z = tiles::pack_f2(vc[4] * cs[4], vc[5] * cs[5]);
          o.w = tiles::pack_f2(vc[6] * cs[6], vc[7] * cs[7]);
          *reinterpret_cast<uint4*>(out + (long long)row * n + c0) = o;
        }
      }
    }
  }
}

// out[m, n] = bf16(scale[n] * sum over splits, in split order, of part);
// SCALED false: the partial sums already carry their scales. One thread
// per 4 neighbouring columns.
template <bool SCALED>
__global__ void wq_combine_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                                  bf16* __restrict__ out, int m, int n, int n_splits) {
  const long long quad = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long size = (long long)m * n;
  if (quad * 4 >= size) return;
  const float* p = part + quad * 4;
  float4 s = *reinterpret_cast<const float4*>(p);
  for (int z = 1; z < n_splits; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(p + z * size);
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  if (SCALED) {
    const float4 c = __ldg(reinterpret_cast<const float4*>(scale + (quad * 4) % n));
    s.x *= c.x, s.y *= c.y, s.z *= c.z, s.w *= c.w;
  }
  uint2 o;
  o.x = tiles::pack_f2(s.x, s.y);
  o.y = tiles::pack_f2(s.z, s.w);
  *reinterpret_cast<uint2*>(out + quad * 4) = o;
}

// Launch on `stream`: the product, then the combine if the contraction was
// split. `n_splits` must be splits(m, k, n, unit), and `part` then holds
// [n_splits, m, n] floats. Returns the first cudaError_t of a launch.
template <class W>
int launch(const void* x, const void* w, const void* scale, void* out, void* part, int m, int k,
           int n, int unit, int n_splits, cudaStream_t stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  bf16* op = static_cast<bf16*>(out);
  float* pp = static_cast<float*>(part);
  if (m <= SMALL_M) {
    const int col_blocks = (n + 128 * V_SMALL - 1) / (128 * V_SMALL);
    wq_matmul_kernel<1, V_SMALL, W><<<dim3(col_blocks, 1, n_splits), NT, 0, stream>>>(
        xp, wp, sp, op, pp, m, k, n, unit, n_splits);
  } else {
    if (n_splits != 1) return (int)cudaErrorInvalidValue;
    const int col_blocks = (n + 128 * V_LARGE - 1) / (128 * V_LARGE);
    wq_matmul_kernel<4, V_LARGE, W><<<dim3(col_blocks, (m + 63) / 64, 1), NT, 0, stream>>>(
        xp, wp, sp, op, pp, m, k, n, unit, 1);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  const long long quads = (long long)m * n / 4;
  wq_combine_kernel<!W::kGrouped><<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
      pp, sp, op, m, n, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace wq
