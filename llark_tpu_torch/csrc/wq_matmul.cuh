// The tile loop shared by the two weight-only quantized products
// (int8_matmul.cu, int4_matmul.cu): y[M, N] = x[M, K] @ W[K, N] with x in
// bf16 or fp32, W stored in 8 or 4 bits with N minor, an fp32 accumulator
// and y in x's dtype. One kernel family on wgmma for every M.
//
// What bounds it. At decode shapes (M = 1 or 8) every weight byte is used
// once: the product is bound by the weight bytes, so nothing but the stored
// bytes may cross device memory and enough of them must be in flight (by
// Little's law ~3.3 MB on the card, ~25 KB an SM). At admission shapes (M in
// the thousands) it is bound by the tensor cores, and each weight byte must
// be reused from shared memory by many tokens.
//
// Design.
//   * The operands are swapped: each block computes out^T = W^T x^T for a
//     tile of output channels (wgmma's M, 64 rows a product) and a tile of
//     tokens (wgmma's N, NTOK = 8 ... 128 columns). Decode runs n = 8 with
//     no padded channel, admission n = 64 or 128.
//   * The weights are the register A operand. Their stored bytes arrive in
//     shared memory through a ring of STAGES tiles filled by 16-byte (8-byte
//     where N % 16 != 0) cp.async copies; each consumer warp reads its
//     A-fragment bytes from there and converts them in registers, exactly
//     (W::frags). wgmma labels A's rows only by position, so a warpgroup's
//     two m64 tiles take their 128 channels in the order that lets lane
//     (g, t) of warp w read whole 4-byte words: channels 32w + 4g .. 32w +
//     4g + 3, which are rows g and g + 8 of tile 0 and rows g and g + 8 of
//     tile 1. A row of the weight tile is padded (W::kPad) so that the
//     four contraction rows a warp reads at once fall on distinct banks.
//   * The activations are the B operand: x [M, K] with K contiguous is
//     wgmma's K-major B, kept in the 128-byte swizzle (wgmma.cuh) and copied
//     with cp.async (bf16) or loaded through registers and converted to
//     bf16 (fp32 x: `stage_x`; the product stays bf16 x bf16 -> fp32).
//   * The ring: every thread copies its share of a stage and arrives on the
//     stage's `full` mbarrier (cp.async arrivals, plus a plain arrive after
//     the stores of converted fp32 x). The k16 steps run one after another
//     across stages, a step's A fragments converted while the step before
//     is on the tensor cores (two register buffers); the first step of
//     stage j, once it finds stage j - 1's products done, releases that slot
//     (each warp arrives on `empty`) and requests stage j + STAGES - 1 into
//     it, so STAGES - 1 tiles are in flight.
//   * Decode regime (M <= 16): one warpgroup a block (128 channels), and
//     the contraction is split across blocks (`splits`) so that about BPS
//     blocks an SM stream weights (int4, half the bytes a stage, runs more
//     blocks of fewer stages). No second launch: each
//     block writes its fp32 partial sums to a workspace, and the last block
//     of an output tile to finish (a per-tile arrival counter finds it)
//     adds the partials in split order, applies the scale, writes the
//     output and resets the counter. The sum is deterministic: the same
//     order every run, never atomics on the values.
//   * Admission regime: two warpgroups a block (256 channels), 128-row
//     stages, and a token tile of 128 (int8) or 64 (int4, whose per-group
//     totals double the accumulator registers), so each weight byte crosses
//     memory ceil(M / NTOK) times and each x byte ceil(N / 256) times.
//   * int8 (W = Int8): the per-channel scale multiplies the finished fp32
//     sum. int4 (W = Int4): one fp32 accumulator per scale group, scaled at
//     the group's end into the running total (`tot`).
// M and N tails are masked (N % 8 == 0); the weight is never copied.

#pragma once

#include "mma_tiles.cuh"
#include "wgmma.cuh"

namespace wq {

using namespace hopper;

constexpr int SMALL_M = 16;      // up to here: the decode regime
constexpr int MAX_COUNTERS = 4096;  // arrival counters the workspace holds
constexpr int MIN_SPLIT_ROWS = 256;  // least contraction rows a split takes

// One regime's tiles: NTOK tokens x 128 * NWG channels a block, BK
// contraction rows a stage, STAGES stages, BPS blocks an SM.
template <int NTOK_, int NWG_, int BK_, int STAGES_, int BPS_>
struct Tiles {
  static constexpr int NTOK = NTOK_, NWG = NWG_, BK = BK_, STAGES = STAGES_, BPS = BPS_;
  static constexpr int NT = 128 * NWG;
  static constexpr int BN = 128 * NWG;
};

// A [ROWS, 64 * halves] bf16 tile in wgmma's 128-byte swizzle: column half
// hc (64 columns, 128 bytes a row) at hc * ROWS * 128, row r at r * 128
// within it, its 16-byte chunk c at chunk c ^ (r % 8).
template <int ROWS>
__device__ __forceinline__ int swizzled(int hc, int r, int c) {
  return hc * ROWS * 128 + r * 128 + ((c ^ (r & 7)) << 4);
}

// x[m0 : m0 + NTOK, k0 : k0 + BK] into a swizzled tile; rows at or past m
// and columns at or past kend are zeros. bf16: cp.async copies. fp32: every
// chunk is loaded into registers before the first store (a load-store loop
// would pay one memory round trip per chunk), converted to bf16, stored,
// and the stores are fenced for wgmma's reads. Returns nothing; the caller
// arrives on the stage's barrier.
template <class XT, int NTOK, int BK, int NT>
__device__ __forceinline__ void stage_x(unsigned char* dst, const XT* __restrict__ x, int m,
                                        int k_total, int m0, int k0, int kend) {
  constexpr int CH = BK / 8;  // 8-element chunks per row (16 bytes of bf16)
  constexpr int TOTAL = NTOK * CH;
  constexpr int N = (TOTAL + NT - 1) / NT;
  static_assert(TOTAL % NT == 0 || TOTAL < NT, "whole copy rounds");
  if constexpr (sizeof(XT) == 2) {
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int i = threadIdx.x + it * NT;
      if (TOTAL < NT && i >= TOTAL) break;
      const int r = i / CH, c = i % CH;
      const bool ok = m0 + r < m && k0 + 8 * c < kend;
      const XT* p = ok ? x + (long long)(m0 + r) * k_total + k0 + 8 * c : x;
      cp_async16(dst + swizzled<NTOK>(c / 8, r, c % 8), p, ok);
    }
  } else {
    float4 v[N][2];
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int i = threadIdx.x + it * NT;
      const int r = i / CH, c = i % CH;
      v[it][0] = v[it][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < TOTAL && m0 + r < m && k0 + 8 * c < kend) {
        const float4* p = reinterpret_cast<const float4*>(x + (long long)(m0 + r) * k_total + k0 + 8 * c);
        v[it][0] = __ldg(p);
        v[it][1] = __ldg(p + 1);
      }
    }
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int i = threadIdx.x + it * NT;
      if (TOTAL < NT && i >= TOTAL) break;
      const int r = i / CH, c = i % CH;
      *reinterpret_cast<uint4*>(dst + swizzled<NTOK>(c / 8, r, c % 8)) =
          tiles::pack_f8(v[it][0], v[it][1]);
    }
    fence_proxy_async();
  }
}

// Stored weight rows [r0, r0 + ROWS) and bytes [n0, n0 + BN) of a [*, n]
// byte matrix into a ring tile with row pitch PITCH, asynchronously; rows
// at or past rend and columns at or past n are zeros. 16-byte copies where
// the rows are 16-byte aligned (vec16), else 8-byte ones.
template <int ROWS, int BN, int PITCH, int NT>
__device__ __forceinline__ void stage_w(unsigned char* dst, const int8_t* __restrict__ w, int n,
                                        int r0, int rend, int n0, bool vec16) {
  constexpr int CH = BN / 16;
  constexpr int N = ROWS * CH / NT;
  static_assert(ROWS * CH % NT == 0, "whole copy rounds");
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / CH, c = i % CH;
    const int col = n0 + 16 * c;
    const bool row_ok = r0 + r < rend;
    const int8_t* p = w + (long long)(r0 + r) * n + col;
    unsigned char* d = dst + r * PITCH + 16 * c;
    if (vec16) {
      const bool ok = row_ok && col < n;
      cp_async16(d, ok ? p : w, ok);
    } else {
      const bool ok0 = row_ok && col < n, ok1 = row_ok && col + 8 < n;
      cp_async8(d, ok0 ? p : w, ok0);
      cp_async8(d + 8, ok1 ? p + 8 : w, ok1);
    }
  }
}

// W supplies the format:
//   W::kGrouped  false: `scale` is [N], applied once to the finished sum;
//                true: `scale` is [K / unit, N], and each group of `unit`
//                rows has its own fp32 accumulator, scaled at the group's
//                end into the running total;
//   W::kRowsPer16  stored rows per 16 contraction rows (16 int8, 8 int4);
//   W::kPad      bytes that pad a stored row of the ring tile;
//   W::frags()   the A fragments of both m64 tiles for one k16 step, read
//                from the ring tile at this lane's column and converted.
// Grid: (channel tiles of BN, token tiles of NTOK, splits of the
// contraction). With one split a block writes `out`; with more each writes
// its unrounded partial sums to `part` [splits, M, N] (for an ungrouped
// format still without the scale) and the last block of a tile to arrive
// on counters[tile] combines them.
template <class W, class XT, class C>
__global__ void __launch_bounds__(C::NT, C::BPS)
wq_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, XT* __restrict__ out, float* __restrict__ part,
                 int* __restrict__ counters, int m, int k_total, int n, int unit, int n_splits,
                 int vec16) {
  constexpr int NTOK = C::NTOK, BK = C::BK, STAGES = C::STAGES, NT = C::NT, BN = C::BN;
  constexpr int WROWS = BK * W::kRowsPer16 / 16;  // stored rows a stage
  constexpr int PITCH = BN + W::kPad;
  constexpr size_t X_TILE = size_t(NTOK) * BK * 2;
  constexpr size_t W_TILE = size_t(WROWS) * PITCH;
  constexpr size_t W_OFF = STAGES * X_TILE;
  constexpr size_t BAR_OFF = (W_OFF + STAGES * W_TILE + 7) / 8 * 8;
  constexpr int NACC = NTOK / 2;  // accumulator floats a thread, per m64 tile
  constexpr bool F32 = sizeof(XT) == 4;
  static_assert(X_TILE % 1024 == 0, "swizzled x tiles stay 1024-byte aligned");
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  int* s_last = reinterpret_cast<int*>(empty + STAGES);
  if (smem_addr(smem) & 1023) __trap();  // the swizzle is of absolute addresses

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * NTOK;
  const int colw = 128 * wg + 32 * warp + 4 * g;  // this lane's 4 channels in the tile
  const int c4 = n0 + colw;

  // this block's share of the contraction, in whole units
  const int units = k_total / unit;
  const int kbeg = (int)((long long)units * blockIdx.z / n_splits) * unit;
  const int kend = (int)((long long)units * (blockIdx.z + 1) / n_splits) * unit;
  const int n_stages = (kend - kbeg + BK - 1) / BK;

  if (tid < STAGES) {
    mbar_init(full + tid, F32 ? 2 * NT : NT);
    mbar_init(empty + tid, NT / 32);
  }
  __syncthreads();
  auto load = [&](int s) {
    const int stg = s % STAGES;
    if (s >= STAGES) mbar_wait(empty + stg, (s / STAGES - 1) & 1);
    const int k0 = kbeg + s * BK;
    stage_w<WROWS, BN, PITCH, NT>(smem + W_OFF + stg * W_TILE, w, n, k0 * W::kRowsPer16 / 16,
                                  kend * W::kRowsPer16 / 16, n0, vec16);
    // the cp.async arrival counts only the copies issued before it
    if constexpr (F32) {
      cp_async_arrive(full + stg);
      stage_x<XT, NTOK, BK, NT>(smem + stg * X_TILE, x, m, k_total, m0, k0, kend);
      mbar_arrive(full + stg);
    } else {
      stage_x<XT, NTOK, BK, NT>(smem + stg * X_TILE, x, m, k_total, m0, k0, kend);
      cp_async_arrive(full + stg);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load(s);
  }

  float acc[2][NACC];
  float tot[2][NACC];  // grouped formats only
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[0][i] = acc[1][i] = tot[0][i] = tot[1][i] = 0.f;
  float gs[4] = {0.f, 0.f, 0.f, 0.f};  // the open group's scales at this lane's channels
  const int steps_per_unit = unit / 16;
  uint32_t a[2][2][4];  // A fragments: [step parity][m64 tile][register]

  // One k16 step after another, across stages: a step's A fragments are
  // converted while the step before is on the tensor cores (two register
  // buffers), and a stage is released, and its slot refilled, once the
  // first step of the next stage has found its last products done.
  for (int j = 0; j < n_stages; ++j) {
    const int stg = j % STAGES;
    const int k0 = kbeg + j * BK;
    const int steps = min(BK, kend - k0) / 16;
    int in_unit = W::kGrouped ? ((k0 - kbeg) / 16) % steps_per_unit : 0;
    mbar_wait(full + stg, (j / STAGES) & 1);
    fence_proxy_async();
    const unsigned char* wt = smem + W_OFF + stg * W_TILE + colw;
    const unsigned char* xt = smem + stg * X_TILE;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      if (ks < steps) {
        if (W::kGrouped && in_unit == 0 && c4 < n) {
          // in flight until the group ends
          const int group = (k0 + 16 * ks) / unit;
          const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + (long long)group * n + c4));
          gs[0] = s4.x, gs[1] = s4.y, gs[2] = s4.z, gs[3] = s4.w;
        }
        uint32_t(&af)[2][4] = a[ks & 1];
        W::template frags<PITCH>(wt, ks, t, af);
        const uint64_t db = make_desc(xt + (ks / 4) * NTOK * 128 + (ks % 4) * 32, 16, 1024) |
                            (uint64_t(1) << 62);
        wgmma_fence();
        wgmma_rs<0>(acc[0], af[0], db, 1);
        wgmma_rs<0>(acc[1], af[1], db, 1);
        wgmma_commit();
        if (W::kGrouped && ++in_unit == steps_per_unit) {
          // the group ends: its sum, times its scale, joins the total
          wgmma_wait<0>();
          fence_regs(acc[0]);
          fence_regs(acc[1]);
#pragma unroll
          for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
            for (int i = 0; i < NACC; ++i) {
              tot[tt][i] += gs[2 * tt + ((i >> 1) & 1)] * acc[tt][i];
              acc[tt][i] = 0.f;
            }
          }
          in_unit = 0;
        } else {
          wgmma_wait<1>();  // the step before is done: its A buffer is free
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          fence_regs(a[p][0]);
          fence_regs(a[p][1]);
        }
        if (ks == 0) {
          // stage j - 1's products are done: release its slot and refill it
          if (j > 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + (j - 1) % STAGES);
          }
          if (j + STAGES - 1 < n_stages) load(j + STAGES - 1);
        }
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // value q (0..3: channel c4 + q) of token 8jj + 2t + e
  auto value = [&](int q, int jj, int e) {
    const int i = 4 * jj + 2 * (q & 1) + e;
    return W::kGrouped ? tot[q >> 1][i] : acc[q >> 1][i];
  };
  auto store = [&](int row, const float (&v)[4]) {
    if constexpr (F32) {
      *reinterpret_cast<float4*>(out + (long long)row * n + c4) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<uint2*>(out + (long long)row * n + c4) =
          make_uint2(tiles::pack_f2(v[0], v[1]), tiles::pack_f2(v[2], v[3]));
    }
  };
  float cs[4] = {1.f, 1.f, 1.f, 1.f};
  if (!W::kGrouped && c4 < n) {
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + c4));
    cs[0] = s4.x, cs[1] = s4.y, cs[2] = s4.z, cs[3] = s4.w;
  }

  if (n_splits == 1) {
    if (c4 >= n) return;
#pragma unroll
    for (int jj = 0; jj < NTOK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * jj + 2 * t + e;
        if (row >= m) continue;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = value(q, jj, e) * cs[q];
        store(row, v);
      }
    }
    return;
  }

  // split contraction: partials out, then the tile's last block combines
  if (c4 < n) {
#pragma unroll
    for (int jj = 0; jj < NTOK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * jj + 2 * t + e;
        if (row >= m) continue;
        *reinterpret_cast<float4*>(part + ((long long)blockIdx.z * m + row) * n + c4) =
            make_float4(value(0, jj, e), value(1, jj, e), value(2, jj, e), value(3, jj, e));
      }
    }
  }
  // the block's partials, then (one thread, after the barrier) a fence and
  // the tile's arrival: the last block to arrive sees every partial
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) {
    __threadfence();
    *s_last = atomicAdd(counters + tile, 1) == n_splits - 1;
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  if (tid == 0) counters[tile] = 0;  // ready for the next launch
  if (c4 >= n) return;
#pragma unroll
  for (int jj = 0; jj < NTOK / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * jj + 2 * t + e;
      if (row >= m) continue;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int z = 0; z < n_splits; ++z) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(part + ((long long)z * m + row) * n + c4));
        v[0] += p.x, v[1] += p.y, v[2] += p.z, v[3] += p.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] *= cs[q];
      store(row, v);
    }
  }
}

// The regimes (`python -m llark_tpu_torch.tools.wq_variants` re-times
// these choices): int4 at M <= 8 reads half the bytes a stage of int8 does
// and runs more blocks of fewer stages
using Decode8 = Tiles<8, 1, 128, 3, 2>;
using Decode8Int4 = Tiles<8, 1, 128, 2, 4>;
using Decode16 = Tiles<16, 1, 128, 3, 2>;
using Admit64 = Tiles<64, 2, 128, 3, 1>;
using Admit128 = Tiles<128, 2, 128, 3, 1>;

inline int sm_count() {
  static int sms[64] = {};  // by device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 132;
  if (sms[dev] == 0 && cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    sms[dev] = 132;
  }
  return sms[dev];
}

// Calls f(C{}) with the tiles C of the regime that m tokens run in.
template <class W, class F>
inline int with_tiles(int m, F&& f) {
  if (m <= 8) {
    if constexpr (W::kGrouped) {
      return f(Decode8Int4{});
    } else {
      return f(Decode8{});
    }
  }
  if (m <= SMALL_M) return f(Decode16{});
  if constexpr (W::kGrouped) {
    return f(Admit64{});
  } else {
    return m <= 64 ? f(Admit64{}) : f(Admit128{});
  }
}

// How many blocks share the contraction of an [m, k] x [k, n] product: as
// many as bring the blocks to about BPS an SM, each taking whole `unit`s of
// rows (16 for int8, the scale group for int4) and at least MIN_SPLIT_ROWS.
template <class W>
inline int splits(int m, int k, int n, int unit) {
  return with_tiles<W>(m, [&](auto c) {
    using C = decltype(c);
    const long long tiles = (long long)((n + C::BN - 1) / C::BN) * ((m + C::NTOK - 1) / C::NTOK);
    const long long target = (long long)C::BPS * sm_count();
    if (tiles >= target) return 1;
    int s = (int)(target / tiles);
    if (s > k / MIN_SPLIT_ROWS) s = k / MIN_SPLIT_ROWS;
    if (s > k / unit) s = k / unit;
    return s < 1 ? 1 : s;
  });
}

template <class W, class XT, class C>
cudaError_t launch_as(const void* x, const void* w, const void* scale, void* out, void* part,
                      void* counters, int m, int k, int n, int unit, int n_splits, int vec16,
                      cudaStream_t stream) {
  constexpr int WROWS = C::BK * W::kRowsPer16 / 16;
  constexpr size_t bar_off =
      (C::STAGES * (size_t(C::NTOK) * C::BK * 2 + size_t(WROWS) * (C::BN + W::kPad)) + 7) / 8 * 8;
  const size_t smem = bar_off + 2 * C::STAGES * sizeof(uint64_t) + 16;  // + the last-block flag
  auto kernel = wq_matmul_kernel<W, XT, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + C::BN - 1) / C::BN, (m + C::NTOK - 1) / C::NTOK, n_splits);
  if (n_splits > 1 && (long long)grid.x * grid.y > MAX_COUNTERS) return cudaErrorInvalidValue;
  kernel<<<grid, C::NT, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<XT*>(out), static_cast<float*>(part), static_cast<int*>(counters), m, k, n, unit,
      n_splits, vec16);
  return cudaGetLastError();
}

// One launch on `stream`. x and out are bf16 (x_f32 = 0) or fp32; `n_splits`
// must be splits<W>(m, k, n, unit), and with more than one `part` holds
// [n_splits, m, n] floats and `counters` MAX_COUNTERS zeros (the kernel
// leaves them zero). vec16: the weight's rows are 16-byte aligned. Returns
// the launch's cudaError_t.
template <class W>
int launch(const void* x, const void* w, const void* scale, void* out, void* part, void* counters,
           int m, int k, int n, int unit, int n_splits, int x_f32, int vec16, cudaStream_t stream) {
  return with_tiles<W>(m, [&](auto c) {
    using C = decltype(c);
    return (int)(x_f32 ? launch_as<W, float, C>(x, w, scale, out, part, counters, m, k, n, unit,
                                                 n_splits, vec16, stream)
                       : launch_as<W, bf16, C>(x, w, scale, out, part, counters, m, k, n, unit,
                                                n_splits, vec16, stream));
  });
}

}  // namespace wq
