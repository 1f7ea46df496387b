// Building blocks of the fp32 attention kernels (masked_attention_fwd.cu,
// masked_attention_bwd.cu, masked_attention_bwd_dkv.cu): tiles of 64 rows
// of HD fp32 (HD = 64 or 128, the head width, or a half of a D = 256 row)
// in shared memory, filled with cp.async, and multiplied on the SIMT units
// with fp32 FMAs (the fp32 path must match the fp32 reference, which one
// TF32 product would not; the 3xTF32 forward, masked_attention_fwd_3xtf32.cu,
// does on the tensor cores). At D = 256 a row is two tiles of 128 columns: the
// loaders and the column sums take a row stride LD apart from the columns
// they read, and dots can add a second half's product to the first's.
//
// Register tiles. A warp group of 128 threads covers a 64 x 64 product;
// thread t, with rg = t / 16 and cg = t % 16, owns 8 x 4 of it: rows
// rg + 8 i (i < 8) and columns cg + 16 j (j < 4) of a score-like tile
// (dots), or rows rg + 8 i and the head-width columns 64 u + 4 cg .. 64 u +
// 4 cg + 3 (u < HD / 64) of an accumulator (accumulate): CW = HD / 16
// columns a thread, acc[i][4 u + c]. With RS = 16 row groups instead of 8,
// 256 threads cover it, each owning 4 x 4 (rows rg + 16 i): half the chain of
// dependent instructions a thread, for kernels that a block's latency
// bounds. The 16 threads of a row group are one half-warp,
// so a tile that one product writes and the next reads row by row (P in the
// forward, dS in dQ, P^T and dS^T in dK/dV) is exchanged within a warp:
// __syncwarp is enough.
//
// Shared-memory reads are 16 bytes (LDS.128), a thread's operands
// contiguous along the summed index: per 4 steps of a sum, dots reads 8 + 4
// float4 for 128 FMAs, accumulate 8 + 4 for each 64 columns. Rows are
// ldp(HD) = HD + 4 floats apart (68 or 132: 17 or 33 chunks of 16 bytes), so
// the 8 rows cg .. cg + 7 of a quarter-warp's 16-byte reads fall into 8
// different 16-byte bank groups, and the two rows rg, rg + 1 that a warp
// reads as broadcasts into two; accumulate's second operand is one row, 16
// threads on 16 consecutive chunks (a 64-column half at a time).

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace f32 {

constexpr int TILE_ROWS = 64;  // rows of a tile (query rows or keys)
constexpr int GROUP_THREADS = 128;     // a warp group: one 64 x 64 product
// row stride of a shared tile of HD columns (a head-width tile, or HD = 64
// for a score tile of 64 keys or rows), and its floats
template <int HD>
__host__ __device__ constexpr int ldp() { return HD + 4; }
template <int HD>
__host__ __device__ constexpr int tile() { return TILE_ROWS * ldp<HD>(); }
constexpr float NEG = -4294967295.0f;  // -2^32+1, rounds to -2^32 as in fp32 JAX
// D = 256: a row is two tiles of HALF columns, and a block computes the
// output columns of one of them (the grid has an axis over the halves)
constexpr int WIDE = 256;
constexpr int HALF = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Rows [row0, row0 + 64) of HD columns of an fp32 matrix whose rows are LD
// floats apart into a shared tile, as asynchronous copies by THREADS threads
// numbered `tid` (16 bytes a copy, HD / 4 a row); rows at or past
// `rows_end` become zeros.
template <int THREADS, int HD, int LD = HD>
__device__ __forceinline__ void load_tile_async(float* dst, const float* __restrict__ src,
                                                int row0, int rows_end, int tid) {
  constexpr int CHUNKS = HD / 4, SHIFT = cpa::log2i(CHUNKS);  // 16-byte chunks a row
#pragma unroll
  for (int chunk = tid; chunk < TILE_ROWS * CHUNKS; chunk += THREADS) {
    const int r = chunk >> SHIFT, col = (chunk & (CHUNKS - 1)) * 4;
    const bool in = row0 + r < rows_end;
    cpa::cp_async16(dst + r * ldp<HD>() + col, in ? src + (size_t)(row0 + r) * LD + col : src,
                    in);
  }
}

// out[i][j] = sum_{d < HD} a[rg + RS i][d] * b[cg + 16 j][d] for i < NI, j < NJ (0
// for the others): S = Q.K^T in the forward and dQ, dP = dO.V^T in dQ,
// S^T = K.Q^T and dP^T = V.dO^T in dK/dV. NI < 64 / RS or NJ < 4 skips rows
// of `a` or `b` that the caller knows to be absent or masked. TRI, for a
// tile on the causal diagonal (row x of `a` and row y of `b` are query x and
// key y of one 64-index range), skips the pairs (i, j) whose keys all lie
// past their rows, 16 j > RS i + RS - 1: every product there is masked.
// `a` and `b` are head-width tiles (row stride ldp(HD)). ADD adds the sums
// to `out` in place of starting from 0 (the second half of a D = 256 row).
template <int NI, int NJ, bool TRI = false, int RS = 8, int HD = 64, bool ADD = false>
__device__ __forceinline__ void dots(float (&out)[TILE_ROWS / RS][4], const float* a,
                                     const float* b, int rg, int cg) {
  constexpr int LDP = ldp<HD>();
  if constexpr (!ADD) {
#pragma unroll
    for (int i = 0; i < TILE_ROWS / RS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 bv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (cg + 16 * j) * LDP + d);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(a + (rg + RS * i) * LDP + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (TRI && 16 * j > RS * i + RS - 1) continue;
        out[i][j] = fmaf(av.w, bv[j].w,
                         fmaf(av.z, bv[j].z, fmaf(av.y, bv[j].y, fmaf(av.x, bv[j].x, out[i][j]))));
      }
    }
  }
}

// o[c0 + c] += av . (bv[0][c], .., bv[3][c]) for c < 4: four steps of a sum.
template <int CW>
__device__ __forceinline__ void fma4(float (&o)[CW], int c0, const float4& av,
                                     const float4 (&bv)[4]) {
  o[c0] = fmaf(av.w, bv[3].x, fmaf(av.z, bv[2].x, fmaf(av.y, bv[1].x, fmaf(av.x, bv[0].x, o[c0]))));
  o[c0 + 1] = fmaf(av.w, bv[3].y, fmaf(av.z, bv[2].y, fmaf(av.y, bv[1].y, fmaf(av.x, bv[0].y, o[c0 + 1]))));
  o[c0 + 2] = fmaf(av.w, bv[3].z, fmaf(av.z, bv[2].z, fmaf(av.y, bv[1].z, fmaf(av.x, bv[0].z, o[c0 + 2]))));
  o[c0 + 3] = fmaf(av.w, bv[3].w, fmaf(av.z, bv[2].w, fmaf(av.y, bv[1].w, fmaf(av.x, bv[0].w, o[c0 + 3]))));
}

// acc[i][4 h + c] += sum_{r < n} a[rg + RS i][r] * b[r][64 h + 4 cg + c]
// for i < NI, h < HD / 64, n rounded up to 4 (the caller makes a's extra
// columns 0 or b's extra rows 0): O += P.V in the forward, dQ += dS.K,
// dV += P^T.dO and dK += dS^T.Q in the backward. `a` is a score tile of
// row stride LDA, `b` a head-width tile.
template <int NI, int RS = 8, int HD = 64, int LDA = ldp<HD>()>
__device__ __forceinline__ void accumulate(float (&acc)[TILE_ROWS / RS][HD / 16], const float* a,
                                           const float* b, int rg, int cg, int n) {
  constexpr int LDP = ldp<HD>();
#pragma unroll 1
  for (int r = 0; r < n; r += 4) {
#pragma unroll
    for (int h = 0; h < HD / 64; ++h) {
      float4 bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        bv[u] = *reinterpret_cast<const float4*>(b + (r + u) * LDP + 64 * h + 4 * cg);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(a + (rg + RS * i) * LDA + r);
        fma4(acc[i], 4 * h, av, bv);
      }
    }
  }
}

// accumulate on a tile on the causal diagonal (`a` is query x by key y of one
// 64-index range, 0 where y > x): row group i stops after the step that
// holds key RS i + RS - 1, and the steps unroll so that this costs no branch.
template <int NI, int RS = 8, int HD = 64>
__device__ __forceinline__ void accumulate_tri(float (&acc)[TILE_ROWS / RS][HD / 16],
                                               const float* a, const float* b, int rg, int cg,
                                               int n) {
  constexpr int LDP = ldp<HD>();
#pragma unroll
  for (int r = 0; r < TILE_ROWS; r += 4) {
    if (r >= n) break;
#pragma unroll
    for (int h = 0; h < HD / 64; ++h) {
      float4 bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        bv[u] = *reinterpret_cast<const float4*>(b + (r + u) * LDP + 64 * h + 4 * cg);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        if (r > RS * i + RS - 1) continue;
        const float4 av = *reinterpret_cast<const float4*>(a + (rg + RS * i) * LDP + r);
        fma4(acc[i], 4 * h, av, bv);
      }
    }
  }
}

// Column sums of rows [row0, row1) of HD columns of an fp32 matrix whose
// rows are LD floats apart, each row times 1 / div[r] when `div` is not
// null, into sum[0..HD) in shared memory;
// `scratch` is shared memory for THREADS * 4 floats. A thread reads 4
// columns of a row with one 16-byte load, HD / 4 threads a row, and keeps
// DEPTH loads in flight: a sum over many rows is bound by memory latency,
// not by instructions. Ends with a barrier, so `sum` is ready for every
// thread.
template <int THREADS, int DEPTH, int HD = 64, int LD = HD>
__device__ __forceinline__ void column_sums(float* sum, float* scratch,
                                            const float* __restrict__ src, int row0, int row1,
                                            const float* __restrict__ div) {
  constexpr int TPR = HD / 4;           // threads a row
  constexpr int STEP = THREADS / TPR;  // rows read at once by the block
  const int c4 = (threadIdx.x % TPR) * 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add = [&](const float4& x, float w) {
    acc.x = fmaf(x.x, w, acc.x);
    acc.y = fmaf(x.y, w, acc.y);
    acc.z = fmaf(x.z, w, acc.z);
    acc.w = fmaf(x.w, w, acc.w);
  };
  int r = row0 + (threadIdx.x / TPR);
  for (; r + (DEPTH - 1) * STEP < row1; r += DEPTH * STEP) {
    float4 raw[DEPTH];
    float w[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      raw[u] = *reinterpret_cast<const float4*>(src + (size_t)(r + u * STEP) * LD + c4);
      w[u] = div ? div[r + u * STEP] : 1.f;
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) add(raw[u], div ? 1.f / w[u] : 1.f);
  }
  for (; r < row1; r += STEP)
    add(*reinterpret_cast<const float4*>(src + (size_t)r * LD + c4), div ? 1.f / div[r] : 1.f);
  reinterpret_cast<float4*>(scratch)[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < HD) {
    float total = 0.f;
    for (int g = 0; g < STEP; ++g) total += scratch[g * HD + threadIdx.x];
    sum[threadIdx.x] = total;
  }
  __syncthreads();
}

}  // namespace f32
