// Building blocks of the bf16 tensor-core attention kernels: 64 x 64 bf16
// tiles in shared memory, filled with cp.async, read with ldmatrix, and
// multiplied with mma.sync.m16n8k16 into fp32 accumulators, as the dQ kernel
// (masked_attention_bwd_dq_tc.cu) does; the forward and dK/dV kernels
// multiply with wgmma (wgmma_bf16.cuh) and take NEG, split_bf16 and the
// cp.async helpers from here.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16" for .bf16), for lane l of a warp,
// g = l / 4 and c = 2 * (l % 4):
//   A (16 x 16, row-major):  a0 = A[g][c, c+1],   a1 = A[g+8][c, c+1],
//                            a2 = A[g][c+8, c+9], a3 = A[g+8][c+8, c+9]
//   B (16 x 8, B[k][n]):     b0 = B[c, c+1][g],   b1 = B[c+8, c+9][g]
//   C (16 x 8, fp32):        c0, c1 = C[g][c, c+1],  c2, c3 = C[g+8][c, c+1]
// The C layout of two neighbouring 16 x 8 tiles is the A layout of one
// 16 x 16 tile, so a product's result feeds the next product's A operand
// from registers (P in P.V, P^T and dS^T in the backward), split into two
// bf16 parts (a_split_from_acc).

#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int TILE_ROWS = 64;  // rows of a tile (query rows or keys)
constexpr int HD = 64;         // head width: the columns of a tile
// Row stride of a shared tile in bf16 elements: 144 bytes, so the 8 rows an
// ldmatrix reads at one column fall into 8 different 16-byte bank groups.
constexpr int LDS = HD + 8;
constexpr int TILE_ELEMS = TILE_ROWS * LDS;
constexpr float NEG = -4294967295.0f;  // -2^32+1, rounds to -2^32 as in fp32 JAX

using cpa::cp_async16;
using cpa::cp_async_commit;
using cpa::cp_async_wait;
using cpa::group_sync;
using cpa::smem_addr;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores: bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values split into bf16 pairs hi + lo, each packed with the first
// value in the low half: hi = bf16(x), lo = bf16(x - hi). hi + lo keeps
// about 16 bits of x (relative error <= 2^-17), where hi alone keeps 8.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The A fragments (hi and lo parts) of columns [16 s, 16 s + 16) of a
// 16 x 64 fp32 C tile held as acc[8][4] (8 tiles of 16 x 8): P in P.V,
// P^T and dS^T in the backward. a . b = hi . b + lo . b, two products.
__device__ __forceinline__ void a_split_from_acc(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                                 const float (&acc)[8][4], int s) {
  split_bf16(acc[2 * s][0], acc[2 * s][1], hi[0], lo[0]);
  split_bf16(acc[2 * s][2], acc[2 * s][3], hi[1], lo[1]);
  split_bf16(acc[2 * s + 1][0], acc[2 * s + 1][1], hi[2], lo[2]);
  split_bf16(acc[2 * s + 1][2], acc[2 * s + 1][3], hi[3], lo[3]);
}

// Rows [row0, row0 + 64) of a [T, 64] bf16 matrix into a shared tile, as
// asynchronous copies by THREADS threads numbered `tid` (16 bytes a thread,
// 8 a row); rows at or past `rows_end` become zeros.
template <int THREADS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src,
                                                int row0, int rows_end, int tid) {
#pragma unroll
  for (int chunk = tid; chunk < TILE_ROWS * 8; chunk += THREADS) {
    const int r = chunk >> 3, col = (chunk & 7) * 8;
    const bool in = row0 + r < rows_end;
    cp_async16(dst + r * LDS + col, in ? src + (size_t)(row0 + r) * HD + col : src, in);
  }
}

// This warp's 16 rows of a 16 x 64 fp32 C tile, times `mul_lo` (row g) and
// `mul_hi` (row g + 8), into rows [row0, row0 + 16) of a shared bf16 tile.
__device__ __forceinline__ void stage_acc(bf16* tile, const float (&acc)[8][4], int row0,
                                          float mul_lo, float mul_hi) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + (lane >> 2), c = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(tile + r * LDS + j * 8 + c) =
        __floats2bfloat162_rn(acc[j][0] * mul_lo, acc[j][1] * mul_lo);
    *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * LDS + j * 8 + c) =
        __floats2bfloat162_rn(acc[j][2] * mul_hi, acc[j][3] * mul_hi);
  }
}

// Column sums of rows [row0, row1) of a [T, 64] bf16 matrix, in fp32, each
// row divided by div[r] when `div` is not null, into sum[0..64) in shared
// memory; `scratch` is shared memory for THREADS * 8 floats. Each thread
// reads 8 columns of a row with one 16-byte load, 8 threads a row, and keeps
// 4 loads in flight: the sum over many rows is bound by memory latency, not
// by instructions. Ends with a barrier, so `sum` is ready for every thread.
template <int THREADS>
__device__ __forceinline__ void column_sums(float* sum, float* scratch,
                                            const bf16* __restrict__ src, int row0, int row1,
                                            const float* __restrict__ div) {
  constexpr int STEP = THREADS / 8;  // rows read at once by the block
  const int c8 = (threadIdx.x & 7) * 8;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  auto add = [&](int r, const uint4& raw) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float inv = div ? 1.f / div[r] : 1.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += div ? f.x * inv : f.x;
      acc[2 * i + 1] += div ? f.y * inv : f.y;
    }
  };
  int r = row0 + (threadIdx.x >> 3);
  for (; r + 3 * STEP < row1; r += 4 * STEP) {
    uint4 raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      raw[u] = *reinterpret_cast<const uint4*>(src + (size_t)(r + u * STEP) * HD + c8);
#pragma unroll
    for (int u = 0; u < 4; ++u) add(r + u * STEP, raw[u]);
  }
  for (; r < row1; r += STEP) add(r, *reinterpret_cast<const uint4*>(src + (size_t)r * HD + c8));
#pragma unroll
  for (int i = 0; i < 8; ++i) scratch[(threadIdx.x >> 3) * HD + c8 + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < HD) {
    float total = 0.f;
    for (int g = 0; g < STEP; ++g) total += scratch[g * HD + threadIdx.x];
    sum[threadIdx.x] = total;
  }
  __syncthreads();
}

// Rows [0, rows) of a shared tile to rows [row0, row0 + rows) of a [T, 64]
// bf16 matrix, 16 bytes a thread.
template <int THREADS>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, const bf16* tile, int row0,
                                           int rows) {
  for (int chunk = threadIdx.x; chunk < rows * 8; chunk += THREADS) {
    const int r = chunk >> 3, col = (chunk & 7) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * HD + col) =
        *reinterpret_cast<const uint4*>(tile + r * LDS + col);
  }
}

}  // namespace tc
