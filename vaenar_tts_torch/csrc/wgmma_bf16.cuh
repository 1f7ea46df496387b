// Building blocks of the bf16 attention kernels, which multiply with
// Hopper's warp-group instructions (masked_attention_fwd_tc.cu,
// masked_attention_bwd_dq_tc.cu, masked_attention_bwd_dkv_tc.cu): tiles of
// 64 rows of HD bf16 (HD = 64, 128 or 256, the head width, or a slice of it)
// in shared memory, each HD / 64 panels of 64 x 64 in wgmma's
// 128-byte-swizzled layout, filled
// with cp.async (16 bytes a thread), read by wgmma.mma_async m64nNk16 (bf16
// in, fp32 accumulate) through matrix descriptors, with the A operand from
// shared memory or from registers. A warp group is 4 warps (128 threads)
// whose first warp is a multiple of 4; all of its threads issue each
// product together.
//
// Tile layout: a panel holds 64 rows of 64 bf16 (128 bytes, 8 chunks of 16
// bytes), rows one after the other, and stores chunk c of row r at chunk
// c ^ (r & 7); a panel starts on a 1024-byte boundary. That is wgmma's
// canonical 128-byte swizzle: read as a K-major operand (rows = M or N, the
// head width = K) or, for B, as an MN-major one (rows = K, the head width =
// N), and the 8 rows that one 16-byte column of reads touches fall into 8
// different bank groups. A row of 128 bf16 is 256 bytes, two swizzle atoms
// wide: a D = 128 tile is two panels one after the other, columns 0-63 in
// the first and 64-127 in the second, so each panel is read through a
// descriptor of its own (PANEL_DESC further on), never one descriptor
// spanning both: a product over K = 128 runs 4 k-steps on each panel, and
// one with N = 128 (O = P.V, dQ = dS.K, dV and dK) runs as two products of
// N = 64 into the two halves of its accumulator. A D = 256 tile is four
// panels; a block there owns a slice of 128 output columns (two panels),
// and the tile loaders and the store take a row stride LD apart from the
// columns they move, so that a slice is read from and written to its place
// in a [T, 256] row.
//
// Fragments (PTX ISA, "wgmma .m64nNk16"), thread t of the group, warp
// w = t / 32, lane l, g = l / 4, c = 2 * (l % 4):
//   D (64 x N, fp32), d[j][e] for j < N / 8:
//     d[j][0..1] = D[16 w + g][8 j + c, +1],
//     d[j][2..3] = D[16 w + g + 8][8 j + c, +1];
//   A from registers (64 x 16, bf16): warp w holds rows 16 w .. 16 w + 15,
//     a0 = A[g][c, c+1], a1 = A[g+8][c, c+1], a2 = A[g][c+8, c+9],
//     a3 = A[g+8][c+8, c+9] (each a bf16 pair, the first value in the low
//     half).
// So columns [16 s, 16 s + 16) of one product's D are the A operand of the
// next product's k-step s, split into bf16 hi + lo parts (a_split).

#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace tc {

using bf16 = __nv_bfloat16;

constexpr float NEG = -4294967295.0f;  // -2^32+1, rounds to -2^32 as in fp32 JAX

using cpa::cp_async16;
using cpa::cp_async_commit;
using cpa::cp_async_wait;
using cpa::group_sync;
using cpa::smem_addr;

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

}  // namespace tc

namespace wg {

using tc::bf16;
using tc::NEG;

constexpr int ROWS = 64;                  // rows of a tile
constexpr int PANEL = 64;                 // columns of a panel
constexpr int TILE_ELEMS = ROWS * PANEL;  // a panel: 8 KB of bf16
constexpr int ALIGN = 1024;               // a panel's alignment in shared memory
// a panel's size in a matrix descriptor's start-address units (16 bytes):
// the descriptor of panel p is desc(tile) + p * PANEL_DESC
constexpr uint64_t PANEL_DESC = TILE_ELEMS * sizeof(bf16) / 16;

// Elements of a tile of HD columns.
template <int HD>
__host__ __device__ constexpr int tile_elems() { return ROWS * HD; }

// The output columns a block computes at head width HD: all of them, or at
// D = 256 a slice of 128 (the grid has an axis over the HD / 128 slices),
// so that a block's accumulators stay D = 128's.
template <int HD>
__host__ __device__ constexpr int slice_width() { return HD > 128 ? 128 : HD; }

// The element offset of chunk c (8 bf16; c < HD / 8) of row r in a swizzled
// tile: chunk c % 8 of panel c / 8.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * TILE_ELEMS + r * PANEL + (((c & 7) ^ (r & 7)) << 3);
}

// The first ALIGN-byte boundary at or after the dynamic shared memory's
// start; a kernel asks for ALIGN bytes more than it lays out.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((ALIGN - (tc::smem_addr(raw) & (ALIGN - 1))) & (ALIGN - 1));
}

// Rows [row0, row0 + 64) of HD columns of a bf16 matrix whose rows are LD
// elements apart into a swizzled tile, as asynchronous copies by THREADS
// threads numbered `tid`; rows at or past `rows_end` become zeros.
template <int THREADS, int HD, int LD = HD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src,
                                                int row0, int rows_end, int tid) {
  constexpr int CHUNKS = HD / 8, SHIFT = cpa::log2i(CHUNKS);  // 16-byte chunks a row
#pragma unroll
  for (int chunk = tid; chunk < ROWS * CHUNKS; chunk += THREADS) {
    const int r = chunk >> SHIFT, c = chunk & (CHUNKS - 1);
    const bool in = row0 + r < rows_end;
    tc::cp_async16(dst + swz(r, c), in ? src + (size_t)(row0 + r) * LD + c * 8 : src, in);
  }
}

// 4-byte asynchronous copy from global to shared memory (through L1).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(tc::smem_addr(dst)), "l"(src));
}

// 2^x, approximate (ex2.approx.ftz, as __expf uses it).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory written by threads (cp.async, stores) made visible to
// wgmma, which reads through the async proxy; each writing thread runs it
// before the barrier that precedes the products.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The matrix descriptor of a swizzled panel from its row 0: start address,
// leading byte offset 16 (unused by a 128-byte swizzle), stride byte offset
// 1024 (8 rows of 128 bytes), 128-byte swizzle. A K-major operand's k-step
// kk starts 32 * kk bytes in (desc + 2 * kk); an MN-major operand's k-step
// s, 16 rows down (desc + 128 * s).
__device__ __forceinline__ uint64_t desc(const bf16* tile) {
  const uint64_t addr = tc::smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the product's issue and wait.
template <int J>
__device__ __forceinline__ void fence_acc(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int J>
__device__ __forceinline__ void zero(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
}

// d += A . B for one k-step of 16, N = 16, 24, 32, 48 or 64, both operands from
// shared memory and K-major: A (64 x 16) by descriptor da, B (N x 16,
// row n = column n of B) by descriptor db.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 8][4], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void mma_ss<24>(float (&d)[3][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_ss<16>(float (&d)[2][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_ss<32>(float (&d)[4][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_ss<48>(float (&d)[6][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d[J0 .. J0 + 7] (columns 8 J0 .. 8 J0 + 63 of a D fragment) += A . B for
// one k-step of 16, N = 64: A (64 x 16) from registers, B (16 x 64) an
// MN-major panel by descriptor db.
template <int J0 = 0, int J = 8>
__device__ __forceinline__ void mma_rs64_mn(float (&d)[J][4], const uint32_t (&a)[4],
                                            uint64_t db) {
  static_assert(J0 + 8 <= J, "the product's 64 columns lie outside d");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[J0 + 0][0]), "+f"(d[J0 + 0][1]), "+f"(d[J0 + 0][2]), "+f"(d[J0 + 0][3]),
        "+f"(d[J0 + 1][0]), "+f"(d[J0 + 1][1]), "+f"(d[J0 + 1][2]), "+f"(d[J0 + 1][3]),
        "+f"(d[J0 + 2][0]), "+f"(d[J0 + 2][1]), "+f"(d[J0 + 2][2]), "+f"(d[J0 + 2][3]),
        "+f"(d[J0 + 3][0]), "+f"(d[J0 + 3][1]), "+f"(d[J0 + 3][2]), "+f"(d[J0 + 3][3]),
        "+f"(d[J0 + 4][0]), "+f"(d[J0 + 4][1]), "+f"(d[J0 + 4][2]), "+f"(d[J0 + 4][3]),
        "+f"(d[J0 + 5][0]), "+f"(d[J0 + 5][1]), "+f"(d[J0 + 5][2]), "+f"(d[J0 + 5][3]),
        "+f"(d[J0 + 6][0]), "+f"(d[J0 + 6][1]), "+f"(d[J0 + 6][2]), "+f"(d[J0 + 6][3]),
        "+f"(d[J0 + 7][0]), "+f"(d[J0 + 7][1]), "+f"(d[J0 + 7][2]), "+f"(d[J0 + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[J0 .. J0 + 7] += A . B for one k-step of 16, N = 64, both operands from
// shared memory: A (64 x 16) K-major by descriptor da, B (16 x 64) an
// MN-major panel by descriptor db (P . V with P shared by warp groups).
template <int J0 = 0, int J = 8>
__device__ __forceinline__ void mma_ss64_mn(float (&d)[J][4], uint64_t da, uint64_t db) {
  static_assert(J0 + 8 <= J, "the product's 64 columns lie outside d");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[J0 + 0][0]), "+f"(d[J0 + 0][1]), "+f"(d[J0 + 0][2]), "+f"(d[J0 + 0][3]),
        "+f"(d[J0 + 1][0]), "+f"(d[J0 + 1][1]), "+f"(d[J0 + 1][2]), "+f"(d[J0 + 1][3]),
        "+f"(d[J0 + 2][0]), "+f"(d[J0 + 2][1]), "+f"(d[J0 + 2][2]), "+f"(d[J0 + 2][3]),
        "+f"(d[J0 + 3][0]), "+f"(d[J0 + 3][1]), "+f"(d[J0 + 3][2]), "+f"(d[J0 + 3][3]),
        "+f"(d[J0 + 4][0]), "+f"(d[J0 + 4][1]), "+f"(d[J0 + 4][2]), "+f"(d[J0 + 4][3]),
        "+f"(d[J0 + 5][0]), "+f"(d[J0 + 5][1]), "+f"(d[J0 + 5][2]), "+f"(d[J0 + 5][3]),
        "+f"(d[J0 + 6][0]), "+f"(d[J0 + 6][1]), "+f"(d[J0 + 6][2]), "+f"(d[J0 + 6][3]),
        "+f"(d[J0 + 7][0]), "+f"(d[J0 + 7][1]), "+f"(d[J0 + 7][2]), "+f"(d[J0 + 7][3])
      : "l"(da), "l"(db), "r"(1));
}

// The A fragments (hi and lo parts) of k-step s, columns [16 s, 16 s + 16),
// of a 64 x 8J fp32 D fragment: P in P.V, P^T and dS^T in the backward.
// a . b = hi . b + lo . b, two products.
template <int J>
__device__ __forceinline__ void a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&d)[J][4], int s) {
  tc::split_bf16(d[2 * s][0], d[2 * s][1], hi[0], lo[0]);
  tc::split_bf16(d[2 * s][2], d[2 * s][3], hi[1], lo[1]);
  tc::split_bf16(d[2 * s + 1][0], d[2 * s + 1][1], hi[2], lo[2]);
  tc::split_bf16(d[2 * s + 1][2], d[2 * s + 1][3], hi[3], lo[3]);
}

// This thread's part of 64 columns of an fp32 D fragment, d[J0 .. J0 + 7],
// row g of its warp's 16 times `mul_lo` and row g + 8 times `mul_hi`, into a
// swizzled bf16 panel.
template <int J0 = 0, int J = 8>
__device__ __forceinline__ void stage_acc(bf16* tile, const float (&d)[J][4], float mul_lo,
                                          float mul_hi) {
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x & 127) / 32 * 16 + (lane >> 2), c = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(tile + swz(r, j) + c) =
        __floats2bfloat162_rn(d[J0 + j][0] * mul_lo, d[J0 + j][1] * mul_lo);
    *reinterpret_cast<__nv_bfloat162*>(tile + swz(r + 8, j) + c) =
        __floats2bfloat162_rn(d[J0 + j][2] * mul_hi, d[J0 + j][3] * mul_hi);
  }
}

// Rows [0, rows) of a swizzled tile of HD columns to rows [row0, row0 +
// rows) of a bf16 matrix whose rows are LD elements apart, 16 bytes a
// thread.
template <int THREADS, int HD, int LD = HD>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, const bf16* tile, int row0,
                                           int rows) {
  constexpr int CHUNKS = HD / 8, SHIFT = cpa::log2i(CHUNKS);
  for (int chunk = threadIdx.x; chunk < rows * CHUNKS; chunk += THREADS) {
    const int r = chunk >> SHIFT, c = chunk & (CHUNKS - 1);
    *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * LD + c * 8) =
        *reinterpret_cast<const uint4*>(tile + swz(r, c));
  }
}

// Column sums of rows [row0, row1) of HD columns of a bf16 matrix whose
// rows are LD elements apart, in fp32, each row divided by div[r] when
// `div` is not null, into sum[0..HD) in shared memory; `scratch` is shared
// memory for THREADS * 8 floats. HD / 8 threads a row, 16 bytes a load,
// DEPTH loads in flight a thread: the pass is bound by its rounds of loads.
// Ends with a barrier, so `sum` is ready for every thread.
template <int THREADS, int DEPTH, int HD, int LD = HD>
__device__ __forceinline__ void column_sums(float* sum, float* scratch,
                                            const bf16* __restrict__ src, int row0, int row1,
                                            const float* __restrict__ div) {
  constexpr int TPR = HD / 8;          // threads a row
  constexpr int STEP = THREADS / TPR;  // rows read at once by the block
  const int c8 = (threadIdx.x % TPR) * 8;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  auto add = [&](const uint4& raw, float inv) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x * inv;
      acc[2 * i + 1] += f.y * inv;
    }
  };
  for (int r = row0 + (threadIdx.x / TPR); r < row1; r += DEPTH * STEP) {
    uint4 raw[DEPTH];
    float inv[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const int ru = r + u * STEP;
      raw[u] = ru < row1 ? *reinterpret_cast<const uint4*>(src + (size_t)ru * LD + c8)
                         : make_uint4(0u, 0u, 0u, 0u);
      inv[u] = ru < row1 && div ? div[ru] : 1.f;
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) add(raw[u], div ? 1.f / inv[u] : 1.f);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) scratch[(threadIdx.x / TPR) * HD + c8 + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < HD) {
    float total = 0.f;
    for (int g = 0; g < STEP; ++g) total += scratch[g * HD + threadIdx.x];
    sum[threadIdx.x] = total;
  }
  __syncthreads();
}

}  // namespace wg
