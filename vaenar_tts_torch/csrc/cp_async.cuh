// Asynchronous global-to-shared copies (cp.async), named barriers and index
// arithmetic, shared by the attention kernels of both dtypes: the bf16
// tensor-core kernels (wgmma_bf16.cuh) and the fp32 ones (tile_f32.cuh).

#pragma once

#include <stdint.h>

namespace cpa {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy from global to shared memory; writes zeros and
// reads nothing when `pred` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// log2 of a power of two: index arithmetic by shifts and masks, as on signed
// ints a division and a modulo take more instructions
__host__ __device__ constexpr int log2i(int n) {
  int k = 0;
  while (n > 1) {
    n >>= 1;
    ++k;
  }
  return k;
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads: one warp
// group of a block waits for itself alone.
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace cpa
