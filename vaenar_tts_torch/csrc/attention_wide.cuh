// The wide attention kernels' launchers: every head width D above 256 that
// is a multiple of 128, taken at run time, bf16 in masked_attention_wide_tc.cu
// and fp32 in masked_attention_wide.cu, and the fp32 forward at D = 128 and
// above (fwd_f32, masked_attention_fwd_3xtf32.cu). The C entry points of
// the D = 64, 128 and 256 kernels (masked_attention_fwd*.cu,
// masked_attention_bwd*.cu) send those widths here; the arguments are
// theirs, in their order.

#pragma once

#include <cuda_runtime.h>

namespace wide {

// D > 256 and a multiple of 128: a width the wide kernels take
inline bool takes(int D) { return D > 256 && D % 128 == 0; }

// Set a wide kernel's dynamic shared memory above 48 KB once; its first
// launch does it, before any CUDA graph captures a launch.
template <typename Kernel>
inline cudaError_t opt_in(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

// Ranks a q-block's key tiles are split over, in a forward that splits
// them over a cluster (masked_attention_fwd_3xtf32.cu, the bf16 forward of
// masked_attention_wide_tc.cu): doubled while the grid of `blocks` blocks
// stays within two waves (a wave: `blocks_an_sm` blocks on each SM) and
// each rank keeps `min_tiles` of the q-block's `tiles` key tiles (a long
// row of keys in a small grid, where one block's chain of tiles would set
// the time), up to `max_ranks`; the SMs are the current device's.
// scripts/torch_fwd_3xtf32_ablation.py mirrors this rule to report each
// site's ranks
inline int key_ranks(int blocks, int tiles, int max_ranks, int min_tiles, int blocks_an_sm) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int ranks = 1;
  while (2 * ranks <= max_ranks && blocks * 2 * ranks <= 2 * sms * blocks_an_sm &&
         tiles >= min_tiles * 2 * ranks)
    ranks *= 2;
  return ranks;
}

// Column sums of rows [row0, row1) of COLS columns of an fp32 matrix whose
// rows are ld floats apart, each row times 1 / div[r] when `div` is not
// null, into sum[0..COLS); `scratch` is shared memory for THREADS * 4
// floats (f32::column_sums with a run-time row stride). Ends with a
// barrier.
template <int THREADS, int COLS = 128>
__device__ __forceinline__ void slice_sums(float* sum, float* scratch,
                                           const float* __restrict__ src, int ld, int row0,
                                           int row1, const float* __restrict__ div) {
  constexpr int DEPTH = 8;             // loads in flight a thread
  constexpr int TPR = COLS / 4;        // threads a row
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
      raw[u] = *reinterpret_cast<const float4*>(src + (size_t)(r + u * STEP) * ld + c4);
      w[u] = div ? div[r + u * STEP] : 1.f;
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) add(raw[u], div ? 1.f / w[u] : 1.f);
  }
  for (; r < row1; r += STEP)
    add(*reinterpret_cast<const float4*>(src + (size_t)r * ld + c4), div ? 1.f / div[r] : 1.f);
  reinterpret_cast<float4*>(scratch)[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < COLS) {
    float total = 0.f;
    for (int g = 0; g < STEP; ++g) total += scratch[g * COLS + threadIdx.x];
    sum[threadIdx.x] = total;
  }
  __syncthreads();
}

cudaError_t fwd_tc(const void* q, const void* k, const void* v, const void* q_len,
                   const void* m_len, void* o, void* m, void* s, int B, int H, int Tq, int Tk,
                   int D, float scale, int causal, cudaStream_t stream);
cudaError_t dq_tc(const void* q, const void* k, const void* v, const void* dout, const void* o,
                  const void* q_len, const void* m_len, const void* m, const void* s,
                  void* delta, void* dq, int B, int H, int Tq, int Tk, int D, float scale,
                  int causal, cudaStream_t stream);
cudaError_t dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                   const void* q_len, const void* m_len, const void* m, const void* s,
                   const void* delta, void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
                   float scale, int causal, cudaStream_t stream);

// D = 128 and 256 too (masked_attention_fwd_3xtf32.cu)
cudaError_t fwd_f32(const void* q, const void* k, const void* v, const void* q_len,
                    const void* m_len, void* o, void* m, void* s, int B, int H, int Tq, int Tk,
                    int D, float scale, int causal, cudaStream_t stream);
cudaError_t dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* o,
                   const void* q_len, const void* m_len, const void* m, const void* s,
                   void* delta, void* dq, int B, int H, int Tq, int Tk, int D, float scale,
                   int causal, cudaStream_t stream);
cudaError_t dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                    const void* q_len, const void* m_len, const void* m, const void* s,
                    const void* delta, void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
                    float scale, int causal, cudaStream_t stream);

}  // namespace wide
