// The wide attention kernels' launchers: every head width D above 256 that
// is a multiple of 128, taken at run time, bf16 in masked_attention_wide_tc.cu
// and fp32 in masked_attention_wide.cu. The C entry points of the D = 64,
// 128 and 256 kernels (masked_attention_fwd*.cu, masked_attention_bwd*.cu)
// send those widths here; the arguments are theirs, in their order.

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
