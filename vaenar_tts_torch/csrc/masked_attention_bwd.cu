// Masked multi-head attention, backward, the dQ kernel, fp32 FMAs, for
// sm_90a. Plain C interface, bound from Python with ctypes
// (vaenar_tts_torch/ops/flash_attention.py, masked_flash_attention_backward).
// fp32 only: bf16 takes the tensor-core dQ kernel,
// masked_attention_bwd_dq_tc.cu (which also forms delta). The fp32 dK/dV
// kernel is masked_attention_bwd_dkv.cu, launched after this one.
//
// Replaces _dq_kernel of vaenar_tts_tpu/ops/flash_attention.py (l.320,
// pallas_call l.442; grid batch, head, q-block, k-block, dQ accumulated over
// the k-blocks) for fp32 inputs. Here each block owns its 64 rows of dQ and
// loops over the key tiles inside the block, so nothing is carried between
// blocks and nothing is atomic.
//
// Contract of the backward kernels (the forward's, masked_attention_fwd.cu):
// logits = q.k^T * scale; mask = row < q_len[b] && col < m_len[b]
// (&& col <= row when causal); masked logits are NEG = -2^32+1. From the
// forward's row stats (max m, sum s) and delta = rowsum(dO * O) (computed by
// the wrapper):
//   P  = exp(where(mask, logits, NEG) - m) / s
//   dV = P^T . dO                       (unmasked: every row of P counts)
//   dS = where(mask, P * (dO.V^T - delta), 0)
//   dQ = dS . K * scale,   dK = dS^T . Q * scale
// fp32 inputs, arithmetic, accumulators and outputs. Null length pointers
// mean full lengths. Rows past Tq and keys past Tk do not exist in the math
// and contribute nothing.
//
// The masked rows, and why the kernels can skip most of the work exactly:
//   * a row with nothing unmasked (row >= q_len, or every row when
//     m_len == 0) has m = NEG and s = Tk, so P = 1/s on all of its Tk keys,
//     keys past m_len included. Its dS is 0, so it adds nothing to dQ or dK,
//     but it adds dO_row / s_row to EVERY row of dV (the dK/dV kernel sums
//     those rows' dO / s once per block);
//   * a row with an unmasked key has m = a real logit, so its masked terms
//     are exp(NEG - m) = 0 exactly in fp32: keys at or past m_len, and keys
//     past the row when causal, contribute nothing to any gradient. The dQ
//     loop stops at m_len (and at the tile's last valid row when causal).
//
// Design. 256 threads a block, 64 x 64 tiles in shared memory, rows padded
// to 65 floats against bank conflicts. Each
// thread owns a 4 x 4 piece of the 64 x 64 score tile (rows 4*(tid/16)+i,
// columns tid%16 + 16*j) and the same piece of its 64 x 64 output
// accumulator (columns are head-width indices there). dS goes through
// shared memory for the second product. The products are fp32 FMAs: the
// fp32 path must match the fp32 reference, which TF32 tensor cores would
// not.
//
// What bounds it on an H100 at the training shapes (batch 32, H=4, D=64,
// text 32, reduced mel 240 at r = 2, of which 55-98 rows are valid): bytes,
// by the count in chip_smoke.py. An unmasked (row, key) pair costs 6*D
// operations, but with most rows padding, dQ written whole (zero rows
// included) and the rows read outweigh those pairs' fp32 FMAs about
// threefold. The kernel is far from either floor: a block runs its tiles one
// after another with no overlap of loads and products, on the SIMT units.

#include <math.h>

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int HD = 64;         // head width
constexpr int THREADS = 256;
constexpr int PAD = HD + 1;    // row stride (floats) of every shared tile
constexpr float NEG = -4294967295.0f;  // -2^32+1, rounds to -2^32 as in fp32 JAX
// dQ: Q, dO, K, V, dS tiles
constexpr size_t DQ_SMEM_BYTES = sizeof(float) * (5 * 64 * PAD);

// rows [row0, row0 + 64) of a [T, HD] matrix into a padded tile; rows at
// or past `rows_end` are zero
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int row0, int rows_end) {
  for (int idx = threadIdx.x; idx < 64 * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    dst[r * PAD + d] = row0 + r < rows_end ? src[(size_t)(row0 + r) * HD + d] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
masked_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const int* __restrict__ q_len,
                               const int* __restrict__ m_len,
                               const float* __restrict__ m_in,
                               const float* __restrict__ s_in,
                               const float* __restrict__ delta_in,
                               float* __restrict__ dq, int H, int Tq, int Tk,
                               float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][PAD]
  float* sDO = sQ + BQ * PAD;   // [BQ][PAD]
  float* sK = sDO + BQ * PAD;   // [BK][PAD]
  float* sV = sK + BK * PAD;    // [BK][PAD]
  float* sDS = sV + BK * PAD;   // [BQ][PAD]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;    // b * H + h
  const int b = bh / H;
  const int q0 = blockIdx.y * BQ;
  const int q_rows = min(BQ, Tq - q0);
  const int mlen = max(0, min(m_len ? m_len[b] : Tk, Tk));
  // rows below valid_end have an unmasked key; the others have dQ = 0
  const int valid_end = mlen > 0 ? max(0, min(q_len ? q_len[b] : Tq, Tq)) : 0;
  const size_t q_base = (size_t)bh * Tq * HD;
  const size_t k_base = (size_t)bh * Tk * HD;
  const size_t stat_base = (size_t)bh * Tq;

  const int rg = tid / 16;     // rows 4*rg .. 4*rg+3
  const int cg = tid % 16;     // columns cg + 16*j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int rows_end = min(q0 + q_rows, valid_end);
  int k_end = q0 < valid_end ? mlen : 0;
  if (causal) k_end = min(k_end, rows_end);

  float row_m[4], row_s[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    const bool in = row < rows_end;
    row_m[i] = in ? m_in[stat_base + row] : 0.f;
    row_s[i] = in ? s_in[stat_base + row] : 1.f;
    row_delta[i] = in ? delta_in[stat_base + row] : 0.f;
  }
  if (k_end > 0) {
    load_tile(sQ, q + q_base, q0, q0 + q_rows);
    load_tile(sDO, dout + q_base, q0, q0 + q_rows);
  }

  for (int kt = 0; kt < k_end; kt += BK) {
    __syncthreads();  // the previous tile's K and dS are no longer read
    load_tile(sK, k + k_base, kt, Tk);
    load_tile(sV, v + k_base, kt, Tk);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(rg * 4 + i) * PAD + d];
        ov[i] = sDO[(rg * 4 + i) * PAD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(cg + 16 * j) * PAD + d];
        vv[j] = sV[(cg + 16 * j) * PAD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt + cg + 16 * j;
        const bool unmasked = row < rows_end && col < mlen && (!causal || col <= row);
        float ds = 0.f;
        if (unmasked) {
          const float p = expf(sc[i][j] * scale - row_m[i]) / row_s[i];
          ds = p * (dp[i][j] - row_delta[i]);
        }
        sDS[(rg * 4 + i) * PAD + cg + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(rg * 4 + i) * PAD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[c * PAD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (r >= q_rows) continue;
    const size_t off = q_base + (size_t)(q0 + r) * HD;
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[off + cg + 16 * j] = acc[i][j] * scale;
  }
}

// above 48 KB of dynamic shared memory a kernel needs an explicit opt-in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* q_len, const void* m_len, const void* m,
                      const void* s, const void* delta, void* dq, int B, int H,
                      int Tq, int Tk, float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;
  cudaError_t err = allow_smem(masked_attention_bwd_dq_kernel, DQ_SMEM_BYTES, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  masked_attention_bwd_dq_kernel<<<grid, THREADS, DQ_SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const int*>(q_len),
      static_cast<const int*>(m_len), static_cast<const float*>(m),
      static_cast<const float*>(s), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Tq, int Tk, int D) {
  return D != HD || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 ||
         (Tq + BQ - 1) / BQ > 65535 || (Tk + BK - 1) / BK > 65535;
}

}  // namespace

// q, dout: contiguous fp32 [B, H, Tq, 64]; k, v: fp32 [B, H, Tk, 64].
// q_len, m_len: int32 [B] or null. m, s, delta: fp32 [B, H, Tq] (the
// forward's row max and row sum, and rowsum(dO * O)). dq like q. Returns the
// CUDA error code of the launch.
extern "C" int masked_attention_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* q_len,
                                       const void* m_len, const void* m, const void* s,
                                       const void* delta, void* dq, int B, int H,
                                       int Tq, int Tk, int D, float scale, int causal,
                                       void* stream) {
  if (bad_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  return (int)launch_dq(q, k, v, dout, q_len, m_len, m, s, delta, dq, B, H, Tq, Tk, scale,
                        causal, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory each block asks for, in bytes.
extern "C" int masked_attention_bwd_dq_shared_bytes(void) { return (int)DQ_SMEM_BYTES; }
