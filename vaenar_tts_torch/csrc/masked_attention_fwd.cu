// Masked multi-head attention, forward, for sm_90a, fp32 only. Plain C
// interface, bound from Python with ctypes
// (vaenar_tts_torch/ops/flash_attention.py). bf16 takes the tensor-core
// forward, masked_attention_fwd_tc.cu.
//
// Replaces the two forward Pallas kernels of
// vaenar_tts_tpu/ops/flash_attention.py:
//   _fwd_kernel          (single pass with K and V resident, launched by
//                         _pallas_forward)
//   _fwd_kernel_blocked  (online softmax over k-blocks, launched by
//                         _pallas_forward_blocked when Tk > 4096)
// One online-softmax kernel serves both: the 4096 split was a TPU VMEM budget
// and has no counterpart here.
//
// Contract (same as the Pallas kernels): logits = q.k^T * scale; the mask is
// row < q_len[b] && col < m_len[b] (&& col <= row when causal); masked logits
// become NEG = -2^32+1, not -inf, and the running max starts at NEG, so a row
// with nothing unmasked comes out uniform over the Tk keys (o = mean(v),
// m = NEG, s = Tk). fp32 inputs, softmax and accumulators; o is fp32 and the
// row stats m (max) and s (sum of exp) fp32 [B, H, Tq].
// Null length pointers mean full lengths. Columns past Tk do not exist and
// contribute nothing; rows past Tq are not written.
//
// Design. One block of 256 threads takes one (b, h) and 64 query rows. It
// walks the keys in tiles of 64 held in shared memory. Each thread owns a
// 4 x 4 piece of the 64 x 64 score tile (rows 4*(tid/16)+i, columns
// tid%16 + 16*j) and the same piece of the 64 x 64 output accumulator
// (columns are head-width indices there). Row max and row
// sum are reduced over the 16 lanes that share a row with warp shuffles; the
// probabilities go through shared memory (reusing the K tile) for P.V. The
// products are plain fp32 FMAs: the fp32 path must match the fp32 reference
// to 1e-4, which TF32 tensor cores would not.
//
// Work skipped without changing the result:
//   * rows at or past q_len (all rows when m_len == 0) are fully masked; the
//     block writes mean(v), NEG and Tk for them from one pass over V,
//     without forming any logit (the same values, summed in another order);
//   * for the other rows the key loop stops at m_len and, when causal, at
//     the tile's last valid row: each skipped term is exp(NEG - m) with m a
//     real logit, which is exactly 0 in fp32.
//
// What bounds it on an H100 at the shipped shapes (B=4, H=4, D=64, text 160,
// reduced mel 1680): operations. A causal 1680 x 1680 self-attention needs
// about 4*D*Tq*Tk/2*B*H = 5.8 GFLOP against 28 MB of q, k, v and o: 86 us at
// the 67 TFLOP/s fp32 (non-tensor) peak against 8 us of bytes at 3.35 TB/s;
// the 1680 x 160 cross-attention needs 1.1 GFLOP (16 us) against 15 MB
// (5 us). The kernel's own ceiling is the fp32 FMA rate, and its inner
// product is limited by shared-memory loads (8 per 16 FMAs).

#include <math.h>

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per shared-memory tile
constexpr int HD = 64;         // head width
constexpr int THREADS = 256;
constexpr int PAD = HD + 1;    // row stride (floats) of the Q and K/P tiles
constexpr float NEG = -4294967295.0f;  // -2^32+1, rounds to -2^32 as in fp32 JAX
constexpr size_t SMEM_BYTES = sizeof(float) * (BQ * PAD + BK * PAD + BK * HD);

__global__ void __launch_bounds__(THREADS)
masked_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int* __restrict__ q_len,
                            const int* __restrict__ m_len,
                            float* __restrict__ o, float* __restrict__ m_out,
                            float* __restrict__ s_out, int H, int Tq, int Tk,
                            float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][PAD]
  float* sK = sQ + BQ * PAD;    // [BK][PAD]; holds P during P.V
  float* sV = sK + BK * PAD;    // [BK][HD]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;    // b * H + h
  const int b = bh / H;
  const int q0 = blockIdx.y * BQ;
  const int q_rows = min(BQ, Tq - q0);
  const int qlen = q_len ? q_len[b] : Tq;
  const int mlen = m_len ? m_len[b] : Tk;
  const size_t q_base = (size_t)bh * Tq * HD;
  const size_t k_base = (size_t)bh * Tk * HD;
  const size_t stat_base = (size_t)bh * Tq;

  const bool has_valid_rows = mlen > 0 && q0 < qlen;
  if (!has_valid_rows || q0 + q_rows > qlen) {
    // Rows >= q_len (every row when m_len <= 0) are fully masked: uniform
    // attention over the Tk keys, o = mean(v), m = NEG, s = Tk. Written here
    // from a sum over V alone; the loop below serves only the other rows.
    constexpr int PARTS = THREADS / HD;
    const int d = tid % HD;
    const float* vcol = v + k_base + d;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // independent chains
    int j = tid / HD;
    for (; j + 3 * PARTS < Tk; j += 4 * PARTS) {
      a0 += vcol[(size_t)j * HD];
      a1 += vcol[(size_t)(j + PARTS) * HD];
      a2 += vcol[(size_t)(j + 2 * PARTS) * HD];
      a3 += vcol[(size_t)(j + 3 * PARTS) * HD];
    }
    for (; j < Tk; j += PARTS) a0 += vcol[(size_t)j * HD];
    smem[tid] = (a0 + a1) + (a2 + a3);
    __syncthreads();
    if (tid < HD) {
      float total = 0.f;
      for (int p = 0; p < PARTS; ++p) total += smem[p * HD + tid];
      smem[tid] = total / (float)Tk;
    }
    __syncthreads();
    const int first = has_valid_rows ? qlen - q0 : 0;  // first masked row of the tile
    for (int idx = first * HD + tid; idx < q_rows * HD; idx += THREADS) {
      o[q_base + (size_t)(q0 + idx / HD) * HD + idx % HD] = smem[idx % HD];
    }
    for (int r = first + tid; r < q_rows; r += THREADS) {
      m_out[stat_base + q0 + r] = NEG;
      s_out[stat_base + q0 + r] = (float)Tk;
    }
    if (!has_valid_rows) return;
    __syncthreads();  // shared memory is reused below
  }

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    sQ[r * PAD + d] = r < q_rows ? q[q_base + (size_t)(q0 + r) * HD + d] : 0.f;
  }

  // Valid rows see no key at or past m_len, nor past the diagonal when
  // causal: those terms are exp(NEG - m) = 0 exactly, so the loop stops there.
  const int rows_end = min(q0 + q_rows, qlen);
  int k_end = min(Tk, mlen);
  if (causal) k_end = min(k_end, rows_end);

  const int rg = tid / 16;     // rows 4*rg .. 4*rg+3
  const int cg = tid % 16;     // columns cg + 16*j
  float acc[4][4];
  float row_max[4], row_sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_max[i] = NEG;
    row_sum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < k_end; kt += BK) {
    __syncthreads();  // the previous tile's P and V are no longer read
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int r = idx / HD, d = idx % HD;
      const int key = kt + r;
      const bool in = key < Tk;
      sK[r * PAD + d] = in ? k[k_base + (size_t)key * HD + d] : 0.f;
      sV[r * HD + d] = in ? v[k_base + (size_t)key * HD + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * PAD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(cg + 16 * j) * PAD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      const bool row_ok = row < qlen;
      float tile_max = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt + cg + 16 * j;
        float x;
        if (col >= Tk) {
          x = -INFINITY;  // past the keys: no term at all
        } else if (row_ok && col < mlen && (!causal || col <= row)) {
          x = sc[i][j] * scale;
        } else {
          x = NEG;
        }
        sc[i][j] = x;
        tile_max = fmaxf(tile_max, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(row_max[i], tile_max);
      const float alpha = expf(row_max[i] - m_new);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        part += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      row_sum[i] = row_sum[i] * alpha + part;
      row_max[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every thread is done reading K
    float* sP = sK;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(rg * 4 + i) * PAD + cg + 16 * j] = sc[i][j];
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(rg * 4 + i) * PAD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = sV[kk * HD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (q0 + r >= rows_end) continue;  // past Tq, or written above as masked
    const size_t row_off = q_base + (size_t)(q0 + r) * HD;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[row_off + cg + 16 * j] = acc[i][j] / row_sum[i];
    if (cg == 0) {
      m_out[stat_base + q0 + r] = row_max[i];
      s_out[stat_base + q0 + r] = row_sum[i];
    }
  }
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_len, const void* m_len, void* o, void* m,
                   void* s, int B, int H, int Tq, int Tk, float scale,
                   int causal, cudaStream_t stream) {
  static bool smem_set = false;  // above 48 KB needs an explicit opt-in
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_attention_fwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  masked_attention_fwd_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_len),
      static_cast<const int*>(m_len), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(s), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: contiguous fp32 [B, H, T, 64]; q_len, m_len: int32 [B] or null;
// o like q; m, s: fp32 [B, H, Tq]. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* q_len, const void* m_len,
                                    void* o, void* m, void* s, int B, int H,
                                    int Tq, int Tk, int D, float scale,
                                    int causal, void* stream) {
  if (D != HD || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 ||
      (Tq + BQ - 1) / BQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, scale, causal,
                     static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory each block of masked_attention_fwd asks for, in bytes
// (ptxas -v reports static shared memory only).
extern "C" int masked_attention_fwd_shared_bytes(void) { return (int)SMEM_BYTES; }
