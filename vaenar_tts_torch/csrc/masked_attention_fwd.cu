// Masked multi-head attention, forward, fp32 FMAs, for sm_90a. Plain C
// interface, bound from Python with ctypes
// (vaenar_tts_torch/ops/flash_attention.py); fp32 q, k, v take this kernel
// at D = 64 and the 3xTF32 one (masked_attention_fwd_3xtf32.cu) at D = 128
// and above, bf16 ones masked_attention_fwd_tc.cu.
//
// Replaces the two forward Pallas kernels of
// vaenar_tts_tpu/ops/flash_attention.py for fp32 inputs:
//   _fwd_kernel          (l.104, pallas_call l.299)
//   _fwd_kernel_blocked  (l.142, pallas_call l.224; Tk > 4096)
// One online-softmax loop over 64-key tiles serves both: the 4096 split was
// a TPU VMEM budget and has no counterpart here.
//
// Contract (the Pallas kernels'): logits = q.k^T * scale; the mask is
// row < q_len[b] && col < m_len[b] (&& col <= row when causal); masked
// logits become NEG = -2^32+1, not -inf, and the running max starts at NEG,
// so a row with nothing unmasked comes out uniform over the Tk keys
// (o = mean(v), m = NEG, s = Tk). fp32 inputs, softmax, accumulators and
// outputs; m (row max) and s (row sum of exp) are fp32 [B, H, Tq]. Null
// length pointers mean full lengths. Columns past Tk do not exist; rows past
// Tq are not written.
//
// What bounds it on an H100 at the synthesis path's shapes (B=4, H=4, D=64,
// text 160, reduced mel 1680 of which 460-583 rows are valid): operations,
// 4*D fp32 FMA-operations per unmasked (row, key) at the 67 TFLOP/s of the
// SIMT units (a causal 1680 site: 0.57 GFLOP, 8.5 us, against 5.5 us of
// bytes). What held the first version back, and what this design
// does about it:
//   * every q-block of padding rows re-read all of V for mean(v), 4 bytes a
//     load: here one block of the (b, h) writes mean(v), NEG and Tk for all
//     of its padding rows, from one pass over V with 16-byte loads, 8 in
//     flight a thread (f32::column_sums), and the blocks are scheduled
//     last q-block first, so that writer and the longest causal chains
//     start first;
//   * each block ran its key tiles as a serial chain of synchronous loads
//     and four barriers a tile: here K and V tiles stream through a
//     two-stage cp.async ring (16-byte copies), the next tile loading while
//     this one multiplies, one barrier a tile; P is exchanged within a warp
//     (__syncwarp). When Tk > 512 a block takes two warp groups that split
//     the key tiles (even and odd), each with its own ring and named
//     barrier, and group 1 hands its (row max, row sum, o accumulator) to
//     group 0 through shared memory at the end, merged as the online softmax
//     merges two tiles: no second pass, no atomics;
//   * the products issued 8 scalar shared loads per 16 FMAs: here a thread
//     owns 8 x 4 of S and of O, read with 16-byte loads (f32::dots,
//     f32::accumulate; 12 loads per 128 FMAs, see tile_f32.cuh), and a tile
//     with at most 32 keys left computes only those. The count of those
//     loads still holds the products to about half of the fp32 FMA rate: a
//     tile takes ~4.7 us of an SM at 1024 x 4104 against 2.3 us at its full
//     FMA rate (PERF.md §6), and the causal sites' chains of up to 10 tiles
//     a block set their time.
// Softmax in base 2: log2(e) is folded into the scale, the running max is
// kept in log2 units and m is written back in natural units; a masked
// logit is NEG, and exp2(NEG - m) with m a real logit is exactly 0 in fp32.
//
// Work skipped without changing the result:
//   * rows at or past q_len (all rows when m_len == 0) are fully masked and
//     written by the one writer block from V alone;
//   * for the other rows the key loop stops at m_len and, when causal, at
//     the block's last valid row: each skipped term is exp(NEG - m) = 0.
//     Every valid row sees key 0, so its max is a real logit.
//
// Resources (ptxas -v; chip_smoke.py prints them): see PERF.md §6. Shared
// memory: Q and, for each group, a two-stage K/V ring and a P tile: 6 or 11
// tiles of 64 x 68 fp32, 104,448 or 191,488 bytes a block.

// Head widths. The kernel is compiled for D = 64 only. The C entry point
// sends D = 128, 256 and every multiple of 128 above to the 3xTF32
// tensor-core forward (masked_attention_fwd_3xtf32.cu, wide::fwd_f32): at
// D = 128 this design, the products at half the SIMT FMA rate on a chain
// of key tiles a block, lost to SDPA at 1024 x 4104 (PERF.md §6).

#include "attention_wide.cuh"
#include "tile_f32.cuh"

namespace {

using f32::GROUP_THREADS;
using f32::NEG;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int STAGES = 2;  // K/V tiles in a group's ring: one loads while one multiplies
// Keys above which a block takes two warp groups (as the bf16 kernel; a
// second group splits a long chain of key tiles and mostly idles on a short
// one)
constexpr int TWO_GROUPS_MIN_TK = 512;
// a group's K/V ring and P tile
template <int HD>
__host__ __device__ constexpr int group_floats() {
  return (2 * STAGES + 1) * f32::tile<HD>();
}

template <int HD, int GROUPS>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (f32::tile<HD>() + GROUPS * group_floats<HD>());
}

// Rows [pad0, Tq) of one (b, h): o = mean(v) over its Tk keys, m = NEG,
// s = Tk. `scratch` is shared memory for HD + 4 * THREADS floats.
template <int THREADS, int HD>
__device__ __forceinline__ void write_padding_rows(float* scratch, const float* __restrict__ v,
                                                   float* __restrict__ o,
                                                   float* __restrict__ m_out,
                                                   float* __restrict__ s_out, int pad0, int Tq,
                                                   int Tk) {
  constexpr int TPR = HD / 4;  // threads a row, 4 columns each
  float* sum = scratch;  // [HD]
  f32::column_sums<THREADS, 8, HD>(sum, scratch + HD, v, 0, Tk, nullptr);
  const int c4 = (threadIdx.x % TPR) * 4;
  const float n = (float)Tk;
  const float4 mean = make_float4(sum[c4] / n, sum[c4 + 1] / n, sum[c4 + 2] / n, sum[c4 + 3] / n);
  for (int r = pad0 + (threadIdx.x / TPR); r < Tq; r += THREADS / TPR)
    *reinterpret_cast<float4*>(o + (size_t)r * HD + c4) = mean;
  for (int r = pad0 + threadIdx.x; r < Tq; r += THREADS) {
    m_out[r] = NEG;
    s_out[r] = n;
  }
}

template <int HD, int GROUPS>
__global__ void __launch_bounds__(GROUPS * GROUP_THREADS)
masked_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int* __restrict__ q_len,
                            const int* __restrict__ m_len, float* __restrict__ o,
                            float* __restrict__ m_out, float* __restrict__ s_out, int H, int Tq,
                            int Tk, float scale, int causal) {
  constexpr int THREADS = GROUPS * GROUP_THREADS;
  constexpr int LDP = f32::ldp<HD>(), TILE = f32::tile<HD>(), GROUP_FLOATS = group_floats<HD>();
  constexpr int CW = HD / 16;  // accumulator columns a thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;  // [64][LDP]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  // the last q-block first: when causal its chain of key tiles is the longest
  const int qb = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int q0 = qb * BQ;
  const int q_rows = min(BQ, Tq - q0);
  const int qlen = q_len ? q_len[b] : Tq;
  const int klim = max(0, min(Tk, m_len ? m_len[b] : Tk));  // keys a valid row may see
  const size_t q_base = (size_t)bh * Tq * HD;
  const size_t k_base = (size_t)bh * Tk * HD;
  const size_t stat_base = (size_t)bh * Tq;

  // Rows below pad0 have an unmasked key (key 0); the others are uniform.
  const int pad0 = klim > 0 ? max(0, min(qlen, Tq)) : 0;
  const int rows_end = min(q0 + q_rows, pad0);  // valid rows of this block: [q0, rows_end)
  // Valid rows see no key at or past m_len, nor past the block's last valid
  // row when causal: those terms are exp(NEG - m) = 0 exactly.
  const int k_end = causal ? min(klim, rows_end) : klim;
  const int n_tiles = q0 < pad0 ? (k_end + BK - 1) / BK : 0;

  const int group = tid / GROUP_THREADS, gtid = tid % GROUP_THREADS;
  float* sK = sQ + TILE + group * GROUP_FLOATS;  // [STAGES][64][LDP]
  float* sV = sK + STAGES * TILE;                // [STAGES][64][LDP]
  float* sP = sV + STAGES * TILE;                // [64][LDP]
  // Q and each group's first tile, one commit group
  if (n_tiles > 0) {
    f32::load_tile_async<THREADS, HD>(sQ, q + q_base, q0, rows_end, tid);
    if (group < n_tiles) {
      f32::load_tile_async<GROUP_THREADS, HD>(sK, k + k_base, group * BK, k_end, gtid);
      f32::load_tile_async<GROUP_THREADS, HD>(sV, v + k_base, group * BK, k_end, gtid);
    }
    cpa::cp_async_commit();
  }

  // One block of the (b, h) writes all rows at or past pad0, while the
  // copies above land: the first block whose rows start at or past pad0,
  // else the last block. Its scratch is group 0's P tile.
  const int writer = min((pad0 + BQ - 1) / BQ, (int)gridDim.y - 1);
  if (pad0 < Tq && qb == writer) {
    write_padding_rows<THREADS, HD>(sQ + TILE + 2 * STAGES * TILE, v + k_base, o + q_base,
                                m_out + stat_base, s_out + stat_base, pad0, Tq, Tk);
  }
  if (n_tiles == 0) return;
  cpa::cp_async_wait<0>();
  __syncthreads();  // Q and every group's first tile have landed

  const int rg = gtid >> 4, cg = gtid & 15;  // rows rg + 8 i; keys cg + 16 j; columns 4 cg + c
  const float scale2 = scale * f32::LOG2E;
  float acc[8][CW], row_max[8], row_sum[8];  // row_sum: this thread's keys only, until the end
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    row_max[i] = NEG;
    row_sum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  // this group's key tiles: group, group + GROUPS, ...
  for (int it = 0, t = group; t < n_tiles; ++it, t += GROUPS) {
    const int buf = it % STAGES;
    if (it > 0) {
      cpa::cp_async_wait<0>();  // tile t has landed
      cpa::group_sync(1 + group, GROUP_THREADS);  // ... for the group, which is done with it - 1
    }
    const int ahead = t + GROUPS;
    if (ahead < n_tiles) {  // into the stage of tile it - 1
      f32::load_tile_async<GROUP_THREADS, HD>(sK + (1 - buf) * TILE, k + k_base, ahead * BK, k_end,
                                              gtid);
      f32::load_tile_async<GROUP_THREADS, HD>(sV + (1 - buf) * TILE, v + k_base, ahead * BK, k_end,
                                              gtid);
    }
    cpa::cp_async_commit();
    const float* tK = sK + buf * TILE;
    const float* tV = sV + buf * TILE;
    const int kt = t * BK;
    const int n_keys = min(BK, k_end - kt);

    // S = Q.K^T; a tile with at most 32 keys left computes only those (the
    // others are masked), and P.V stops after them (P = 0 there on every row
    // that is written)
    float sc[8][4];
    if (n_keys > 32) {
      f32::dots<8, 4, false, 8, HD>(sc, sQ, tK, rg, cg);
    } else {
      f32::dots<8, 2, false, 8, HD>(sc, sQ, tK, rg, cg);
    }

    // mask, online softmax in base 2; P to this warp's rows of sP
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + rg + 8 * i;
      float tile_max = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt + cg + 16 * j;
        sc[i][j] = col < k_end && (!causal || col <= row) ? sc[i][j] * scale2 : NEG;
        tile_max = fmaxf(tile_max, sc[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(row_max[i], tile_max);
      const float alpha = exp2f(row_max[i] - m_new);
      row_max[i] = m_new;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(sc[i][j] - m_new);
        part += p;
        sP[(rg + 8 * i) * LDP + cg + 16 * j] = p;
      }
      row_sum[i] = row_sum[i] * alpha + part;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // P rows are written and read by one half-warp each

    f32::accumulate<8, 8, HD>(acc, sP, tV, rg, cg, n_keys);
  }
  cpa::cp_async_wait<0>();

  // With two groups, group 1 hands its partial (row max, row sums, o
  // accumulator) to group 0 through its own ring, element-major so that
  // lanes hit distinct banks; group 0 merges them as the online softmax
  // merges two tiles: a group with no tile, or a row that saw only masked
  // keys in it, holds m = NEG and drops out with weight exp2(NEG - m) = 0.
  if constexpr (GROUPS == 2) {
    __syncthreads();  // both groups are done with their rings
    float* xch = sQ + TILE + GROUP_FLOATS;  // [16 + 8 CW][GROUP_THREADS]
    if (group == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        xch[i * GROUP_THREADS + gtid] = row_max[i];
        xch[(8 + i) * GROUP_THREADS + gtid] = row_sum[i];
#pragma unroll
        for (int c = 0; c < CW; ++c) xch[(16 + CW * i + c) * GROUP_THREADS + gtid] = acc[i][c];
      }
    }
    __syncthreads();
    if (group == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float m1 = xch[i * GROUP_THREADS + gtid];
        const float m_new = fmaxf(row_max[i], m1);
        const float a0 = exp2f(row_max[i] - m_new), a1 = exp2f(m1 - m_new);
        row_sum[i] = row_sum[i] * a0 + xch[(8 + i) * GROUP_THREADS + gtid] * a1;
        row_max[i] = m_new;
#pragma unroll
        for (int c = 0; c < CW; ++c)
          acc[i][c] = acc[i][c] * a0 + xch[(16 + CW * i + c) * GROUP_THREADS + gtid] * a1;
      }
    }
  }

  if (group == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], off);
      const int row = q0 + rg + 8 * i;
      if (row >= rows_end) continue;  // past Tq, or a padding row written by the writer
      const float inv = 1.f / row_sum[i];
#pragma unroll
      for (int h = 0; h < HD / 64; ++h)
        *reinterpret_cast<float4*>(o + q_base + (size_t)row * HD + 64 * h + 4 * cg) =
            make_float4(acc[i][4 * h] * inv, acc[i][4 * h + 1] * inv, acc[i][4 * h + 2] * inv,
                        acc[i][4 * h + 3] * inv);
      if (cg == 0) {
        m_out[stat_base + row] = row_max[i] * f32::LN2;
        s_out[stat_base + row] = row_sum[i];
      }
    }
  }
}

template <int HD, int GROUPS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_len,
                   const void* m_len, void* o, void* m, void* s, int B, int H, int Tq, int Tk,
                   float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;  // above 48 KB needs an explicit opt-in
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(masked_attention_fwd_kernel<HD, GROUPS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem_bytes<HD, GROUPS>());
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  masked_attention_fwd_kernel<HD, GROUPS>
      <<<grid, GROUPS * GROUP_THREADS, smem_bytes<HD, GROUPS>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(q_len), static_cast<const int*>(m_len), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(s), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: contiguous fp32 [B, H, T, D], D = 64, 128, 256 or a multiple of
// 128 above (D >= 128: the 3xTF32 kernel, masked_attention_fwd_3xtf32.cu;
// the wrapper pads other widths with zero columns to the next of those);
// q_len, m_len: int32 [B] or null; o like q; m, s: fp32 [B, H, Tq]. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* q_len, const void* m_len,
                                    void* o, void* m, void* s, int B, int H,
                                    int Tq, int Tk, int D, float scale,
                                    int causal, void* stream) {
  if ((D != 64 && D != 128 && D != f32::WIDE && !wide::takes(D)) || B <= 0 || H <= 0 ||
      Tq <= 0 || Tk <= 0 || (Tq + BQ - 1) / BQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64) {  // 128, 256 and every multiple of 128 above
    return (int)wide::fwd_f32(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, D, scale, causal, st);
  }
  return (int)(Tk > TWO_GROUPS_MIN_TK
                   ? launch<64, 2>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, scale, causal, st)
                   : launch<64, 1>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, scale, causal, st));
}

// Dynamic shared memory a D = 64 block of two warp groups asks for, in
// bytes (a block of one group asks for 104,448; ptxas -v reports static
// shared memory only).
extern "C" int masked_attention_fwd_shared_bytes(void) { return (int)smem_bytes<64, 2>(); }
