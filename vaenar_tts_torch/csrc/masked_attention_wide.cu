// Masked multi-head attention at every head width above 256 (each multiple
// of 128, taken at run time), fp32 FMAs, for sm_90a: the dQ kernel (which
// also forms delta) and the dK/dV kernel. Reached through the C entry
// points of the D = 64, 128 and 256 kernels (masked_attention_bwd.cu,
// masked_attention_bwd_dkv.cu), which send every D > 256 here; the bf16
// counterparts, and the design both share, are in
// masked_attention_wide_tc.cu. The fp32 forward at these widths is
// masked_attention_fwd_3xtf32.cu's (3xTF32 on the tensor cores).
//
// Replaces, for fp32 inputs at D > 256, the backward Pallas kernels of
// vaenar_tts_tpu/ops/flash_attention.py: _dq_kernel (l.320, pallas_call
// l.442; and delta, l.425-427) and _dkv_kernel (l.370, pallas_call l.467).
// The contract is masked_attention_bwd.cu's.
//
// The design (masked_attention_wide_tc.cu's): a grid axis over the D / 128
// slices of 128 output columns; S and dP summed over the D / 64 panels
// of 64 columns of Q and K and of dO and V, streamed through a two-stage
// cp.async ring; besides them a block holds only its slice of the
// operand the second product reads, the score tile and the tile's
// statistics. fp32 FMAs on the SIMT units, with tile_f32.cuh's 64 x 68
// tiles and register layouts: dK/dV's accumulators are the D = 256
// kernels' (masked_attention_bwd_dkv.cu's), a panel's product is f32::dots
// at HD = 64 added to the panels before it, and the second product
// f32::accumulate at HD = 128 on the slice. Shared memory a block, at every
// width: 190,464 (dQ) and 225,536 (dK/dV) bytes. Right first: key and
// q-tiles are not narrowed, and S is recomputed in each slice; its times
// are in PERF.md §6.

#include "attention_wide.cuh"
#include "tile_f32.cuh"

namespace {

using f32::NEG;

constexpr int BQ = 64;      // query rows of a block (dQ) or of a q-tile (dK/dV)
constexpr int BK = 64;      // keys of a tile (dQ) or of a block (dK/dV)
constexpr int PANEL = 64;   // columns of a streamed panel
constexpr int SLICE = 128;  // output columns of a block
constexpr int STAGES = 2;   // the panel ring: one stage loads while one multiplies
constexpr int TP = f32::tile<PANEL>();  // floats of a panel tile (64 x 68)
constexpr int TS = f32::tile<SLICE>();  // floats of a slice tile (64 x 132)
constexpr int LDP = f32::ldp<PANEL>();  // row stride of a panel or score tile

// Rows [row0, row0 + 64) of COLS columns (PANEL or SLICE) of an fp32
// matrix whose rows are ld floats apart into a shared tile of row stride
// ldp(COLS), as asynchronous copies by THREADS threads numbered `tid`; rows
// at or past `rows_end` become zeros (f32::load_tile_async with a run-time
// row stride).
template <int THREADS, int COLS>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int ld,
                                          int row0, int rows_end, int tid) {
  constexpr int CHUNKS = COLS / 4, SHIFT = cpa::log2i(CHUNKS);  // 16-byte chunks a row
#pragma unroll
  for (int chunk = tid; chunk < BQ * CHUNKS; chunk += THREADS) {
    const int r = chunk >> SHIFT, col = (chunk & (CHUNKS - 1)) * 4;
    const bool in = row0 + r < rows_end;
    cpa::cp_async16(dst + r * f32::ldp<COLS>() + col,
                    in ? src + (size_t)(row0 + r) * ld + col : src, in);
  }
}

// -------------------------------------------------------------------- dQ

constexpr int RS = 16;           // row (or key) groups of the backward: t / 16 + 16 i
constexpr int NR = BQ / RS;      // rows (keys) a thread
constexpr int BWD_THREADS = 16 * RS;
// the ring (a Q, dO, K and V panel a stage), K's slice of the key tile, dS
constexpr size_t DQ_SMEM = sizeof(float) * (STAGES * 4 * TP + TS + TP);

__global__ void __launch_bounds__(BWD_THREADS, 1)
dq_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ o, const int* __restrict__ q_len,
                   const int* __restrict__ m_len, const float* __restrict__ m_in,
                   const float* __restrict__ s_in, float* __restrict__ delta_out,
                   float* __restrict__ dq, int H, int Tq, int Tk, int D, float scale,
                   int causal) {
  constexpr int CW = SLICE / 16;  // dQ columns a thread: 64 h + 4 cg + c
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                  // [STAGES][Q, dO, K, V panel]
  float* sK = ring + STAGES * 4 * TP;  // [64][ldp(SLICE)]: the key tile's k in the slice
  float* sDS = sK + TS;                // [64][LDP]: dS

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * BQ;
  const int q_rows = min(BQ, Tq - q0);
  const int c0 = (int)blockIdx.z * SLICE;  // this block's columns of dQ and K
  const bool writes_delta = blockIdx.z == 0;
  const int np = D / PANEL;
  const int mlen = max(0, min(m_len ? m_len[b] : Tk, Tk));
  // rows below valid_end have an unmasked key; the others have dQ = 0
  const int valid_end = mlen > 0 ? max(0, min(q_len ? q_len[b] : Tq, Tq)) : 0;
  const int rows_end = min(q0 + q_rows, valid_end);
  const size_t q_base = (size_t)bh * Tq * D;
  const size_t k_base = (size_t)bh * Tk * D;
  const size_t stat_base = (size_t)bh * Tq;

  if (rows_end <= q0) {  // no row of the block has a key: zero dQ in the slice, zero delta
    constexpr int CHUNKS = SLICE / 4, SHIFT = cpa::log2i(CHUNKS);
    for (int c = tid; c < q_rows * CHUNKS; c += BWD_THREADS)
      *reinterpret_cast<float4*>(dq + q_base + (size_t)(q0 + (c >> SHIFT)) * D + c0 +
                                 (c & (CHUNKS - 1)) * 4) = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = tid; writes_delta && r < q_rows; r += BWD_THREADS)
      delta_out[stat_base + q0 + r] = 0.f;
    return;
  }
  // keys at or past k_end are masked for every row of the block
  const int k_end = causal ? min(mlen, rows_end) : mlen;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int n_steps = n_tiles * np;

  auto load_step = [&](int s) {
    const int t = s / np, p = s - t * np;
    float* stage = ring + (s & 1) * 4 * TP;
    load_tile<BWD_THREADS, PANEL>(stage, q + q_base + p * PANEL, D, q0, rows_end, tid);
    load_tile<BWD_THREADS, PANEL>(stage + TP, dout + q_base + p * PANEL, D, q0, rows_end, tid);
    load_tile<BWD_THREADS, PANEL>(stage + 2 * TP, k + k_base + p * PANEL, D, t * BK, k_end, tid);
    load_tile<BWD_THREADS, PANEL>(stage + 3 * TP, v + k_base + p * PANEL, D, t * BK, k_end, tid);
  };
  load_step(0);
  cpa::cp_async_commit();

  // this thread's rows rg + RS i: delta over the whole width from O's and
  // dO's rows in device memory (columns 64 u + 4 cg .. + 3, summed over the
  // half-warp), m * log2(e) and 1/s; rows without a key take zeros. Slice
  // 0's lane cg == i writes row rg + RS i's delta.
  const int rg = tid >> 4, cg = tid & 15;  // rows rg + RS i; keys cg + 16 j; columns 4 cg + c
  const float scale2 = scale * f32::LOG2E;
  float m2[NR], inv_s[NR], delta[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = q0 + rg + RS * i;
    const bool in = row < rows_end;
    // each float4's 4 products as a tree, the panels into 2 sums in turn
    // (np is even): no chain of additions grows long with D
    float part[2] = {0.f, 0.f};
    if (in) {
      const float* orow = o + q_base + (size_t)row * D + 4 * cg;
      const float* grow = dout + q_base + (size_t)row * D + 4 * cg;
      for (int u = 0; u < np; u += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 g = *reinterpret_cast<const float4*>(grow + 64 * (u + h));
          const float4 op = *reinterpret_cast<const float4*>(orow + 64 * (u + h));
          part[h] += fmaf(g.x, op.x, g.y * op.y) + fmaf(g.z, op.z, g.w * op.w);
        }
      }
    }
    float d = part[0] + part[1];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    delta[i] = d;
    if (writes_delta && cg == i && rg + RS * i < q_rows) delta_out[stat_base + row] = d;
    m2[i] = in ? m_in[stat_base + row] * f32::LOG2E : 0.f;
    inv_s[i] = in ? 1.f / s_in[stat_base + row] : 0.f;
  }

  float acc[NR][CW], sc[NR][4], dp[NR][4];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;

  for (int s = 0; s < n_steps; ++s) {
    const int t = s / np, p = s - t * np;
    if (s + 1 < n_steps) load_step(s + 1);
    if (p == 0) load_tile<BWD_THREADS, SLICE>(sK, k + k_base + c0, D, t * BK, k_end, tid);
    cpa::cp_async_commit();
    cpa::cp_async_wait<1>();
    __syncthreads();
    const float* stage = ring + (s & 1) * 4 * TP;
    if (p == 0) {
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    }
    f32::dots<NR, 4, false, RS, PANEL, true>(sc, stage, stage + 2 * TP, rg, cg);       // S
    f32::dots<NR, 4, false, RS, PANEL, true>(dp, stage + TP, stage + 3 * TP, rg, cg);  // dP

    if (p == np - 1) {
      const int kt = t * BK;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int row = q0 + rg + RS * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = kt + cg + 16 * j;
          // a masked key of a row with a key has P = exp(NEG - m) = 0
          // exactly; rows without a key take no part
          const bool unmasked = row < rows_end && key < k_end && (!causal || key <= row);
          const float pr = exp2f(fmaf(sc[i][j], scale2, -m2[i])) * inv_s[i];
          sDS[(rg + RS * i) * LDP + cg + 16 * j] = unmasked ? pr * (dp[i][j] - delta[i]) : 0.f;
        }
      }
      __syncwarp();  // a half-warp reads the dS rows that it wrote
      f32::accumulate<NR, RS, SLICE, LDP>(acc, sDS, sK, rg, cg, min(BK, k_end - kt));
    }
    __syncthreads();  // the next step refills this stage
  }
  cpa::cp_async_wait<0>();

  // dQ * scale in the block's slice, 16 bytes a row and thread; rows without
  // a key are zeros
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = rg + RS * i;
    if (r >= q_rows) continue;
#pragma unroll
    for (int h = 0; h < SLICE / 64; ++h)
      *reinterpret_cast<float4*>(dq + q_base + (size_t)(q0 + r) * D + c0 + 64 * h + 4 * cg) =
          make_float4(acc[i][4 * h] * scale, acc[i][4 * h + 1] * scale, acc[i][4 * h + 2] * scale,
                      acc[i][4 * h + 3] * scale);
  }
}

// ----------------------------------------------------------------- dK/dV

// the ring (a K, V, Q and dO panel a stage), the q-tile's Q and dO slices,
// P^T then dS^T (the padding sums' scratch after the loop), the q-tile's
// statistics and the padding rows' sum
constexpr size_t DKV_SMEM = sizeof(float) * (STAGES * 4 * TP + 2 * TS + TP + 3 * BQ + SLICE);

__global__ void __launch_bounds__(BWD_THREADS, 1)
dkv_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const int* __restrict__ q_len, const int* __restrict__ m_len,
                    const float* __restrict__ m_in, const float* __restrict__ s_in,
                    const float* __restrict__ delta_in, float* __restrict__ dk,
                    float* __restrict__ dv, int H, int Tq, int Tk, int D, float scale,
                    int causal) {
  constexpr int CW = SLICE / 16;  // accumulator columns a thread: 64 h + 4 cg + c
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                  // [STAGES][K, V, Q, dO panel]
  float* sQ = ring + STAGES * 4 * TP;  // [64][ldp(SLICE)]: the q-tile's q in the slice
  float* sDO = sQ + TS;                // [64][ldp(SLICE)]: the same of dO
  float* sX = sDO + TS;                // [64][LDP]: P^T, then dS^T
  float* sStat = sX + TP;              // [3][BQ]: the q-tile's m * log2(e), 1/s, delta
  float* usum = sStat + 3 * BQ;        // [SLICE]: the uniform rows' dO / s in the slice

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int k0 = blockIdx.y * BK;
  const int k_rows = min(BK, Tk - k0);
  const int c0 = (int)blockIdx.z * SLICE;  // this block's columns of dK, dV, Q and dO
  const int np = D / PANEL;
  const int mlen = max(0, min(m_len ? m_len[b] : Tk, Tk));
  // rows below valid_end have an unmasked key; the others are uniform
  const int valid_end = mlen > 0 ? max(0, min(q_len ? q_len[b] : Tq, Tq)) : 0;
  const size_t q_base = (size_t)bh * Tq * D;
  const size_t k_base = (size_t)bh * Tk * D;
  const size_t stat_base = (size_t)bh * Tq;

  // as masked_attention_bwd_dkv_kernel: the q-tiles that see this block's keys
  const int r_begin = causal ? k0 : 0;
  const int r_end = k0 < mlen ? valid_end : 0;
  const int n_tiles = r_begin < r_end ? (r_end - r_begin + BQ - 1) / BQ : 0;
  const int n_steps = n_tiles * np;

  // keys at or past m_len and rows at or past r_end load as zeros
  auto load_step = [&](int s) {
    const int t = s / np, p = s - t * np;
    const int qt = r_begin + t * BQ;
    float* stage = ring + (s & 1) * 4 * TP;
    load_tile<BWD_THREADS, PANEL>(stage, k + k_base + p * PANEL, D, k0, mlen, tid);
    load_tile<BWD_THREADS, PANEL>(stage + TP, v + k_base + p * PANEL, D, k0, mlen, tid);
    load_tile<BWD_THREADS, PANEL>(stage + 2 * TP, q + q_base + p * PANEL, D, qt, r_end, tid);
    load_tile<BWD_THREADS, PANEL>(stage + 3 * TP, dout + q_base + p * PANEL, D, qt, r_end, tid);
  };
  if (n_steps > 0) {
    load_step(0);
    cpa::cp_async_commit();
  }

  const int rg = tid >> 4, cg = tid & 15;  // keys rg + RS i; rows cg + 16 j; columns 64 h + 4 cg + c
  const float scale2 = scale * f32::LOG2E;
  float acc_dk[NR][CW], acc_dv[NR][CW], x[NR][4], dpt[NR][4];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  for (int s = 0; s < n_steps; ++s) {
    const int t = s / np, p = s - t * np;
    const int qt = r_begin + t * BQ;
    if (s + 1 < n_steps) load_step(s + 1);
    if (p == 0) {
      // the q-tile's Q and dO slices and statistics, read after its last
      // panel (rows at or past r_end take m = 0, 1/s = 1, delta = 0, unused)
      load_tile<BWD_THREADS, SLICE>(sQ, q + q_base + c0, D, qt, r_end, tid);
      load_tile<BWD_THREADS, SLICE>(sDO, dout + q_base + c0, D, qt, r_end, tid);
      if (tid < BQ) {
        const int row = qt + tid;
        const bool in = row < r_end;
        sStat[tid] = in ? m_in[stat_base + row] * f32::LOG2E : 0.f;
        sStat[BQ + tid] = in ? 1.f / s_in[stat_base + row] : 1.f;
        sStat[2 * BQ + tid] = in ? delta_in[stat_base + row] : 0.f;
      }
    }
    cpa::cp_async_commit();
    cpa::cp_async_wait<1>();
    __syncthreads();
    const float* stage = ring + (s & 1) * 4 * TP;
    if (p == 0) {
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[i][j] = dpt[i][j] = 0.f;
    }
    f32::dots<NR, 4, false, RS, PANEL, true>(x, stage, stage + 2 * TP, rg, cg);         // S^T
    f32::dots<NR, 4, false, RS, PANEL, true>(dpt, stage + TP, stage + 3 * TP, rg, cg);  // dP^T

    if (p == np - 1) {
      const int n_rows = min(BQ, r_end - qt);
      // P^T: rows past r_end and masked pairs take 0 (the latter exactly
      // exp(NEG - m) of a real m)
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int key = k0 + rg + RS * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rl = cg + 16 * j, row = qt + rl;
          const bool unmasked = row < r_end && key < mlen && (!causal || key <= row);
          sX[(rg + RS * i) * LDP + rl] =
              unmasked ? exp2f(fmaf(x[i][j], scale2, -sStat[rl])) * sStat[BQ + rl] : 0.f;
        }
      }
      __syncwarp();
      f32::accumulate<NR, RS, SLICE, LDP>(acc_dv, sX, sDO, rg, cg, n_rows);  // dV += P^T.dO
      __syncwarp();  // the half-warp is done reading P^T
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* pt = sX + (rg + RS * i) * LDP + cg + 16 * j;
          *pt *= dpt[i][j] - sStat[2 * BQ + cg + 16 * j];  // dS^T = P^T * (dP^T - delta)
        }
      __syncwarp();
      f32::accumulate<NR, RS, SLICE, LDP>(acc_dk, sX, sQ, rg, cg, n_rows);  // dK += dS^T.Q
    }
    __syncthreads();  // the next step refills this stage
  }
  cpa::cp_async_wait<0>();
  __syncthreads();  // every warp is done with sX

  // Rows in [valid_end, Tq) are uniform over the Tk keys: each adds
  // dO_row / s_row to every dV row, summed in the slice's columns from
  // device memory (blocks with no q-tile included)
  wide::slice_sums<BWD_THREADS>(usum, sX, dout + q_base + c0, D, valid_end, Tq, s_in + stat_base);

  // dK * scale and dV plus the uniform rows' sum in the block's slice
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int key = rg + RS * i;
    if (key >= k_rows) continue;
#pragma unroll
    for (int h = 0; h < SLICE / 64; ++h) {
      const float* u = usum + 64 * h + 4 * cg;
      const size_t at = k_base + (size_t)(k0 + key) * D + c0 + 64 * h + 4 * cg;
      *reinterpret_cast<float4*>(dk + at) =
          make_float4(acc_dk[i][4 * h] * scale, acc_dk[i][4 * h + 1] * scale,
                      acc_dk[i][4 * h + 2] * scale, acc_dk[i][4 * h + 3] * scale);
      *reinterpret_cast<float4*>(dv + at) =
          make_float4(acc_dv[i][4 * h] + u[0], acc_dv[i][4 * h + 1] + u[1],
                      acc_dv[i][4 * h + 2] + u[2], acc_dv[i][4 * h + 3] + u[3]);
    }
  }
}

}  // namespace

namespace wide {

cudaError_t dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* o,
                   const void* q_len, const void* m_len, const void* m, const void* s,
                   void* delta, void* dq, int B, int H, int Tq, int Tk, int D, float scale,
                   int causal, cudaStream_t stream) {
  static bool smem_set = false;
  const cudaError_t err = opt_in(dq_f32_wide_kernel, DQ_SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ, D / SLICE);
  dq_f32_wide_kernel<<<grid, BWD_THREADS, DQ_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(o),
      static_cast<const int*>(q_len), static_cast<const int*>(m_len),
      static_cast<const float*>(m), static_cast<const float*>(s), static_cast<float*>(delta),
      static_cast<float*>(dq), H, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

cudaError_t dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                    const void* q_len, const void* m_len, const void* m, const void* s,
                    const void* delta, void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
                    float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;
  const cudaError_t err = opt_in(dkv_f32_wide_kernel, DKV_SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tk + BK - 1) / BK, D / SLICE);
  dkv_f32_wide_kernel<<<grid, BWD_THREADS, DKV_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const int*>(q_len),
      static_cast<const int*>(m_len), static_cast<const float*>(m),
      static_cast<const float*>(s), static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace wide
