// Masked multi-head attention at every head width above 256 (each multiple
// of 128, taken at run time), fp32 FMAs, for sm_90a: the forward, the dQ
// kernel (which also forms delta) and the dK/dV kernel. Reached through the
// C entry points of the D = 64, 128 and 256 kernels
// (masked_attention_fwd.cu, masked_attention_bwd.cu,
// masked_attention_bwd_dkv.cu), which send every D > 256 here; the bf16
// counterparts, and the design both share, are in
// masked_attention_wide_tc.cu.
//
// Replaces, for fp32 inputs at D > 256, the Pallas kernels of
// vaenar_tts_tpu/ops/flash_attention.py: _fwd_kernel (l.104, pallas_call
// l.299), _fwd_kernel_blocked (l.142, pallas_call l.224), _dq_kernel
// (l.320, pallas_call l.442; and delta, l.425-427) and _dkv_kernel (l.370,
// pallas_call l.467). The contract is masked_attention_bwd.cu's and
// masked_attention_fwd.cu's.
//
// The design (masked_attention_wide_tc.cu's): a grid axis over the D / 128
// slices of 128 output columns; S (and dP) summed over the D / 64 panels
// of 64 columns of Q and K (and dO and V), streamed through a two-stage
// cp.async ring; besides them a block holds only its slice of the
// operand the second product reads, the score tile and the tile's
// statistics. fp32 FMAs on the SIMT units (the fp32 path must meet the
// fp32 reference's tolerance, which TF32 tensor cores would not), with
// tile_f32.cuh's 64 x 68 tiles and register layouts: the forward's and
// dK/dV's accumulators are the D = 256 kernels' (masked_attention_fwd.cu's
// masked_attention_fwd_wide_kernel and its backward pair), a panel's
// product is f32::dots at HD = 64 added to the panels before it, and the
// second product f32::accumulate at HD = 128 on the slice. Shared memory a
// block, at every width: 123,392 (forward), 190,464 (dQ) and 225,536
// (dK/dV) bytes. Right first: key and q-tiles are not narrowed, and S is
// recomputed in each slice; its times are in PERF.md §6.

#include "attention_wide.cuh"
#include "tile_f32.cuh"

namespace {

using f32::NEG;

constexpr int BQ = 64;      // query rows of a block (forward, dQ) or of a q-tile (dK/dV)
constexpr int BK = 64;      // keys of a tile (forward, dQ) or of a block (dK/dV)
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

// Column sums of rows [row0, row1) of SLICE columns of an fp32 matrix whose
// rows are ld floats apart, each row times 1 / div[r] when `div` is not
// null, into sum[0..SLICE); `scratch` is shared memory for THREADS * 4
// floats (f32::column_sums with a run-time row stride). Ends with a
// barrier.
template <int THREADS>
__device__ __forceinline__ void slice_sums(float* sum, float* scratch,
                                           const float* __restrict__ src, int ld, int row0,
                                           int row1, const float* __restrict__ div) {
  constexpr int DEPTH = 8;             // loads in flight a thread
  constexpr int TPR = SLICE / 4;       // threads a row
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
  if (threadIdx.x < SLICE) {
    float total = 0.f;
    for (int g = 0; g < STEP; ++g) total += scratch[g * SLICE + threadIdx.x];
    sum[threadIdx.x] = total;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- forward

constexpr int FWD_THREADS = 128;  // thread t owns rows t / 16 + 8 i, keys t % 16 + 16 j
// the ring (a Q and a K panel a stage), V's slice, P, the padding sums
constexpr size_t FWD_SMEM =
    sizeof(float) * (STAGES * 2 * TP + TS + TP + SLICE + 4 * FWD_THREADS);

__global__ void __launch_bounds__(FWD_THREADS)
fwd_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ q_len,
                    const int* __restrict__ m_len, float* __restrict__ o,
                    float* __restrict__ m_out, float* __restrict__ s_out, int H, int Tq, int Tk,
                    int D, float scale, int causal) {
  constexpr int CW = SLICE / 16;  // o columns a thread: 64 h + 4 cg + c
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                      // [STAGES][Q panel, K panel]
  float* sV = ring + STAGES * 2 * TP;      // [64][ldp(SLICE)]: the key tile's v in the slice
  float* sP = sV + TS;                     // [64][LDP]
  float* sum = sP + TP;                    // [SLICE], then 4 * THREADS of scratch

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  // the last q-block first: when causal its chain of key tiles is the longest
  const int qb = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int q0 = qb * BQ;
  const int q_rows = min(BQ, Tq - q0);
  const int c0 = (int)blockIdx.z * SLICE;  // this block's columns of o and v
  const bool writes_stats = blockIdx.z == 0;
  const int np = D / PANEL;
  const int qlen = q_len ? q_len[b] : Tq;
  const int klim = max(0, min(Tk, m_len ? m_len[b] : Tk));  // keys a valid row may see
  const size_t q_base = (size_t)bh * Tq * D;
  const size_t k_base = (size_t)bh * Tk * D;
  const size_t stat_base = (size_t)bh * Tq;

  // as masked_attention_fwd_kernel: rows below pad0 have a key (key 0), the
  // others are uniform; valid rows see no key at or past k_end
  const int pad0 = klim > 0 ? max(0, min(qlen, Tq)) : 0;
  const int rows_end = min(q0 + q_rows, pad0);
  const int k_end = causal ? min(klim, rows_end) : klim;
  const int n_tiles = q0 < pad0 ? (k_end + BK - 1) / BK : 0;
  const int n_steps = n_tiles * np;  // one step a (key tile, panel)

  auto load_step = [&](int s) {
    const int t = s / np, p = s - t * np;
    float* stage = ring + (s & 1) * 2 * TP;
    load_tile<FWD_THREADS, PANEL>(stage, q + q_base + p * PANEL, D, q0, rows_end, tid);
    load_tile<FWD_THREADS, PANEL>(stage + TP, k + k_base + p * PANEL, D, t * BK, k_end, tid);
  };
  if (n_steps > 0) {
    load_step(0);
    cpa::cp_async_commit();
  }

  // one block of the (b, h, slice) writes the rows at or past pad0, in its
  // slice, while the copies above land (masked_attention_fwd.cu's writer)
  const int writer = min((pad0 + BQ - 1) / BQ, (int)gridDim.y - 1);
  if (pad0 < Tq && qb == writer) {
    constexpr int TPR = SLICE / 4;  // threads a row, 4 columns each
    slice_sums<FWD_THREADS>(sum, sum + SLICE, v + k_base + c0, D, 0, Tk, nullptr);
    const int c4 = (tid % TPR) * 4;
    const float n = (float)Tk;
    const float4 mean =
        make_float4(sum[c4] / n, sum[c4 + 1] / n, sum[c4 + 2] / n, sum[c4 + 3] / n);
    for (int r = pad0 + tid / TPR; r < Tq; r += FWD_THREADS / TPR)
      *reinterpret_cast<float4*>(o + q_base + (size_t)r * D + c0 + c4) = mean;
    for (int r = pad0 + tid; writes_stats && r < Tq; r += FWD_THREADS) {
      m_out[stat_base + r] = NEG;
      s_out[stat_base + r] = n;
    }
  }
  if (n_steps == 0) return;

  const int rg = tid >> 4, cg = tid & 15;  // rows rg + 8 i; keys cg + 16 j; columns 4 cg + c
  const float scale2 = scale * f32::LOG2E;
  float acc[8][CW], row_max[8], row_sum[8];  // row_sum: this thread's keys only, until the end
  float sc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    row_max[i] = NEG;
    row_sum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  for (int s = 0; s < n_steps; ++s) {
    const int t = s / np, p = s - t * np;
    if (s + 1 < n_steps) load_step(s + 1);
    // the tile's V slice, read after its last panel: the tile before, the
    // last to read its buffer, has passed the barrier
    if (p == 0) load_tile<FWD_THREADS, SLICE>(sV, v + k_base + c0, D, t * BK, k_end, tid);
    cpa::cp_async_commit();
    cpa::cp_async_wait<1>();  // step s's panels have landed (and V, by the last panel)
    __syncthreads();
    const float* stage = ring + (s & 1) * 2 * TP;
    if (p == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    }
    f32::dots<8, 4, false, 8, PANEL, true>(sc, stage, stage + TP, rg, cg);

    if (p == np - 1) {
      // mask, online softmax in base 2; P to this warp's rows of sP
      const int kt = t * BK;
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
          const float pr = exp2f(sc[i][j] - m_new);
          part += pr;
          sP[(rg + 8 * i) * LDP + cg + 16 * j] = pr;
        }
        row_sum[i] = row_sum[i] * alpha + part;
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
      }
      __syncwarp();  // P rows are written and read by one half-warp each
      f32::accumulate<8, 8, SLICE, LDP>(acc, sP, sV, rg, cg, min(BK, k_end - kt));
    }
    __syncthreads();  // the next step refills this stage
  }
  cpa::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], off);
    const int row = q0 + rg + 8 * i;
    if (row >= rows_end) continue;  // past Tq, or a padding row written by the writer
    const float inv = 1.f / row_sum[i];
#pragma unroll
    for (int h = 0; h < SLICE / 64; ++h)
      *reinterpret_cast<float4*>(o + q_base + (size_t)row * D + c0 + 64 * h + 4 * cg) =
          make_float4(acc[i][4 * h] * inv, acc[i][4 * h + 1] * inv, acc[i][4 * h + 2] * inv,
                      acc[i][4 * h + 3] * inv);
    if (writes_stats && cg == 0) {
      m_out[stat_base + row] = row_max[i] * f32::LN2;
      s_out[stat_base + row] = row_sum[i];
    }
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
  slice_sums<BWD_THREADS>(usum, sX, dout + q_base + c0, D, valid_end, Tq, s_in + stat_base);

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

cudaError_t fwd_f32(const void* q, const void* k, const void* v, const void* q_len,
                    const void* m_len, void* o, void* m, void* s, int B, int H, int Tq, int Tk,
                    int D, float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;
  const cudaError_t err = opt_in(fwd_f32_wide_kernel, FWD_SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ, D / SLICE);
  fwd_f32_wide_kernel<<<grid, FWD_THREADS, FWD_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(q_len), static_cast<const int*>(m_len), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(s), H, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

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
