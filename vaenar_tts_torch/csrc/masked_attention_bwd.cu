// Masked multi-head attention, backward, the dQ kernel, fp32 FMAs, for
// sm_90a. Plain C interface, bound from Python with ctypes
// (vaenar_tts_torch/ops/flash_attention.py, masked_flash_attention_backward);
// fp32 inputs take this kernel, bf16 ones masked_attention_bwd_dq_tc.cu. It
// also forms delta = rowsum(dO * O), which the fp32 dK/dV kernel
// (masked_attention_bwd_dkv.cu), launched after it on the same stream, reads.
//
// Replaces _dq_kernel of vaenar_tts_tpu/ops/flash_attention.py (l.320,
// pallas_call l.442; grid batch, head, q-block, k-block, dQ accumulated over
// the k-blocks) for fp32 inputs, and the delta that _pallas_backward forms
// outside its kernels (l.425-427). Here each block owns its 64 rows of dQ and
// loops over the key tiles inside the block, so nothing is carried between
// blocks and nothing is atomic.
//
// Contract of the backward kernels (the forward's, masked_attention_fwd.cu):
// logits = q.k^T * scale; mask = row < q_len[b] && col < m_len[b]
// (&& col <= row when causal); masked logits are NEG = -2^32+1. From the
// forward's row stats (max m, sum s):
//   delta = rowsum(dO * O) in fp32 on every row with an unmasked key, 0 on
//           the others (their dS is 0, so no gradient reads their delta)
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
// What bounds it on an H100 at the training path's shapes (batch 32, H=4,
// D=64, text 32 of which 12-24 tokens are valid, reduced mel 240 at r = 2 of
// which 55-98 rows are valid): bytes, by the count in chip_smoke.py (backward_work,
// dq_forms_delta): q, dO and O of the valid rows, the K and V rows they see,
// their m and s, dQ and delta written whole. An unmasked (row, key) pair
// costs 6*D fp32 FMA-operations and a valid row 2*D more for delta; with
// most rows padding, the bytes outweigh them about threefold. Neither sets
// the time at these shapes: a site runs 1-2 working blocks per (b, h), and
// the blocks of the longest item alone take about 70 % of the 32 items'
// time at the causal and cross sites (scripts/torch_attention_sites.py
// --batch 1), so the latency of the heaviest block does (the q-tile of rows
// 64-97 with two key tiles, and the launch). What held the first version
// back, and what this design does about it:
//   * scalar shared loads, one for every two FMAs (a thread owned 4 x 4 of
//     S, dP and dQ, 4 bytes a load): here 16-byte loads (tile_f32.cuh);
//   * synchronous tiles, 4-byte global loads with a division and a modulo
//     an element, two barriers around each key tile: here Q, dO and the
//     first key tile arrive by cp.async (16 bytes a copy), and K and V
//     stream through a two-stage ring, the next tile loading while this one
//     multiplies;
//   * a division an element for P: here m * log2(e) and 1/s of a thread's
//     rows sit in registers, so that P costs one exp2 and one multiply;
//   * dS behind a barrier of the whole block: a row of Q, dS and dQ is read
//     and written by one half-warp only, so on a block's last key tile dS
//     goes over the thread's own rows of Q behind __syncwarp; on an earlier
//     tile it goes over the V tile, which dP = dO.V^T is done with once the
//     block passes one barrier. The block needs no tile of its own for dS,
//     so two blocks fit on an SM;
//   * delta from a separate pass (two more launches a site, and a read of
//     dO and O): here the block forms it at its start from O, read once with
//     16-byte loads, and the dO tile: a thread sums 4 columns of its rows
//     and its half-warp adds them up by shuffles, so each thread holds the
//     delta of its rows in registers; it is written once.
// And for the heaviest block's latency: 256 threads a block, each owning
// 4 x 4 of S, dP and dQ (rows rg + 16 i: tile_f32.cuh with RS = 16), half the
// chain of dependent instructions a thread of the 8 x 4 layout has, within
// 128 registers so that two blocks still fit on an SM; a tile computes only
// ceil(rows / 16) row groups and ceil(keys / 16) key groups, and on the
// causal diagonal skips the triangle of key groups past their rows. A block
// of 128 threads with 8 x 4 tiles narrowed at 32 rows and keys (254
// registers, the same shared memory) measured slower at every training site
// (PERF.md §6).
//
// Work skipped without changing the result:
//   * the key loop stops at m_len and, when causal, at the tile's last row
//     with a key: every skipped term is exp(NEG - m) = 0 exactly in fp32;
//   * K and V rows past that end are not read (their tile rows are zeros);
//   * a block whose rows all lack a key reads nothing: it writes its zero dQ
//     rows and its zero delta with 16-byte stores (4-byte ones where delta's
//     rows do not start or end at a 16-byte boundary).
//
// Shared memory: Q, dO and a two-stage K/V ring, 6 tiles of 64 x 68 fp32,
// 104,448 bytes a block (two blocks an SM).

// Head widths. A template of the head width, compiled for D = 64 (the
// design above) and D = 128; the C entry point runs the one its D names.
// At D = 128 a thread owns 8 columns of dQ (64 h + 4 cg + c, h < 2) and of
// its rows' O for delta; 6 tiles of 64 x 132 fp32, 202,752 bytes, leave
// one block an SM. Registers in PERF.md §6.
//
// D = 256: a kernel of its own (masked_attention_bwd_dq_wide_kernel). A row
// of 256 fp32 is two tiles of 128 columns (64 x 132). Q, dO, K and V are all
// read at the full width (S and dP), and the D = 128 layout at that width,
// 8 tiles even with one stage, does not fit. So the grid gains an axis over
// two column slices of dQ, and a block (the D = 128 thread layout, 256
// threads, 4 x 8 of dQ a thread) holds Q's and dO's two halves and streams
// each key tile through one stage as two halves of K and V: the other
// slice's half first, S and dP from its products, then the block's own
// half, whose products add to them (f32::dots with ADD) and whose K stays
// for dQ += dS . K; dS goes over that V half. 6 tiles of 64 x 132, 202,752
// bytes. Both slices form S, dP and delta; slice 0 writes delta.

#include "attention_wide.cuh"
#include "tile_f32.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int RS = 16;  // row groups: thread t owns rows t / 16 + RS i
constexpr int NR = BQ / RS;  // rows a thread
constexpr int THREADS = 16 * RS;
constexpr int STAGES = 2;  // K/V tiles in the ring: one loads while one multiplies
template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (2 + 2 * STAGES) * f32::tile<HD>();
}

// Zeros into dst[0, n) by the block: 16-byte stores from dst's first 16-byte
// boundary on, 4-byte ones before it and after the last.
__device__ __forceinline__ void store_zeros(float* __restrict__ dst, int n, int tid) {
  const int head = min(n, (int)((4 - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3));
  const int body = (n - head) >> 2;
  float4* mid = reinterpret_cast<float4*>(dst + head);
  for (int c = tid; c < body; c += THREADS) mid[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int tail = head + 4 * body;
  for (int c = tid; c < n - 4 * body; c += THREADS) dst[c < head ? c : tail + c - head] = 0.f;
}

// What every key tile of a block reads besides K and V: the block's Q and
// dO tiles, and this thread's rows rg + RS i with their statistics.
struct Rows {
  float* sQ;
  const float* sDO;
  float m2[NR], inv_s[NR], delta[NR];  // m * log2(e), 1/s and delta of each row
  int rg, cg, q0, rows_end, k_end, causal;
  float scale2;
};

// One key tile: S = Q.K^T and dP = dO.V^T, then dS = P * (dP - delta),
// then dQ += dS.K, for the rows rg + RS i with i < NI and the keys cg + 16 j
// with j < NJ (the tile's others are absent or masked). TRI for the tile on
// the causal diagonal (its keys and the block's rows start at the same
// index) skips its masked triangle. dS goes over this thread's own rows of
// Q on the block's last tile (a row of Q, dS and dQ is read and written by
// one half-warp only), else over the V tile, once every warp is done with V.
template <int HD, int NI, int NJ, bool TRI>
__device__ __forceinline__ void dq_tile(float (&acc)[NR][HD / 16], const Rows& w, const float* tK,
                                        float* tV, int kt, int n_keys, bool last) {
  constexpr int LDP = f32::ldp<HD>();
  float sc[NR][4], dp[NR][4];
  f32::dots<NI, NJ, TRI, RS, HD>(sc, w.sQ, tK, w.rg, w.cg);
  f32::dots<NI, NJ, TRI, RS, HD>(dp, w.sDO, tV, w.rg, w.cg);
  float* sDS = last ? w.sQ : tV;
  if (last) {
    __syncwarp();  // the half-warp is done reading its Q rows
  } else {
    __syncthreads();  // every warp is done reading V
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int row = w.q0 + w.rg + RS * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int key = kt + w.cg + 16 * j;
      // a masked key of a row with a key has P = exp(NEG - m) = 0 exactly;
      // rows without a key take no part
      const bool unmasked = row < w.rows_end && key < w.k_end && (!w.causal || key <= row);
      const float p = exp2f(fmaf(sc[i][j], w.scale2, -w.m2[i])) * w.inv_s[i];
      sDS[(w.rg + RS * i) * LDP + w.cg + 16 * j] = unmasked ? p * (dp[i][j] - w.delta[i]) : 0.f;
    }
  }
  __syncwarp();  // a half-warp reads the dS rows that it wrote
  if (TRI) {
    f32::accumulate_tri<NI, RS, HD>(acc, sDS, tK, w.rg, w.cg, n_keys);
  } else {
    f32::accumulate<NI, RS, HD>(acc, sDS, tK, w.rg, w.cg, n_keys);
  }
}

template <int HD, int NI>
__device__ __forceinline__ void dq_tile_keys(int nj, float (&acc)[NR][HD / 16], const Rows& w,
                                             const float* tK, float* tV, int kt, int n_keys,
                                             bool last) {
  switch (nj) {
    case 1: dq_tile<HD, NI, 1, false>(acc, w, tK, tV, kt, n_keys, last); break;
    case 2: dq_tile<HD, NI, 2, false>(acc, w, tK, tV, kt, n_keys, last); break;
    case 3: dq_tile<HD, NI, 3, false>(acc, w, tK, tV, kt, n_keys, last); break;
    default: dq_tile<HD, NI, 4, false>(acc, w, tK, tV, kt, n_keys, last);
  }
}

// dq_tile with NI = ceil(rows / 16) and NJ = ceil(keys / 16); on the
// diagonal NJ <= NI (the keys stop at the last row), so it takes NJ = NI.
template <int HD>
__device__ __forceinline__ void dq_tile_sized(bool diagonal, int ni, int nj,
                                              float (&acc)[NR][HD / 16], const Rows& w,
                                              const float* tK, float* tV, int kt, int n_keys,
                                              bool last) {
  if (diagonal) {
    switch (ni) {
      case 1: dq_tile<HD, 1, 1, true>(acc, w, tK, tV, kt, n_keys, last); break;
      case 2: dq_tile<HD, 2, 2, true>(acc, w, tK, tV, kt, n_keys, last); break;
      case 3: dq_tile<HD, 3, 3, true>(acc, w, tK, tV, kt, n_keys, last); break;
      default: dq_tile<HD, 4, 4, true>(acc, w, tK, tV, kt, n_keys, last);
    }
    return;
  }
  switch (ni) {
    case 1: dq_tile_keys<HD, 1>(nj, acc, w, tK, tV, kt, n_keys, last); break;
    case 2: dq_tile_keys<HD, 2>(nj, acc, w, tK, tV, kt, n_keys, last); break;
    case 3: dq_tile_keys<HD, 3>(nj, acc, w, tK, tV, kt, n_keys, last); break;
    default: dq_tile_keys<HD, 4>(nj, acc, w, tK, tV, kt, n_keys, last);
  }
}

// D = 64: two blocks an SM (104,448 bytes of shared memory each); D = 128:
// one (202,752 bytes)
template <int HD>
__global__ void __launch_bounds__(THREADS, HD == 64 ? 2 : 1)
masked_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ o, const int* __restrict__ q_len,
                               const int* __restrict__ m_len, const float* __restrict__ m_in,
                               const float* __restrict__ s_in, float* __restrict__ delta_out,
                               float* __restrict__ dq, int H, int Tq, int Tk, float scale,
                               int causal) {
  constexpr int LDP = f32::ldp<HD>(), TILE = f32::tile<HD>();
  constexpr int CW = HD / 16;  // dQ columns a thread: 64 h + 4 cg + c
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                // [64][LDP], this block's rows
  float* sDO = sQ + TILE;          // [64][LDP]
  float* sK = sDO + TILE;          // [STAGES][64][LDP], the key-tile ring
  float* sV = sK + STAGES * TILE;  // [STAGES][64][LDP]: V, then dS

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int q0 = blockIdx.y * BQ;
  const int q_rows = min(BQ, Tq - q0);
  const int mlen = max(0, min(m_len ? m_len[b] : Tk, Tk));
  // rows below valid_end have an unmasked key; the others have dQ = 0
  const int valid_end = mlen > 0 ? max(0, min(q_len ? q_len[b] : Tq, Tq)) : 0;
  const int rows_end = min(q0 + q_rows, valid_end);
  const size_t q_base = (size_t)bh * Tq * HD;
  const size_t k_base = (size_t)bh * Tk * HD;
  const size_t stat_base = (size_t)bh * Tq;

  if (rows_end <= q0) {  // no row of the block has a key
    store_zeros(dq + q_base + (size_t)q0 * HD, q_rows * HD, tid);
    store_zeros(delta_out + stat_base + q0, q_rows, tid);
    return;
  }
  // keys at or past k_end are masked for every row of the block
  const int k_end = causal ? min(mlen, rows_end) : mlen;
  const int n_tiles = (k_end + BK - 1) / BK;

  // Q, dO and key tile 0, one commit group
  f32::load_tile_async<THREADS, HD>(sQ, q + q_base, q0, rows_end, tid);
  f32::load_tile_async<THREADS, HD>(sDO, dout + q_base, q0, rows_end, tid);
  f32::load_tile_async<THREADS, HD>(sK, k + k_base, 0, k_end, tid);
  f32::load_tile_async<THREADS, HD>(sV, v + k_base, 0, k_end, tid);
  cpa::cp_async_commit();

  // This thread's rows rg + RS i: their O columns 64 h + 4 cg .. + 3 (16
  // bytes a load, a half-warp a row), m * log2(e) and 1/s; rows without a
  // key read nothing and take zeros.
  Rows w;
  w.sQ = sQ;
  w.sDO = sDO;
  w.rg = tid >> 4;  // rows rg + RS i; keys cg + 16 j; columns 4 cg + c
  w.cg = tid & 15;
  w.q0 = q0;
  w.rows_end = rows_end;
  w.k_end = k_end;
  w.causal = causal;
  w.scale2 = scale * f32::LOG2E;
  const int rg = w.rg, cg = w.cg;
  float4 o_part[NR][HD / 64];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = q0 + rg + RS * i;
    const bool in = row < rows_end;
#pragma unroll
    for (int h = 0; h < HD / 64; ++h)
      o_part[i][h] = in ? *reinterpret_cast<const float4*>(o + q_base + (size_t)row * HD +
                                                           64 * h + 4 * cg)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    w.m2[i] = in ? m_in[stat_base + row] * f32::LOG2E : 0.f;
    w.inv_s[i] = in ? 1.f / s_in[stat_base + row] : 0.f;
  }
  cpa::cp_async_wait<0>();
  __syncthreads();  // Q, dO and key tile 0 have landed

  // delta of rows rg + RS i: CW columns a thread, summed over the half-warp;
  // lane cg == i writes row rg + RS i (rows without a key come out 0: their
  // dO tile rows and O parts are zeros)
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    float d = 0.f;
#pragma unroll
    for (int h = 0; h < HD / 64; ++h) {
      const float4 g =
          *reinterpret_cast<const float4*>(sDO + (rg + RS * i) * LDP + 64 * h + 4 * cg);
      const float4& op = o_part[i][h];
      d = h == 0 ? fmaf(g.w, op.w, fmaf(g.z, op.z, fmaf(g.y, op.y, g.x * op.x)))
                 : fmaf(g.w, op.w, fmaf(g.z, op.z, fmaf(g.y, op.y, fmaf(g.x, op.x, d))));
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    w.delta[i] = d;
    if (cg == i && rg + RS * i < q_rows) delta_out[stat_base + q0 + rg + RS * i] = d;
  }

  const int ni = (rows_end - q0 + 15) / 16;
  float acc[NR][CW];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % STAGES;
    if (t > 0) {
      cpa::cp_async_wait<0>();  // key tile t has landed
      __syncthreads();          // ... for every warp, which is done with tile t - 1
    }
    if (t + 1 < n_tiles) {  // into the stage of tile t - 1
      f32::load_tile_async<THREADS, HD>(sK + (1 - buf) * TILE, k + k_base, (t + 1) * BK, k_end,
                                        tid);
      f32::load_tile_async<THREADS, HD>(sV + (1 - buf) * TILE, v + k_base, (t + 1) * BK, k_end,
                                        tid);
    }
    cpa::cp_async_commit();
    const float* tK = sK + buf * TILE;
    float* tV = sV + buf * TILE;
    const int kt = t * BK;
    const int n_keys = min(BK, k_end - kt);
    dq_tile_sized<HD>(causal && kt == q0, ni, (n_keys + 15) / 16, acc, w, tK, tV, kt, n_keys,
                  t + 1 == n_tiles);
  }
  cpa::cp_async_wait<0>();

  // dQ * scale, 16 bytes a row and thread; rows without a key are zeros
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = rg + RS * i;
    if (r >= q_rows) continue;
#pragma unroll
    for (int h = 0; h < HD / 64; ++h)
      *reinterpret_cast<float4*>(dq + q_base + (size_t)(q0 + r) * HD + 64 * h + 4 * cg) =
          make_float4(acc[i][4 * h] * scale, acc[i][4 * h + 1] * scale, acc[i][4 * h + 2] * scale,
                      acc[i][4 * h + 3] * scale);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* o, const void* q_len, const void* m_len, const void* m,
                   const void* s, void* delta, void* dq, int B, int H, int Tq, int Tk,
                   float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;  // above 48 KB needs an explicit opt-in, per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(masked_attention_bwd_dq_kernel<HD>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem_bytes<HD>());
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  masked_attention_bwd_dq_kernel<HD><<<grid, THREADS, smem_bytes<HD>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(o),
      static_cast<const int*>(q_len), static_cast<const int*>(m_len),
      static_cast<const float*>(m), static_cast<const float*>(s), static_cast<float*>(delta),
      static_cast<float*>(dq), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

// D = 256: f32::HALF columns a tile, two tiles a row; see the head-width
// note at the top. Key tiles stream in halves through one stage.
using f32::HALF;
using f32::WIDE;
constexpr size_t WIDE_SMEM_BYTES = sizeof(float) * 6 * f32::tile<HALF>();

__global__ void __launch_bounds__(THREADS, 1)
masked_attention_bwd_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ dout,
                                    const float* __restrict__ o, const int* __restrict__ q_len,
                                    const int* __restrict__ m_len,
                                    const float* __restrict__ m_in,
                                    const float* __restrict__ s_in,
                                    float* __restrict__ delta_out, float* __restrict__ dq, int H,
                                    int Tq, int Tk, float scale, int causal) {
  constexpr int LDP = f32::ldp<HALF>(), TILE = f32::tile<HALF>();
  constexpr int CW = HALF / 16;  // dQ columns a thread: 64 h + 4 cg + c
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [2][64][LDP]: the block's rows of q, columns 0-127, 128-255
  float* sDO = sQ + 2 * TILE;   // [2][64][LDP]: the same of dO
  float* sK = sDO + 2 * TILE;   // [64][LDP]: a half of the key tile's k
  float* sV = sK + TILE;        // [64][LDP]: the same half of v, then dS

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int q0 = blockIdx.y * BQ;
  const int q_rows = min(BQ, Tq - q0);
  const int own = blockIdx.z, c0 = own * HALF;  // this block's half: columns of dQ and K
  const int mlen = max(0, min(m_len ? m_len[b] : Tk, Tk));
  // rows below valid_end have an unmasked key; the others have dQ = 0
  const int valid_end = mlen > 0 ? max(0, min(q_len ? q_len[b] : Tq, Tq)) : 0;
  const int rows_end = min(q0 + q_rows, valid_end);
  const size_t q_base = (size_t)bh * Tq * WIDE;
  const size_t k_base = (size_t)bh * Tk * WIDE;
  const size_t stat_base = (size_t)bh * Tq;

  if (rows_end <= q0) {  // no row of the block has a key: zero dQ in the slice, zero delta
    constexpr int CHUNKS = HALF / 4, SHIFT = cpa::log2i(CHUNKS);
    for (int c = tid; c < q_rows * CHUNKS; c += THREADS)
      *reinterpret_cast<float4*>(dq + q_base + (size_t)(q0 + (c >> SHIFT)) * WIDE + c0 +
                                 (c & (CHUNKS - 1)) * 4) = make_float4(0.f, 0.f, 0.f, 0.f);
    if (own == 0) store_zeros(delta_out + stat_base + q0, q_rows, tid);
    return;
  }
  // keys at or past k_end are masked for every row of the block
  const int k_end = causal ? min(mlen, rows_end) : mlen;
  const int n_tiles = (k_end + BK - 1) / BK;

  // Q and dO, both halves, one commit group
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    f32::load_tile_async<THREADS, HALF, WIDE>(sQ + h * TILE, q + q_base + h * HALF, q0, rows_end,
                                              tid);
    f32::load_tile_async<THREADS, HALF, WIDE>(sDO + h * TILE, dout + q_base + h * HALF, q0,
                                              rows_end, tid);
  }
  cpa::cp_async_commit();

  // this thread's rows rg + RS i: O's columns 64 u + 4 cg .. + 3 (u < 4)
  // for delta, m * log2(e) and 1/s; rows without a key take zeros
  const int rg = tid >> 4, cg = tid & 15;  // rows rg + RS i; keys cg + 16 j; columns 4 cg + c
  const float scale2 = scale * f32::LOG2E;
  float4 o_part[NR][WIDE / 64];
  float m2[NR], inv_s[NR], delta[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = q0 + rg + RS * i;
    const bool in = row < rows_end;
#pragma unroll
    for (int u = 0; u < WIDE / 64; ++u)
      o_part[i][u] = in ? *reinterpret_cast<const float4*>(o + q_base + (size_t)row * WIDE +
                                                           64 * u + 4 * cg)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    m2[i] = in ? m_in[stat_base + row] * f32::LOG2E : 0.f;
    inv_s[i] = in ? 1.f / s_in[stat_base + row] : 0.f;
  }
  cpa::cp_async_wait<0>();
  __syncthreads();  // Q and dO have landed

  // delta of rows rg + RS i over the full width, summed over the half-warp;
  // slice 0's lane cg == i writes row rg + RS i
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    float d = 0.f;
#pragma unroll
    for (int u = 0; u < WIDE / 64; ++u) {
      const float4 g = *reinterpret_cast<const float4*>(sDO + (u / 2) * TILE +
                                                        (rg + RS * i) * LDP + 64 * (u % 2) +
                                                        4 * cg);
      const float4& op = o_part[i][u];
      d = fmaf(g.w, op.w, fmaf(g.z, op.z, fmaf(g.y, op.y, fmaf(g.x, op.x, d))));
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    delta[i] = d;
    if (own == 0 && cg == i && rg + RS * i < q_rows) delta_out[stat_base + q0 + rg + RS * i] = d;
  }

  float acc[NR][CW];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;

  // K and V's half h of key tile t into the one stage, once every warp is
  // done with what it held
  auto load_half = [&](int t, int h) {
    __syncthreads();
    f32::load_tile_async<THREADS, HALF, WIDE>(sK, k + k_base + h * HALF, t * BK, k_end, tid);
    f32::load_tile_async<THREADS, HALF, WIDE>(sV, v + k_base + h * HALF, t * BK, k_end, tid);
    cpa::cp_async_commit();
    cpa::cp_async_wait<0>();
    __syncthreads();
  };
  for (int t = 0; t < n_tiles; ++t) {
    const int kt = t * BK;
    const int n_keys = min(BK, k_end - kt);
    // S = Q.K^T and dP = dO.V^T: the other half's products, then this
    // block's own half's added
    float sc[NR][4], dp[NR][4];
    load_half(t, 1 - own);
    f32::dots<NR, 4, false, RS, HALF>(sc, sQ + (1 - own) * TILE, sK, rg, cg);
    f32::dots<NR, 4, false, RS, HALF>(dp, sDO + (1 - own) * TILE, sV, rg, cg);
    load_half(t, own);
    f32::dots<NR, 4, false, RS, HALF, true>(sc, sQ + own * TILE, sK, rg, cg);
    f32::dots<NR, 4, false, RS, HALF, true>(dp, sDO + own * TILE, sV, rg, cg);
    __syncthreads();  // every warp is done reading V: dS goes over it
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int row = q0 + rg + RS * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt + cg + 16 * j;
        // a masked key of a row with a key has P = exp(NEG - m) = 0 exactly;
        // rows without a key take no part
        const bool unmasked = row < rows_end && key < k_end && (!causal || key <= row);
        const float p = exp2f(fmaf(sc[i][j], scale2, -m2[i])) * inv_s[i];
        sV[(rg + RS * i) * LDP + cg + 16 * j] = unmasked ? p * (dp[i][j] - delta[i]) : 0.f;
      }
    }
    __syncwarp();  // a half-warp reads the dS rows that it wrote
    f32::accumulate<NR, RS, HALF>(acc, sV, sK, rg, cg, n_keys);  // dQ += dS . K, own half
  }

  // dQ * scale in the block's slice, 16 bytes a row and thread; rows without
  // a key are zeros
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = rg + RS * i;
    if (r >= q_rows) continue;
#pragma unroll
    for (int h = 0; h < HALF / 64; ++h)
      *reinterpret_cast<float4*>(dq + q_base + (size_t)(q0 + r) * WIDE + c0 + 64 * h + 4 * cg) =
          make_float4(acc[i][4 * h] * scale, acc[i][4 * h + 1] * scale, acc[i][4 * h + 2] * scale,
                      acc[i][4 * h + 3] * scale);
  }
}

cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* dout,
                        const void* o, const void* q_len, const void* m_len, const void* m,
                        const void* s, void* delta, void* dq, int B, int H, int Tq, int Tk,
                        float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;  // above 48 KB needs an explicit opt-in
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(masked_attention_bwd_dq_wide_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)WIDE_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ, WIDE / HALF);
  masked_attention_bwd_dq_wide_kernel<<<grid, THREADS, WIDE_SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(o),
      static_cast<const int*>(q_len), static_cast<const int*>(m_len),
      static_cast<const float*>(m), static_cast<const float*>(s), static_cast<float*>(delta),
      static_cast<float*>(dq), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, dout, o: contiguous fp32 [B, H, Tq, D]; k, v: fp32 [B, H, Tk, D], D =
// 64, 128, 256 or a multiple of 128 above (the wide kernel,
// masked_attention_wide.cu); q_len, m_len: int32 [B] or null; m, s: fp32 [B, H, Tq] (the
// forward's row max and row sum); delta: fp32 [B, H, Tq], written
// (rowsum(dO * O) on rows with a key, else 0); dq like q. Returns the CUDA
// error code of the launch.
extern "C" int masked_attention_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* o, const void* q_len,
                                       const void* m_len, const void* m, const void* s,
                                       void* delta, void* dq, int B, int H, int Tq, int Tk,
                                       int D, float scale, int causal, void* stream) {
  if ((D != 64 && D != 128 && D != WIDE && !wide::takes(D)) || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 ||
      (Tq + BQ - 1) / BQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide::takes(D)) {  // every multiple of 128 above 256
    return (int)wide::dq_f32(q, k, v, dout, o, q_len, m_len, m, s, delta, dq, B, H, Tq, Tk, D, scale, causal, st);
  }
  if (D == WIDE) {
    return (int)launch_wide(q, k, v, dout, o, q_len, m_len, m, s, delta, dq, B, H, Tq, Tk, scale,
                            causal, st);
  }
  return (int)(D == 128 ? launch<128>(q, k, v, dout, o, q_len, m_len, m, s, delta, dq, B, H, Tq,
                                      Tk, scale, causal, st)
                        : launch<64>(q, k, v, dout, o, q_len, m_len, m, s, delta, dq, B, H, Tq,
                                     Tk, scale, causal, st));
}

// Dynamic shared memory each D = 64 block asks for, in bytes (a D = 128 or
// D = 256 block 202,752).
extern "C" int masked_attention_bwd_dq_shared_bytes(void) { return (int)smem_bytes<64>(); }
