// Masked multi-head attention, backward, the dK/dV kernel, fp32 FMAs, for
// sm_90a. Plain C interface, bound from Python with ctypes
// (vaenar_tts_torch/ops/flash_attention.py, masked_flash_attention_backward);
// fp32 inputs take this kernel, bf16 ones masked_attention_bwd_dkv_tc.cu.
// It reads the delta = rowsum(dO * O) that the fp32 dQ kernel
// (masked_attention_bwd.cu), launched before it, writes (0 on the rows
// without a key, whose dS is 0).
//
// Replaces _dkv_kernel of vaenar_tts_tpu/ops/flash_attention.py (l.370,
// pallas_call l.467) for fp32 inputs. The TPU kernel accumulates over a
// sequential grid axis of q-blocks; here a block owns 64 keys and loops
// over the q-tiles itself, so nothing is carried between blocks and nothing
// is atomic.
//
// Contract (masked_attention_bwd.cu's): from the forward's row stats (max m,
// sum s) and delta = rowsum(dO * O),
//   P  = exp(where(mask, q.k^T * scale, NEG) - m) / s
//   dV = P^T . dO                       (every row of P counts)
//   dS = where(mask, P * (dO.V^T - delta), 0)
//   dK = dS^T . Q * scale
// fp32 inputs, arithmetic, accumulators and outputs; keys past Tk and rows
// past Tq do not exist.
//
// What bounds it on an H100 at the training path's shapes (batch 32, H=4,
// D=64, text 32, reduced mel 240 at r = 2, of which 55-98 rows are valid):
// bytes, by the count in chip_smoke.py (an unmasked (row, key) pair costs
// 8*D operations, but the rows read and the gradients written whole
// outweigh them about threefold). What held the first version back,
// and what this design does about it:
//   * one chain of q-tiles a block, 8 warps on each 64 x 64 product, one
//     block an SM at the 128-block sites: here the block's two warp groups
//     (4 warps each) split its q-tiles (even and odd), each with its own
//     ring, named barrier and exchange tile, so a block's chain is half as
//     long, and sum their dK/dV partials through shared memory at the end
//     (group 0 stores dK, group 1 dV);
//   * products on absent keys (Tk = 32 sites ran 64-key loops): a thread's
//     keys are rg + 8 i, so a block with at most 32 keys below m_len takes
//     i < 4 only, and a q-tile with at most 32 valid rows computes only
//     those;
//   * Q and dO loaded synchronously, a barrier after each: here they stream
//     through a two-stage cp.async ring of 16-byte copies, the next q-tile
//     loading while this one multiplies; the q-tile's m * log2(e), 1/s and
//     delta sit in shared memory, fetched one q-tile ahead, so that P costs
//     one exp2 and one multiply, no division;
//   * the padding rows' dO / s pass divided per element with 4-byte loads:
//     here 16-byte loads, 8 in flight a thread, one reciprocal a row, issued
//     after the first copies;
//   * 8 scalar shared loads per 32 FMAs: here a thread owns 8 x 4 of S^T,
//     dP^T, dK and dV, read with 16-byte loads (tile_f32.cuh), 12 loads per
//     128 FMAs; their count still holds the products to about half of the
//     fp32 FMA rate (PERF.md §6).
// Per q-tile and group: S^T = K.Q^T -> P^T (to the exchange tile),
// dV += P^T.dO, dP^T = V.dO^T -> dS^T = P^T * (dP^T - delta) (over P^T in
// the exchange tile), dK += dS^T.Q. P^T and dS^T are exchanged within a
// half-warp (the 16 threads of a key group), so __syncwarp orders them.
//
// Work skipped without changing the result (as the first version):
//   * a row with nothing unmasked (row >= q_len, or every row when
//     m_len == 0) has m = NEG and s = Tk, so P = 1/s on all Tk keys and
//     dS = 0: it adds dO_row / s_row to every dV row and nothing to dK. The
//     block sums those rows' dO / s once and adds the sum to every dV row;
//   * the q-tile loop covers only the rows with an unmasked key, stops at
//     q_len, skips key blocks at or past m_len and, when causal, starts at
//     the key block's first row: every skipped term is exp(NEG - m) = 0.
//
// Shared memory: K and V, and for each group a two-stage Q/dO ring, the
// exchange tile and two stages of statistics: 12 tiles of 64 x 68 fp32 and
// 3,328 bytes more, 212,224 bytes a block (one block an SM).

// Head widths. A template of the head width, compiled for D = 64 (the
// design above) and D = 128; the C entry point runs the one its D names.
// At D = 128 two groups' rings do not fit in shared memory, so one warp
// group of all 256 threads walks every q-tile (tile_f32.cuh's RS = 16): a
// thread owns 4 keys by 8 columns of dK and dV, as many accumulators as at
// D = 64, and nothing is handed between groups at the end. The exchange
// tile keeps 68-float rows (64 keys by 64 rows): 6 tiles of 64 x 132 fp32
// and it, 222,208 bytes a block. Registers in PERF.md §6.
//
// D = 256: a kernel of its own (masked_attention_bwd_dkv_wide_kernel). A
// row of 256 fp32 is two tiles of 128 columns (64 x 132). S^T and dP^T read
// K, V, Q and dO at the full width, and the D = 128 layout at that width
// does not fit. So the grid gains an axis over two column slices of dK and
// dV, and a block (the D = 128 thread layout: one group of 256 threads, 4
// keys by 8 columns a thread) holds K's and V's two halves and streams each
// q-tile through one stage as two halves of Q and dO: the other slice's
// half first, S^T and dP^T from its products, then the block's own half,
// whose products add to them and which stays for dV += P^T.dO and dK +=
// dS^T.Q. The padding rows' dO / s is summed in the slice's columns. 6
// tiles of 64 x 132, the exchange tile and the statistics: 221,440 bytes.

#include "attention_wide.cuh"
#include "tile_f32.cuh"

namespace {

using f32::NEG;

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per block
constexpr int THREADS = 256;
constexpr int STAGES = 2;  // Q/dO tiles in a group's ring: one loads while one multiplies
constexpr int LDS = f32::ldp<64>();  // row stride of the exchange tile (64 keys x 64 rows)

// The layout of a block at head width HD. D = 64: two warp groups of 128
// threads that split the q-tiles, a thread owning 8 keys (rows rg + 8 i of
// S^T) by 4 columns; D = 128: the tiles of two groups' rings do not fit in
// shared memory, so one group of all 256 threads walks every q-tile, a
// thread owning 4 keys (rg + 16 i, tile_f32.cuh's RS = 16) by 8 columns, as
// many accumulators a thread as at D = 64.
template <int HD>
struct Layout {
  static constexpr int GROUPS = HD == 64 ? 2 : 1;
  static constexpr int GROUP_THREADS = THREADS / GROUPS;
  static constexpr int RS = GROUP_THREADS / 16;  // key groups: keys rg + RS i
  static constexpr int NK = BK / RS;             // keys a thread
  static constexpr int CW = HD / 16;             // accumulator columns a thread
  static constexpr int TILE = f32::tile<HD>();
  static constexpr int X_TILE = BK * LDS;  // the exchange tile, P^T then dS^T
  // a group's Q and dO rings, exchange tile and statistics
  static constexpr int GROUP_FLOATS = 2 * STAGES * TILE + X_TILE + STAGES * 3 * BQ;
  static constexpr size_t SMEM_BYTES = sizeof(float) * (2 * TILE + HD + GROUPS * GROUP_FLOATS);
};

// One q-tile of one group: NI = NK keys a thread (NK / 2 when the block
// has at most 32 keys below m_len), NJ = 4 rows a thread in S^T and dP^T (2
// when the tile has at most 32 valid rows).
template <int HD, int NI, int NJ>
__device__ __forceinline__ void dkv_tile(float (&acc_dk)[Layout<HD>::NK][HD / 16],
                                         float (&acc_dv)[Layout<HD>::NK][HD / 16],
                                         const float* sK, const float* sV, const float* tQ,
                                         const float* tDO, float* sX, const float* stat, int rg,
                                         int cg, int k0, int qt, int n_rows, int r_end, int mlen,
                                         int causal, float scale2) {
  constexpr int RS = Layout<HD>::RS;
  float x[Layout<HD>::NK][4];
  // S^T = K.Q^T, then P^T: rows past r_end and masked pairs take 0 (the
  // latter exactly exp(NEG - m) of a real m)
  f32::dots<NI, NJ, false, RS, HD>(x, sK, tQ, rg, cg);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int key = k0 + rg + RS * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int rl = cg + 16 * j, row = qt + rl;
      const bool unmasked = row < r_end && key < mlen && (!causal || key <= row);
      sX[(rg + RS * i) * LDS + rl] =
          unmasked ? exp2f(fmaf(x[i][j], scale2, -stat[rl])) * stat[BQ + rl] : 0.f;
    }
  }
  __syncwarp();
  f32::accumulate<NI, RS, HD, LDS>(acc_dv, sX, tDO, rg, cg, n_rows);  // dV += P^T.dO
  f32::dots<NI, NJ, false, RS, HD>(x, sV, tDO, rg, cg);              // dP^T = V.dO^T
  __syncwarp();  // the half-warp is done reading P^T
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float* p = sX + (rg + RS * i) * LDS + cg + 16 * j;
      *p *= x[i][j] - stat[2 * BQ + cg + 16 * j];  // dS^T = P^T * (dP^T - delta)
    }
  __syncwarp();
  f32::accumulate<NI, RS, HD, LDS>(acc_dk, sX, tQ, rg, cg, n_rows);  // dK += dS^T.Q
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
masked_attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const int* __restrict__ q_len, const int* __restrict__ m_len,
                                const float* __restrict__ m_in, const float* __restrict__ s_in,
                                const float* __restrict__ delta_in, float* __restrict__ dk,
                                float* __restrict__ dv, int H, int Tq, int Tk, float scale,
                                int causal) {
  using L = Layout<HD>;
  constexpr int GROUPS = L::GROUPS, GROUP_THREADS = L::GROUP_THREADS, RS = L::RS, NK = L::NK;
  constexpr int CW = L::CW, TILE = L::TILE, GROUP_FLOATS = L::GROUP_FLOATS;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;          // [64][ldp(HD)], this block's keys
  float* sV = sK + TILE;     // [64][ldp(HD)]
  float* usum = sV + TILE;   // [HD]: sum of the uniform rows' dO / s
  const int tid = threadIdx.x, group = tid / GROUP_THREADS, gtid = tid % GROUP_THREADS;
  float* sQ = usum + HD + group * GROUP_FLOATS;  // [STAGES][64][ldp(HD)], this group's ring
  float* sDO = sQ + STAGES * TILE;               // [STAGES][64][ldp(HD)]
  float* sX = sDO + STAGES * TILE;               // [64][LDS]: P^T, then dS^T
  float* sStat = sX + L::X_TILE;  // [STAGES][3][BQ]: m * log2(e), 1/s, delta

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int k0 = blockIdx.y * BK;
  const int k_rows = min(BK, Tk - k0);
  const int mlen = max(0, min(m_len ? m_len[b] : Tk, Tk));
  // rows below valid_end have an unmasked key; the others are uniform
  const int valid_end = mlen > 0 ? max(0, min(q_len ? q_len[b] : Tq, Tq)) : 0;
  const size_t q_base = (size_t)bh * Tq * HD;
  const size_t k_base = (size_t)bh * Tk * HD;
  const size_t stat_base = (size_t)bh * Tq;

  // Rows below valid_end see no key of this block when the block starts at
  // or past m_len; when causal, rows before the block's first key see none.
  const int r_begin = causal ? k0 : 0;
  const int r_end = k0 < mlen ? valid_end : 0;
  const int n_tiles = r_begin < r_end ? (r_end - r_begin + BQ - 1) / BQ : 0;

  // K and V (keys at or past m_len load as zeros: every pair with them is
  // masked) and each group's first q-tile, one commit group
  if (n_tiles > 0) {
    f32::load_tile_async<THREADS, HD>(sK, k + k_base, k0, mlen, tid);
    f32::load_tile_async<THREADS, HD>(sV, v + k_base, k0, mlen, tid);
    if (group < n_tiles) {
      f32::load_tile_async<GROUP_THREADS, HD>(sQ, q + q_base, r_begin + group * BQ, r_end, gtid);
      f32::load_tile_async<GROUP_THREADS, HD>(sDO, dout + q_base, r_begin + group * BQ, r_end,
                                              gtid);
    }
  }
  cpa::cp_async_commit();

  // A q-tile's statistics, a row a thread (gtid < BQ), are fetched one tile
  // ahead into registers, so that their latency hides behind the products;
  // rows at or past r_end take m = 0, s = 1, delta = 0 (unused).
  float next_stat[3];
  auto fetch_stats = [&](int t) {
    const int row = r_begin + t * BQ + gtid;
    const bool in = gtid < BQ && row < r_end;
    next_stat[0] = in ? m_in[stat_base + row] : 0.f;
    next_stat[1] = in ? s_in[stat_base + row] : 1.f;
    next_stat[2] = in ? delta_in[stat_base + row] : 0.f;
  };
  auto store_stats = [&](int stage) {
    if (gtid < BQ) {
      float* st = sStat + stage * 3 * BQ;
      st[gtid] = next_stat[0] * f32::LOG2E;
      st[BQ + gtid] = 1.f / next_stat[1];
      st[2 * BQ + gtid] = next_stat[2];
    }
  };
  if (group < n_tiles) fetch_stats(group);

  // Rows in [valid_end, Tq) are uniform over the Tk keys: each adds
  // dO_row / s_row to every dV row. Summed once, while the copies land;
  // scratch is group 0's exchange tile.
  f32::column_sums<THREADS, 8, HD>(usum, smem + 2 * TILE + HD + 2 * STAGES * TILE,
                                   dout + q_base, valid_end, Tq, s_in + stat_base);
  if (group < n_tiles) store_stats(0);
  if (group + GROUPS < n_tiles) fetch_stats(group + GROUPS);
  cpa::cp_async_wait<0>();
  __syncthreads();  // K, V, the first q-tiles and their statistics are in

  // keys rg + RS i; rows cg + 16 j; columns 64 h + 4 cg + c
  const int rg = gtid >> 4, cg = gtid & 15;
  const float scale2 = scale * f32::LOG2E;
  const bool all_keys = mlen - k0 > 32;
  float acc_dk[NK][CW], acc_dv[NK][CW];
#pragma unroll
  for (int i = 0; i < NK; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  // this group's q-tiles: group, group + GROUPS, ...
  for (int it = 0, t = group; t < n_tiles; ++it, t += GROUPS) {
    const int buf = it % STAGES;
    if (it > 0) {
      store_stats(buf);  // its stage was last read two tiles ago
      if (t + GROUPS < n_tiles) fetch_stats(t + GROUPS);
      cpa::cp_async_wait<0>();  // q-tile t has landed
      cpa::group_sync(1 + group, GROUP_THREADS);  // ... for the group, which is done with it - 1
    }
    const int ahead = t + GROUPS;
    if (ahead < n_tiles) {  // into the stage of tile it - 1
      const int row0 = r_begin + ahead * BQ;
      f32::load_tile_async<GROUP_THREADS, HD>(sQ + (1 - buf) * TILE, q + q_base, row0, r_end,
                                              gtid);
      f32::load_tile_async<GROUP_THREADS, HD>(sDO + (1 - buf) * TILE, dout + q_base, row0, r_end,
                                              gtid);
    }
    cpa::cp_async_commit();
    const int qt = r_begin + t * BQ;
    const int n_rows = min(BQ, r_end - qt);
    const float* tQ = sQ + buf * TILE;
    const float* tDO = sDO + buf * TILE;
    const float* stat = sStat + buf * 3 * BQ;
    if (all_keys) {
      if (n_rows > 32) {
        dkv_tile<HD, NK, 4>(acc_dk, acc_dv, sK, sV, tQ, tDO, sX, stat, rg, cg, k0, qt, n_rows,
                            r_end, mlen, causal, scale2);
      } else {
        dkv_tile<HD, NK, 2>(acc_dk, acc_dv, sK, sV, tQ, tDO, sX, stat, rg, cg, k0, qt, n_rows,
                            r_end, mlen, causal, scale2);
      }
    } else if (n_rows > 32) {
      dkv_tile<HD, NK / 2, 4>(acc_dk, acc_dv, sK, sV, tQ, tDO, sX, stat, rg, cg, k0, qt, n_rows,
                              r_end, mlen, causal, scale2);
    } else {
      dkv_tile<HD, NK / 2, 2>(acc_dk, acc_dv, sK, sV, tQ, tDO, sX, stat, rg, cg, k0, qt, n_rows,
                              r_end, mlen, causal, scale2);
    }
  }
  cpa::cp_async_wait<0>();
  __syncthreads();  // both groups are done with their rings

  if constexpr (GROUPS == 1) {
    // one group: dK * scale and dV plus the uniform rows' sum, 16 bytes a
    // row and thread
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int key = rg + RS * i;
      if (key >= k_rows) continue;
#pragma unroll
      for (int h = 0; h < HD / 64; ++h) {
        const float* u = usum + 64 * h + 4 * cg;
        const size_t at = k_base + (size_t)(k0 + key) * HD + 64 * h + 4 * cg;
        *reinterpret_cast<float4*>(dk + at) =
            make_float4(acc_dk[i][4 * h] * scale, acc_dk[i][4 * h + 1] * scale,
                        acc_dk[i][4 * h + 2] * scale, acc_dk[i][4 * h + 3] * scale);
        *reinterpret_cast<float4*>(dv + at) =
            make_float4(acc_dv[i][4 * h] + u[0], acc_dv[i][4 * h + 1] + u[1],
                        acc_dv[i][4 * h + 2] + u[2], acc_dv[i][4 * h + 3] + u[3]);
      }
    }
  } else {
    // Group 0 hands its dV partial to group 1 and group 1 its dK partial to
    // group 0, each through its own ring, element-major so that lanes hit
    // distinct banks; then group 0 stores dK * scale and group 1 dV plus the
    // uniform rows' sum, 16 bytes a row and thread.
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c)
        sQ[(CW * i + c) * GROUP_THREADS + gtid] = group == 0 ? acc_dv[i][c] : acc_dk[i][c];
    __syncthreads();
    const float* other = usum + HD + (1 - group) * GROUP_FLOATS;
    float* out = group == 0 ? dk : dv;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int key = rg + RS * i;
      if (key >= k_rows) continue;
      float g[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float part = other[(CW * i + c) * GROUP_THREADS + gtid];
        g[c] = group == 0 ? (acc_dk[i][c] + part) * scale
                          : acc_dv[i][c] + part + usum[64 * (c / 4) + 4 * cg + c % 4];
      }
#pragma unroll
      for (int h = 0; h < HD / 64; ++h)
        *reinterpret_cast<float4*>(out + k_base + (size_t)(k0 + key) * HD + 64 * h + 4 * cg) =
            make_float4(g[4 * h], g[4 * h + 1], g[4 * h + 2], g[4 * h + 3]);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* q_len, const void* m_len, const void* m, const void* s,
                   const void* delta, void* dk, void* dv, int B, int H, int Tq, int Tk,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t SMEM_BYTES = Layout<HD>::SMEM_BYTES;
  static bool smem_set = false;  // above 48 KB needs an explicit opt-in, per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(masked_attention_bwd_dkv_kernel<HD>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(B * H, (Tk + BK - 1) / BK);
  masked_attention_bwd_dkv_kernel<HD><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const int*>(q_len),
      static_cast<const int*>(m_len), static_cast<const float*>(m),
      static_cast<const float*>(s), static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

// D = 256: f32::HALF columns a tile, two tiles a row; see the head-width
// note at the top. Q-tiles stream in halves through one stage.
using f32::HALF;
using f32::WIDE;
constexpr int WIDE_RS = 16;             // key groups: keys rg + 16 i
constexpr int WIDE_NK = BK / WIDE_RS;   // keys a thread
constexpr size_t WIDE_SMEM_BYTES =
    sizeof(float) * (6 * f32::tile<HALF>() + BK * LDS + 3 * BQ + HALF);

__global__ void __launch_bounds__(THREADS, 1)
masked_attention_bwd_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     const float* __restrict__ dout,
                                     const int* __restrict__ q_len,
                                     const int* __restrict__ m_len,
                                     const float* __restrict__ m_in,
                                     const float* __restrict__ s_in,
                                     const float* __restrict__ delta_in, float* __restrict__ dk,
                                     float* __restrict__ dv, int H, int Tq, int Tk, float scale,
                                     int causal) {
  constexpr int TILE = f32::tile<HALF>(), RS = WIDE_RS, NK = WIDE_NK;
  constexpr int CW = HALF / 16;  // accumulator columns a thread: 64 h + 4 cg + c
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;            // [2][64][ldp(HALF)]: the block's keys' k, columns 0-127, 128-255
  float* sV = sK + 2 * TILE;   // [2][64][ldp(HALF)]: the same of v
  float* sQ = sV + 2 * TILE;   // [64][ldp(HALF)]: a half of the q-tile's q
  float* sDO = sQ + TILE;      // [64][ldp(HALF)]: the same half of dO
  float* sX = sDO + TILE;      // [64][LDS]: P^T, then dS^T; the padding sums' scratch before
  float* sStat = sX + BK * LDS;  // [3][BQ]: the q-tile's m * log2(e), 1/s, delta
  float* usum = sStat + 3 * BQ;  // [HALF]: the uniform rows' dO / s in the block's slice

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int k0 = blockIdx.y * BK;
  const int k_rows = min(BK, Tk - k0);
  const int own = blockIdx.z, c0 = own * HALF;  // this block's half: columns of dK, dV, Q, dO
  const int mlen = max(0, min(m_len ? m_len[b] : Tk, Tk));
  // rows below valid_end have an unmasked key; the others are uniform
  const int valid_end = mlen > 0 ? max(0, min(q_len ? q_len[b] : Tq, Tq)) : 0;
  const size_t q_base = (size_t)bh * Tq * WIDE;
  const size_t k_base = (size_t)bh * Tk * WIDE;
  const size_t stat_base = (size_t)bh * Tq;

  // as masked_attention_bwd_dkv_kernel: the q-tiles that see this block's keys
  const int r_begin = causal ? k0 : 0;
  const int r_end = k0 < mlen ? valid_end : 0;
  const int n_tiles = r_begin < r_end ? (r_end - r_begin + BQ - 1) / BQ : 0;

  // K and V, both halves (keys at or past m_len load as zeros), one commit
  // group
  if (n_tiles > 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      f32::load_tile_async<THREADS, HALF, WIDE>(sK + h * TILE, k + k_base + h * HALF, k0, mlen,
                                                tid);
      f32::load_tile_async<THREADS, HALF, WIDE>(sV + h * TILE, v + k_base + h * HALF, k0, mlen,
                                                tid);
    }
  }
  cpa::cp_async_commit();

  // Rows in [valid_end, Tq) are uniform over the Tk keys: each adds
  // dO_row / s_row to every dV row. Summed once in the slice's columns,
  // while the copies land.
  f32::column_sums<THREADS, 8, HALF, WIDE>(usum, sX, dout + q_base + c0, valid_end, Tq,
                                           s_in + stat_base);

  const int rg = tid >> 4, cg = tid & 15;  // keys rg + RS i; rows cg + 16 j; columns 64 h + 4 cg + c
  const float scale2 = scale * f32::LOG2E;
  float acc_dk[NK][CW], acc_dv[NK][CW];
#pragma unroll
  for (int i = 0; i < NK; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  // Q and dO's half h of the q-tile at row qt into the one stage (and, with
  // the first half, the tile's statistics, a row a thread; rows at or past
  // r_end take m = 0, 1/s = 1, delta = 0, unused), once every warp is done
  // with what it held
  auto load_half = [&](int qt, int h, bool stats) {
    __syncthreads();
    f32::load_tile_async<THREADS, HALF, WIDE>(sQ, q + q_base + h * HALF, qt, r_end, tid);
    f32::load_tile_async<THREADS, HALF, WIDE>(sDO, dout + q_base + h * HALF, qt, r_end, tid);
    cpa::cp_async_commit();
    if (stats && tid < BQ) {
      const int row = qt + tid;
      const bool in = row < r_end;
      sStat[tid] = in ? m_in[stat_base + row] * f32::LOG2E : 0.f;
      sStat[BQ + tid] = in ? 1.f / s_in[stat_base + row] : 1.f;
      sStat[2 * BQ + tid] = in ? delta_in[stat_base + row] : 0.f;
    }
    cpa::cp_async_wait<0>();
    __syncthreads();
  };
  for (int t = 0; t < n_tiles; ++t) {
    const int qt = r_begin + t * BQ;
    const int n_rows = min(BQ, r_end - qt);
    // S^T = K.Q^T and dP^T = V.dO^T: the other half's products, then this
    // block's own half's added
    float x[NK][4], dpt[NK][4];
    load_half(qt, 1 - own, true);
    f32::dots<NK, 4, false, RS, HALF>(x, sK + (1 - own) * TILE, sQ, rg, cg);
    f32::dots<NK, 4, false, RS, HALF>(dpt, sV + (1 - own) * TILE, sDO, rg, cg);
    load_half(qt, own, false);
    f32::dots<NK, 4, false, RS, HALF, true>(x, sK + own * TILE, sQ, rg, cg);
    f32::dots<NK, 4, false, RS, HALF, true>(dpt, sV + own * TILE, sDO, rg, cg);
    // P^T: rows past r_end and masked pairs take 0 (the latter exactly
    // exp(NEG - m) of a real m)
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int key = k0 + rg + RS * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = cg + 16 * j, row = qt + rl;
        const bool unmasked = row < r_end && key < mlen && (!causal || key <= row);
        sX[(rg + RS * i) * LDS + rl] =
            unmasked ? exp2f(fmaf(x[i][j], scale2, -sStat[rl])) * sStat[BQ + rl] : 0.f;
      }
    }
    __syncwarp();
    f32::accumulate<NK, RS, HALF, LDS>(acc_dv, sX, sDO, rg, cg, n_rows);  // dV += P^T.dO
    __syncwarp();  // the half-warp is done reading P^T
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* p = sX + (rg + RS * i) * LDS + cg + 16 * j;
        *p *= dpt[i][j] - sStat[2 * BQ + cg + 16 * j];  // dS^T = P^T * (dP^T - delta)
      }
    __syncwarp();
    f32::accumulate<NK, RS, HALF, LDS>(acc_dk, sX, sQ, rg, cg, n_rows);  // dK += dS^T.Q
  }

  // dK * scale and dV plus the uniform rows' sum in the block's slice, 16
  // bytes a row and thread
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const int key = rg + RS * i;
    if (key >= k_rows) continue;
#pragma unroll
    for (int h = 0; h < HALF / 64; ++h) {
      const float* u = usum + 64 * h + 4 * cg;
      const size_t at = k_base + (size_t)(k0 + key) * WIDE + c0 + 64 * h + 4 * cg;
      *reinterpret_cast<float4*>(dk + at) =
          make_float4(acc_dk[i][4 * h] * scale, acc_dk[i][4 * h + 1] * scale,
                      acc_dk[i][4 * h + 2] * scale, acc_dk[i][4 * h + 3] * scale);
      *reinterpret_cast<float4*>(dv + at) =
          make_float4(acc_dv[i][4 * h] + u[0], acc_dv[i][4 * h + 1] + u[1],
                      acc_dv[i][4 * h + 2] + u[2], acc_dv[i][4 * h + 3] + u[3]);
    }
  }
}

cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* dout,
                        const void* q_len, const void* m_len, const void* m, const void* s,
                        const void* delta, void* dk, void* dv, int B, int H, int Tq, int Tk,
                        float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;  // above 48 KB needs an explicit opt-in
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(masked_attention_bwd_dkv_wide_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)WIDE_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(B * H, (Tk + BK - 1) / BK, WIDE / HALF);
  masked_attention_bwd_dkv_wide_kernel<<<grid, THREADS, WIDE_SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const int*>(q_len),
      static_cast<const int*>(m_len), static_cast<const float*>(m),
      static_cast<const float*>(s), static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, dout: contiguous fp32 [B, H, Tq, D]; k, v: fp32 [B, H, Tk, D], D = 64,
// 128, 256 or a multiple of 128 above (the wide kernel,
// masked_attention_wide.cu); q_len, m_len: int32 [B] or null; m, s, delta: fp32 [B, H, Tq]
// (the forward's row max and row sum, and rowsum(dO * O)); dk, dv like k.
// Returns the CUDA error code of the launch.
extern "C" int masked_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* q_len,
                                        const void* m_len, const void* m, const void* s,
                                        const void* delta, void* dk, void* dv, int B,
                                        int H, int Tq, int Tk, int D, float scale,
                                        int causal, void* stream) {
  if ((D != 64 && D != 128 && D != WIDE && !wide::takes(D)) || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 ||
      (Tk + BK - 1) / BK > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide::takes(D)) {  // every multiple of 128 above 256
    return (int)wide::dkv_f32(q, k, v, dout, q_len, m_len, m, s, delta, dk, dv, B, H, Tq, Tk, D, scale, causal, st);
  }
  if (D == WIDE) {
    return (int)launch_wide(q, k, v, dout, q_len, m_len, m, s, delta, dk, dv, B, H, Tq, Tk,
                            scale, causal, st);
  }
  return (int)(D == 128 ? launch<128>(q, k, v, dout, q_len, m_len, m, s, delta, dk, dv, B, H,
                                      Tq, Tk, scale, causal, st)
                        : launch<64>(q, k, v, dout, q_len, m_len, m, s, delta, dk, dv, B, H, Tq,
                                     Tk, scale, causal, st));
}

// Dynamic shared memory each D = 64 block asks for, in bytes (a D = 128
// block 222,208, a D = 256 block 221,440).
extern "C" int masked_attention_bwd_dkv_shared_bytes(void) {
  return (int)Layout<64>::SMEM_BYTES;
}
