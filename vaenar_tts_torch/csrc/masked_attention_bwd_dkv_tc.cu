// Masked multi-head attention, backward, the dK/dV kernel, bf16 on Hopper's
// tensor cores (wgmma), for sm_90a. Plain C interface, bound from Python
// with ctypes (vaenar_tts_torch/ops/flash_attention.py,
// masked_flash_attention_backward); bf16 inputs take this kernel, fp32 ones
// masked_attention_bwd_dkv.cu. At bf16 the dQ kernel,
// masked_attention_bwd_dq_tc.cu, launched before this one on the same
// stream, forms delta = rowsum(dO * O) and writes it; this kernel reads it.
//
// Replaces _dkv_kernel of vaenar_tts_tpu/ops/flash_attention.py (l.370,
// pallas_call l.467) for bf16 inputs.
//
// Contract (masked_attention_bwd.cu's): from the forward's row stats (max m,
// sum s) and delta = rowsum(dO * O),
//   P  = exp(where(mask, q.k^T * scale, NEG) - m) / s
//   dV = P^T . dO                       (every row of P counts)
//   dS = where(mask, P * (dO.V^T - delta), 0)
//   dK = dS^T . Q * scale
// written in bf16; keys past Tk and rows past Tq do not exist.
//
// What bounds it on an H100 at the training path's bf16 shapes (batch 32,
// H=4, D=64, text 32, reduced mel 240 at r = 2, of which 54-144 rows are
// valid): not bytes or operations. By chip_smoke.py's count an unmasked
// (row, key) pair costs 8*D operations, 4.3 GFLOP a train step at r = 2
// (4.4 us at 989 TFLOP/s), and the rows read and the gradients written
// whole (zero rows included) come to ~20 MB in bf16 (6 us at 3.35 TB/s),
// 0.112 ms a step over 36 launches. A launch lasts as long as its heaviest
// block's chain (scripts/torch_attention_blocks.py times every block): the
// lengths, the loads of K, V and the first q-tile, then per q-tile two
// rounds of products with the exponentials between them, then the sum over
// the padding rows of dO / s and the store. With one warp group a block,
// each scheduler of the SM has one warp of the chain to issue, so the
// elementwise work (P, dS, their hi/lo splits) weighs as much as the
// products; and a block's bytes move through one SM's share of the memory
// system, so the padding rows' ~100-190 rows of dO cost as much as the
// loads of K, V and the first q-tile together.
//
// Design for that chain. A block of one warp group (4 warps, 128 threads)
// owns 64 keys of one (b, h), with fp32 accumulators for their 64 rows of
// dK and dV in registers (wgmma's D fragments: each warp 16 keys). K and V
// stay in shared memory; Q and dO stream through a two-stage ring of 64-row
// tiles, the next tile loading while the current one multiplies. All tiles
// land in wgmma's 128-byte-swizzled layout straight from cp.async (16 bytes
// a thread; chunk c of row r at c ^ (r & 7)). Per q-tile, wgmma.mma_async
// over the warp group (m64nNk16, bf16 in, fp32 accumulate):
//   S^T  = K . Q^T    (K and Q from shared memory, both K-major)
//   dP^T = V . dO^T   (the same, with V and dO)
//   dV  += P^T . dO   (P^T from registers, dO an MN-major B)
//   dK  += dS^T . Q   (dS^T from registers, Q an MN-major B)
// P^T and dS^T are formed in fp32 registers from S^T and dP^T with the
// q-tile's m log2(e), 1/s and delta, which sit in shared memory; the D
// fragment of the first two products is the A fragment of the last two.
//   * The q-tile is narrowed to its valid rows, rounded up to 16: N of the
//     first two products and the k-steps of the last two are 16, 32, 48 or
//     64 rows, each width its own instantiation, so that rows 64-97 of an
//     item cost 48 rows, not 64.
//   * Fewer instructions on the chain: each key's mask against the tile is
//     a bound on the column, skipped by a warp whose keys see every row;
//     P is one fma and ex2; a column's stats are read as float2.
//   * The padding rows of dO (the first 192, and their s) are copied into
//     shared memory with the first q-tile's prefetch, so they land while
//     the products run, and are summed after the loop.
//   * A programmatic dependent launch: the dQ kernel lets this grid start
//     while it runs, and a block loads its tiles and starts the padding
//     rows' copy before it waits for the dQ grid (griddepcontrol.wait)
//     and reads delta.
//
// P's and dS's precision: the plain version keeps them fp32. Here P^T and
// dS^T are each split into a bf16 high and low part, and each of the last two
// products is two products (about 16 bits kept, relative error <= 2^-17).
// Rounded once to bf16 they exceeded chip_smoke.py's bf16 tolerance,
// 1e-3 + 2^-7 |g| (unchanged), at every checked shape; with the split, the
// measured worst share of that tolerance is in PERF.md §6.
//
// Work skipped without changing the result (as masked_attention_bwd.cu):
//   * a row with nothing unmasked (row >= q_len, or every row when
//     m_len == 0) has m = NEG and s = Tk, so P = 1/s on all Tk keys and
//     dS = 0: it adds dO_row / s_row to every dV row and nothing to dK. The
//     block sums those rows' dO / s once (one pass over dO, fp32) and adds
//     that sum to its dV accumulators;
//   * the q-tile loop covers only the rows with an unmasked key, stops at
//     q_len, skips key blocks at or past m_len and, when causal, starts at
//     the key block's first row: every skipped term is exp(NEG - m) = 0.
//
// Resources (ptxas -v, CUDA 12.8; chip_smoke.py and
// scripts/torch_attention_sites.py print them): 223 registers a thread, no
// spills, so two blocks fit on an SM (capped at 168 to fit three, it
// spilled and ran slower). Shared memory: K, V and a two-stage Q/dO ring,
// 6 tiles of 64 x 64 bf16, the padding rows' copy (192 x 64 bf16 and 192
// floats), two stages of the q-tile's stats, the padding sum's 2 * 64 +
// 128 * 8 floats and 1 KB for alignment: 81,664 bytes a block.

// Head widths. A template of the head width, compiled for D = 64 (the
// design above) and D = 128; the C entry point runs the one its D names.
// At D = 128 one warp group would hold two 64 x 128 fp32 accumulators, 64
// floats a thread more than D = 64's 223 registers leave room for, and
// spill. So a block takes two warp groups (256 threads), and group g owns
// columns 64 g .. 64 g + 63 of dK and dV: each keeps the D = 64 kernel's
// accumulators. Both groups form the same S^T and dP^T over both 64-column
// panels of the tiles (K = 128), recomputed rather than exchanged through
// shared memory, then multiply their own panel of dO and of Q. Shared
// memory 160,000 bytes a block (one block an SM); registers in PERF.md §6.
//
// D = 256 (slices of 128 columns). Four groups of the D = 64 accumulators
// would need 4 x 128 threads x 224 registers, more than an SM's 65,536, so
// the grid gains an axis over two column slices of dK and dV, and a block
// is the D = 128 design on its slice: two warp groups, each owning one
// 64-column panel of the slice, both forming S^T and dP^T over all four
// panels of the tiles (16 k-steps each). S^T and dP^T are formed four times
// in all. K, V and the Q/dO ring stay whole at the full width (196,608
// bytes), which leaves no room for the padding rows' copy: their dO / s
// in the slice's columns is summed from device memory after the loop
// (wg::column_sums). 209,408 bytes a block.

#include "attention_wide.cuh"
#include "wgmma_bf16.cuh"

namespace {

using tc::bf16;
using tc::NEG;
using wg::PANEL_DESC;
using wg::TILE_ELEMS;

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per block
using wg::slice_width;

// one warp group a 64-column panel of the block's dK and dV: 128 threads at
// D = 64, 256 at D = 128 and 256
template <int HD>
__host__ __device__ constexpr int threads() { return 2 * slice_width<HD>(); }
constexpr int STAGES = 2;  // Q/dO tiles in the ring: one loads while one multiplies
constexpr int PAD_DEPTH = 16;  // loads in flight a thread, padding rows past PAD_ROWS
// padding rows of dO (and their s) prefetched into shared memory during the
// q-tile loop; the train step's sites have at most 186. None at D = 256,
// where they do not fit beside the tiles.
template <int HD>
__host__ __device__ constexpr int pad_rows() { return HD > 128 ? 0 : 192; }
constexpr float LOG2E = 1.4426950408889634f;
template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(bf16) * ((2 + 2 * STAGES) * wg::tile_elems<HD>() + pad_rows<HD>() * HD) +
         sizeof(float) * (STAGES * 3 * BQ + 2 * HD + threads<HD>() * 8 + pad_rows<HD>()) +
         wg::ALIGN;
}

// A warp group's dK and dV accumulators (wgmma's D fragments, 64 keys x the
// group's 64 columns).
struct KeyState {
  float dk[8][4], dv[8][4];
};

// One q-tile of NQ rows (16, 32, 48 or 64) starting at row qt: S^T and dP^T
// over the head width's HD / 64 panels, then P^T and dS^T, then dV += P^T .
// dO and dK += dS^T . Q on the warp group's panel of dO and Q, which starts
// `half` descriptor units in (0, or PANEL_DESC for the second group at
// D = 128; at D = 256 the slice's first panel, plus the group's). `stat`
// holds the tile's rows' m * log2(e), 1/s and delta;
// P = 2^(S * scale_log2 - m log2(e)) / s with scale_log2 = scale * log2(e).
template <int HD, int NQ>
__device__ __forceinline__ void dkv_tile(KeyState& st, uint64_t dk_desc, uint64_t dv_desc,
                                         const bf16* tQ, const bf16* tDO, const float* stat,
                                         int qt, int key_lo, int key_hi, int col_in, int r_end,
                                         int mlen, float scale_log2, int causal,
                                         uint64_t half) {
  constexpr int J = NQ / 8;
  float sT[J][4], dpT[J][4];
  wg::zero(sT);
  wg::zero(dpT);
  wg::fence_acc(sT);
  wg::fence_acc(dpT);
  wg::fence();
  const uint64_t dq = wg::desc(tQ), ddo = wg::desc(tDO);
#pragma unroll
  for (int p = 0; p < HD / 64; ++p)  // the head width's panels, 4 k-steps each
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t at = p * PANEL_DESC + 2 * kk;
      wg::mma_ss<NQ>(sT, dk_desc + at, dq + at);
      wg::mma_ss<NQ>(dpT, dv_desc + at, ddo + at);
    }
  wg::commit();
  wg::wait<0>();
  wg::fence_acc(sT);
  wg::fence_acc(dpT);

  // P^T into sT, dS^T into dpT, in fp32. Rows at or past r_end and keys
  // past Tk take no part; a masked key of a valid row has P = exp(NEG - m)
  // = 0 exactly and dS = 0. Column c of the tile (row qt + col_in + c, c
  // constant) is tested against scalars; a warp whose keys see every row of
  // the tile skips the test.
  auto p_ds = [&](int j, int e, const float2& m, const float2& is, const float2& dl) {
    const float mj = e & 1 ? m.y : m.x, isj = e & 1 ? is.y : is.x, dlj = e & 1 ? dl.y : dl.x;
    const float p = wg::ex2(fmaf(sT[j][e], scale_log2, -mj)) * isj;
    sT[j][e] = p;
    dpT[j][e] = p * (dpT[j][e] - dlj);
  };
  if (__all_sync(0xffffffffu, qt + NQ <= r_end && key_hi < mlen && (!causal || key_hi <= qt))) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int rl = j * 8 + col_in;
      const float2 m = *reinterpret_cast<const float2*>(stat + rl);
      const float2 is = *reinterpret_cast<const float2*>(stat + BQ + rl);
      const float2 dl = *reinterpret_cast<const float2*>(stat + 2 * BQ + rl);
#pragma unroll
      for (int e = 0; e < 4; ++e) p_ds(j, e, m, is, dl);
    }
  } else {
    const int base = qt + col_in;
    const int rows = r_end - base;  // c < rows: a valid row
    const bool key_in[2] = {key_lo < mlen, key_hi < mlen};
    // c >= first: the row is at or past the key (always, when not causal)
    const int first[2] = {causal ? key_lo - base : -BQ, causal ? key_hi - base : -BQ};
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int rl = j * 8 + col_in;
      const float2 m = *reinterpret_cast<const float2*>(stat + rl);
      const float2 is = *reinterpret_cast<const float2*>(stat + BQ + rl);
      const float2 dl = *reinterpret_cast<const float2*>(stat + 2 * BQ + rl);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + (e & 1);
        if (key_in[e >> 1] && c < rows && c >= first[e >> 1]) {
          p_ds(j, e, m, is, dl);
        } else {
          sT[j][e] = 0.f;
          dpT[j][e] = 0.f;
        }
      }
    }
  }

  // dV += P^T . dO and dK += dS^T . Q, each as hi and lo parts: A from
  // registers, dO and Q MN-major B operands, k-step s = rows 16 s .. 16 s + 15
  uint32_t p_hi[NQ / 16][4], p_lo[NQ / 16][4], ds_hi[NQ / 16][4], ds_lo[NQ / 16][4];
#pragma unroll
  for (int s = 0; s < NQ / 16; ++s) {
    wg::a_split(p_hi[s], p_lo[s], sT, s);
    wg::a_split(ds_hi[s], ds_lo[s], dpT, s);
  }
  wg::fence_acc(st.dv);
  wg::fence_acc(st.dk);
  wg::fence();
#pragma unroll
  for (int s = 0; s < NQ / 16; ++s) {
    wg::mma_rs64_mn(st.dv, p_hi[s], ddo + half + 128 * s);
    wg::mma_rs64_mn(st.dv, p_lo[s], ddo + half + 128 * s);
    wg::mma_rs64_mn(st.dk, ds_hi[s], dq + half + 128 * s);
    wg::mma_rs64_mn(st.dk, ds_lo[s], dq + half + 128 * s);
  }
  wg::commit();
  wg::wait<0>();
  wg::fence_acc(st.dv);
  wg::fence_acc(st.dk);
}

template <int HD>
__global__ void __launch_bounds__(threads<HD>())
masked_attention_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                   const int* __restrict__ q_len, const int* __restrict__ m_len,
                                   const float* __restrict__ m_in,
                                   const float* __restrict__ s_in,
                                   const float* __restrict__ delta_in, bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int H, int Tq, int Tk, float scale,
                                   int causal) {
  constexpr int THREADS = threads<HD>();
  constexpr int TILE = wg::tile_elems<HD>();
  constexpr int OW = slice_width<HD>(), SLICES = HD / OW, PAD_ROWS = pad_rows<HD>();
  // 16-byte chunks a row, and threads a row in the padding sums
  constexpr int CHUNKS = HD / 8, SHIFT = cpa::log2i(CHUNKS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(wg::aligned_smem(smem_raw));  // [64][HD] swizzled
  bf16* sV = sK + TILE;                                             // [64][HD]
  bf16* sQ = sV + TILE;                 // [STAGES][64][HD], the q-tile ring
  bf16* sDO = sQ + STAGES * TILE;       // [STAGES][64][HD]
  float* sStat = reinterpret_cast<float*>(sDO + STAGES * TILE);  // [STAGES][3][BQ]:
                                                                  // m, 1/s, delta
  float* usum = sStat + STAGES * 3 * BQ;  // [HD] twice, then [THREADS * 8] scratch
  float* scratch = usum + 2 * HD;
  bf16* sPad = reinterpret_cast<bf16*>(scratch + THREADS * 8);  // [PAD_ROWS][HD], plain rows
  float* sPadS = reinterpret_cast<float*>(sPad + PAD_ROWS * HD);  // [PAD_ROWS]

  // Each warp group owns 64 columns of dK and dV: panel `group` of the
  // block's slice [c0, c0 + OW) (at D = 64 the one group owns them all).
  // Both groups form the same S^T and dP^T, over every panel.
  const int tid = threadIdx.x, lane = tid & 31;
  const int group = OW == 128 ? tid / 128 : 0, warp = (tid & 127) >> 5;
  const int c0 = SLICES > 1 ? (int)blockIdx.z * OW : 0;
  const uint64_t half = (uint64_t)(c0 / 64 + group) * PANEL_DESC;
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

  // one commit group per q-tile: K and V with the first, then STAGES - 2
  // more ahead
  if (n_tiles > 0) {
    wg::load_tile_async<THREADS, HD>(sK, k + k_base, k0, Tk, tid);
    wg::load_tile_async<THREADS, HD>(sV, v + k_base, k0, Tk, tid);
  }
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n_tiles) {
      wg::load_tile_async<THREADS, HD>(sQ + p * TILE, q + q_base, r_begin + p * BQ, r_end, tid);
      wg::load_tile_async<THREADS, HD>(sDO + p * TILE, dout + q_base, r_begin + p * BQ, r_end,
                                       tid);
    }
    tc::cp_async_commit();
  }

  // The q-tile's m, s and delta, a row a thread (tid < BQ), are loaded one
  // tile ahead into registers, so that their latency hides behind a tile's
  // products; rows at or past r_end take m = 0, s = 1, delta = 0 (unused).
  float next_stat[3];
  auto fetch_stats = [&](int row0) {
    const int row = row0 + tid;
    const bool in = tid < BQ && row < r_end;
    next_stat[0] = in ? m_in[stat_base + row] : 0.f;
    next_stat[1] = in ? s_in[stat_base + row] : 1.f;
    next_stat[2] = in ? delta_in[stat_base + row] : 0.f;
  };
  // Launched right after the dQ kernel as a programmatic dependent launch:
  // everything above overlaps that kernel's tail; delta, which it writes,
  // is read only after its grid has completed (a no-op otherwise).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (n_tiles > 0) fetch_stats(r_begin);

  // Rows in [valid_end, Tq) are uniform over the Tk keys: each adds
  // dO_row / s_row to every dV row. The first PAD_ROWS of them and their s
  // are copied into shared memory with the q-tile loop's first loads (after
  // the prologue: with K, V and q-tile 0 alone on the way, the first
  // products start sooner), summed in fp32 after the loop and added to dV;
  // rows past those are summed from device memory then.
  const int n_pad = Tq - valid_end, n_pre = min(n_pad, PAD_ROWS);
  auto load_pad = [&]() {
    for (int chunk = tid; chunk < n_pre * CHUNKS; chunk += THREADS) {
      const int r = chunk >> SHIFT, c = (chunk & (CHUNKS - 1)) * 8;
      tc::cp_async16(sPad + r * HD + c, dout + q_base + (size_t)(valid_end + r) * HD + c, true);
    }
    for (int r = tid; r < n_pre; r += THREADS) {
      wg::cp_async4(sPadS + r, s_in + stat_base + valid_end + r);
    }
  };
  if (n_tiles == 0) {
    load_pad();
    tc::cp_async_commit();
  }
  const int col_in = (lane & 3) * 2;
  KeyState st;
  wg::zero(st.dk);
  wg::zero(st.dv);
  const float scale_log2 = scale * LOG2E;

  // this lane's two keys (g and g + 8 of the warp's 16)
  const int key_lo = k0 + warp * 16 + (lane >> 2), key_hi = key_lo + 8;
  const uint64_t dk_desc = wg::desc(sK), dv_desc = wg::desc(sV);
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % STAGES;
    const int qt = r_begin + t * BQ;
    const int ahead = t + STAGES - 1;  // into the stage that tile t - 1 used
    if (t == 0) load_pad();
    if (ahead < n_tiles) {
      const int row0 = r_begin + ahead * BQ;
      wg::load_tile_async<THREADS, HD>(sQ + (ahead % STAGES) * TILE, q + q_base, row0, r_end,
                                       tid);
      wg::load_tile_async<THREADS, HD>(sDO + (ahead % STAGES) * TILE, dout + q_base, row0,
                                       r_end, tid);
    }
    tc::cp_async_commit();
    float* stat = sStat + buf * 3 * BQ;
    if (tid < BQ) {
      stat[tid] = next_stat[0] * LOG2E;
      stat[BQ + tid] = 1.f / next_stat[1];
      stat[2 * BQ + tid] = next_stat[2];
    }
    if (t + 1 < n_tiles) fetch_stats(qt + BQ);
    tc::cp_async_wait<STAGES - 1>();  // q-tile t (and K, V) have landed
    wg::fence_async_smem();
    __syncthreads();
    const bf16* tQ = sQ + buf * TILE;
    const bf16* tDO = sDO + buf * TILE;
    const int nq = min(BQ, r_end - qt);  // rows this tile needs
    if (nq > 48) {
      dkv_tile<HD, 64>(st, dk_desc, dv_desc, tQ, tDO, stat, qt, key_lo, key_hi, col_in, r_end,
                       mlen, scale_log2, causal, half);
    } else if (nq > 32) {
      dkv_tile<HD, 48>(st, dk_desc, dv_desc, tQ, tDO, stat, qt, key_lo, key_hi, col_in, r_end,
                       mlen, scale_log2, causal, half);
    } else if (nq > 16) {
      dkv_tile<HD, 32>(st, dk_desc, dv_desc, tQ, tDO, stat, qt, key_lo, key_hi, col_in, r_end,
                       mlen, scale_log2, causal, half);
    } else {
      dkv_tile<HD, 16>(st, dk_desc, dv_desc, tQ, tDO, stat, qt, key_lo, key_hi, col_in, r_end,
                       mlen, scale_log2, causal, half);
    }
    __syncthreads();  // the next iteration refills the stage of this tile
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // the padding rows' sum: the prefetched rows from shared memory, HD / 8
  // threads a row, then any others from device memory; each dV row gets it
  {
    const int c8 = (tid & (CHUNKS - 1)) * 8;
    float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = tid >> SHIFT; r < n_pre; r += THREADS / CHUNKS) {
      const uint4 raw = *reinterpret_cast<const uint4*>(sPad + r * HD + c8);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float inv = 1.f / sPadS[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        part[2 * i] += f.x * inv;
        part[2 * i + 1] += f.y * inv;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) scratch[(tid >> SHIFT) * HD + c8 + i] = part[i];
    __syncthreads();
    if (tid < HD) {
      float total = 0.f;
      for (int g = 0; g < THREADS / CHUNKS; ++g) total += scratch[g * HD + tid];
      usum[tid] = total;
    }
    __syncthreads();
    if (n_pad > n_pre) {
      // the slice's columns, [c0, c0 + OW)
      wg::column_sums<THREADS, PAD_DEPTH, OW, HD>(usum + HD, scratch, dout + q_base + c0,
                                                  valid_end + n_pre, Tq, s_in + stat_base);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * group + j * 8 + col_in + (e & 1);
        st.dv[j][e] += n_pad > n_pre ? usum[c] + usum[HD + c] : usum[c];
      }
  }

  // dK * scale and dV, staged through the first stage of the ring, each
  // group into its panel
  wg::stage_acc(sQ + group * TILE_ELEMS, st.dk, scale, scale);
  wg::stage_acc(sDO + group * TILE_ELEMS, st.dv, 1.f, 1.f);
  __syncthreads();
  wg::store_tile<THREADS, OW, HD>(dk + k_base + c0, sQ, k0, k_rows);
  wg::store_tile<THREADS, OW, HD>(dv + k_base + c0, sDO, k0, k_rows);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* q_len, const void* m_len, const void* m, const void* s,
                   const void* delta, void* dk, void* dv, int B, int H, int Tq, int Tk,
                   float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;  // above 48 KB needs an explicit opt-in, per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(masked_attention_bwd_dkv_tc_kernel<HD>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem_bytes<HD>());
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  // a programmatic dependent launch: its blocks may start while the kernel
  // before it on the stream (the dQ kernel) still runs
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * H, (Tk + BK - 1) / BK, HD / slice_width<HD>());
  config.blockDim = dim3(threads<HD>());
  config.dynamicSmemBytes = smem_bytes<HD>();
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, masked_attention_bwd_dkv_tc_kernel<HD>, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const int*>(q_len), static_cast<const int*>(m_len),
      static_cast<const float*>(m), static_cast<const float*>(s),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Tq,
      Tk, scale, causal);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// q, dout: contiguous bf16 [B, H, Tq, D]; k, v: bf16 [B, H, Tk, D], D = 64,
// 128, 256 or a multiple of 128 above (the wide kernel,
// masked_attention_wide_tc.cu); q_len, m_len: int32 [B] or null; m, s, delta: fp32 [B, H, Tq]
// (the forward's row max and row sum, and rowsum(dO * O)); dk, dv like k.
// Returns the CUDA error code of the launch.
extern "C" int masked_attention_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                           const void* dout, const void* q_len,
                                           const void* m_len, const void* m, const void* s,
                                           const void* delta, void* dk, void* dv, int B,
                                           int H, int Tq, int Tk, int D, float scale,
                                           int causal, void* stream) {
  if ((D != 64 && D != 128 && D != 256 && !wide::takes(D)) || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 ||
      (Tk + BK - 1) / BK > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide::takes(D)) {  // every multiple of 128 above 256
    return (int)wide::dkv_tc(q, k, v, dout, q_len, m_len, m, s, delta, dk, dv, B, H, Tq, Tk, D, scale, causal, st);
  }
  if (D == 256) {
    return (int)launch<256>(q, k, v, dout, q_len, m_len, m, s, delta, dk, dv, B, H, Tq, Tk,
                            scale, causal, st);
  }
  return (int)(D == 128 ? launch<128>(q, k, v, dout, q_len, m_len, m, s, delta, dk, dv, B, H,
                                      Tq, Tk, scale, causal, st)
                        : launch<64>(q, k, v, dout, q_len, m_len, m, s, delta, dk, dv, B, H, Tq,
                                     Tk, scale, causal, st));
}

// Dynamic shared memory each D = 64 block asks for, in bytes (a D = 128
// block of two warp groups 160,000, a D = 256 block 209,408).
extern "C" int masked_attention_bwd_dkv_tc_shared_bytes(void) { return (int)smem_bytes<64>(); }
