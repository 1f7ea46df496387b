// Masked multi-head attention at every head width above 256 (each multiple
// of 128, taken at run time), bf16 on Hopper's tensor cores (wgmma), for
// sm_90a: the forward, the dQ kernel (which also forms delta) and the
// dK/dV kernel. Reached through the C entry points of the D = 64, 128 and
// 256 kernels (masked_attention_fwd_tc.cu, masked_attention_bwd_dq_tc.cu,
// masked_attention_bwd_dkv_tc.cu), which send every D > 256 here; the fp32
// counterparts are in masked_attention_wide.cu.
//
// Replaces, for bf16 inputs at D > 256, the Pallas kernels of
// vaenar_tts_tpu/ops/flash_attention.py, which take any width (their
// BlockSpecs carry D whole):
//   _fwd_kernel          (l.104, pallas_call l.299)
//   _fwd_kernel_blocked  (l.142, pallas_call l.224; Tk > 4096)
//   _dq_kernel           (l.320, pallas_call l.442; and delta, l.425-427)
//   _dkv_kernel          (l.370, pallas_call l.467)
// The contract is the D <= 256 kernels' (masked_attention_fwd_tc.cu and
// masked_attention_bwd.cu say it whole): masked logits are NEG = -2^32+1,
// a row with nothing unmasked comes out uniform (o = mean(v), m = NEG,
// s = Tk), the statistics are (row max, row sum), dS is zeroed where
// masked, dV counts the fully masked rows (dO_row / s_row on every key),
// delta = rowsum(dO * O) on rows with a key and 0 on the others.
//
// Why a design of its own. Every D <= 256 kernel holds at least one
// operand at the full width in shared memory: at D = 384 the forward's Q
// and two-stage K ring, or the dQ kernel's Q, dO and K/V ring (294,912
// bytes), pass the 232,448 bytes a block has. So here no block holds any
// operand at the full width, and nothing grows with D:
//   * the grid has an axis over D / 128 slices of 128 output columns (o,
//     dQ, or dK and dV), as the D = 256 kernels' two slices;
//   * S = Q.K^T, and in the backward dP = dO.V^T, are summed over the
//     D / 64 panels of 64 columns, which stream through a two-stage ring of
//     cp.async copies (the next panel loading while this one multiplies),
//     each panel a wgmma K-major operand (wgmma_bf16.cuh's swizzled
//     layout);
//   * a block holds besides only its own 128-column slice of the operand
//     that the second product reads (V in the forward, K in dQ, Q and dO
//     in dK/dV), loaded with a tile's first panel and read after its last,
//     and the row statistics of the tile.
// Each slice forms its own S (and dP): S is formed D / 128 times. Slice 0
// writes m and s (forward) and delta (dQ); every slice forms delta, from
// O's and dO's whole rows in device memory. Shared memory a block: 65,536
// + 5,120 (forward), 81,920 (dQ), 108,800 (dK/dV) bytes with the 1 KB
// alignment, at every width.
//
// What bounds it: at the head_widths model's sites (one head of 384, B =
// 4 at synthesis, 32 at a train step) neither bytes nor operations, by
// chip_smoke.py's count: a block's chain of dependent steps, here D / 64
// panel steps a key tile, each a round of copies, a barrier and a wgmma
// of 4 k-steps. This first version is right and simple: one warp group
// (two in dK/dV) a block, key and q-tiles of 64 not narrowed, Q (or K)
// panels read again for every tile, and S recomputed in each slice. Its
// times beside the bound are in PERF.md §6.
//
// Per block:
//   forward (one warp group, 64 query rows, one slice of o): per key tile
//     S over the panels, the mask and the online softmax in fp32
//     registers, O += P_hi.V + P_lo.V over the slice (P split into bf16
//     high and low parts as in masked_attention_fwd_tc.cu); rows at or
//     past q_len are written by one block of the (b, h, slice) from the
//     column sums of its slice of V.
//   dQ (one warp group, 64 query rows, one slice of dQ): delta from O and
//     dO, then per key tile S and dP over the panels, dS = P * (dP -
//     delta) where unmasked, dQ += dS_hi.K + dS_lo.K over the slice.
//   dK/dV (two warp groups, 64 keys, one slice of dK and dV; group g owns
//     its 64 columns, as in masked_attention_bwd_dkv_tc.cu): per q-tile
//     S^T and dP^T over the panels, formed by both groups, then P^T and
//     dS^T, dV += P^T.dO and dK += dS^T.Q over the group's panel of the
//     slice; after the loop the fully masked rows' dO / s, summed over the
//     slice's columns from device memory, is added to every dV row.

#include "attention_wide.cuh"
#include "wgmma_bf16.cuh"

namespace {

using tc::bf16;
using tc::NEG;
using wg::PANEL_DESC;
using wg::TILE_ELEMS;

constexpr int BQ = 64;      // query rows of a block (forward, dQ) or of a q-tile (dK/dV)
constexpr int BK = 64;      // keys of a tile (forward, dQ) or of a block (dK/dV)
constexpr int PANEL = 64;   // columns of a streamed panel
constexpr int SLICE = 128;  // output columns of a block: two panels
constexpr int STAGES = 2;   // the panel ring: one stage loads while one multiplies
constexpr int PAD_DEPTH = 16;  // loads in flight a thread in a column sum
constexpr float LOG2E = 1.4426950408889634f;

// Rows [row0, row0 + 64) of COLS columns (PANEL or SLICE) of a bf16 matrix
// whose rows are ld elements apart into a swizzled tile of COLS / 64
// panels, as asynchronous copies by THREADS threads numbered `tid`; rows
// at or past `rows_end` become zeros.
template <int THREADS, int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int ld,
                                          int row0, int rows_end, int tid) {
  constexpr int CHUNKS = COLS / 8, SHIFT = cpa::log2i(CHUNKS);  // 16-byte chunks a row
#pragma unroll
  for (int chunk = tid; chunk < BQ * CHUNKS; chunk += THREADS) {
    const int r = chunk >> SHIFT, c = chunk & (CHUNKS - 1);
    const bool in = row0 + r < rows_end;
    tc::cp_async16(dst + wg::swz(r, c), in ? src + (size_t)(row0 + r) * ld + c * 8 : src, in);
  }
}

// Rows [0, rows) of a swizzled two-panel tile to rows [row0, row0 + rows)
// of SLICE columns of a bf16 matrix whose rows are ld elements apart.
template <int THREADS>
__device__ __forceinline__ void store_slice(bf16* __restrict__ dst, const bf16* tile, int ld,
                                            int row0, int rows) {
  constexpr int CHUNKS = SLICE / 8, SHIFT = cpa::log2i(CHUNKS);
  for (int chunk = threadIdx.x; chunk < rows * CHUNKS; chunk += THREADS) {
    const int r = chunk >> SHIFT, c = chunk & (CHUNKS - 1);
    *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * ld + c * 8) =
        *reinterpret_cast<const uint4*>(tile + wg::swz(r, c));
  }
}

// Zeros into rows [row0, row0 + rows) of SLICE columns (rows ld apart).
template <int THREADS>
__device__ __forceinline__ void zero_slice(bf16* __restrict__ dst, int ld, int row0, int rows) {
  constexpr int CHUNKS = SLICE / 8, SHIFT = cpa::log2i(CHUNKS);
  for (int chunk = threadIdx.x; chunk < rows * CHUNKS; chunk += THREADS)
    *reinterpret_cast<uint4*>(dst + (size_t)(row0 + (chunk >> SHIFT)) * ld +
                              (chunk & (CHUNKS - 1)) * 8) = make_uint4(0u, 0u, 0u, 0u);
}

// Column sums of rows [row0, row1) of SLICE columns of a bf16 matrix whose
// rows are ld elements apart, in fp32, each row divided by div[r] when
// `div` is not null, into sum[0..SLICE) in shared memory; `scratch` is
// shared memory for THREADS * 8 floats (wg::column_sums with a run-time
// row stride). Ends with a barrier.
template <int THREADS>
__device__ __forceinline__ void slice_sums(float* sum, float* scratch,
                                           const bf16* __restrict__ src, int ld, int row0,
                                           int row1, const float* __restrict__ div) {
  constexpr int TPR = SLICE / 8;       // threads a row
  constexpr int STEP = THREADS / TPR;  // rows read at once by the block
  const int c8 = (threadIdx.x % TPR) * 8;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int r = row0 + (threadIdx.x / TPR); r < row1; r += PAD_DEPTH * STEP) {
    uint4 raw[PAD_DEPTH];
    float inv[PAD_DEPTH];
#pragma unroll
    for (int u = 0; u < PAD_DEPTH; ++u) {
      const int ru = r + u * STEP;
      raw[u] = ru < row1 ? *reinterpret_cast<const uint4*>(src + (size_t)ru * ld + c8)
                         : make_uint4(0u, 0u, 0u, 0u);
      inv[u] = ru < row1 && div ? div[ru] : 1.f;
    }
#pragma unroll
    for (int u = 0; u < PAD_DEPTH; ++u) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
      const float w = div ? 1.f / inv[u] : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        acc[2 * i] += f.x * w;
        acc[2 * i + 1] += f.y * w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) scratch[(threadIdx.x / TPR) * SLICE + c8 + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < SLICE) {
    float total = 0.f;
    for (int g = 0; g < STEP; ++g) total += scratch[g * SLICE + threadIdx.x];
    sum[threadIdx.x] = total;
  }
  __syncthreads();
}

// op(t[0], ..., t[N - 1]) as a tree: pairs at distance 1, then 2, 4, ...
template <int N, typename Op>
__device__ __forceinline__ float tree(float (&t)[N], Op op) {
#pragma unroll
  for (int step = 1; step < N; step *= 2)
#pragma unroll
    for (int i = 0; i + step < N; i += 2 * step) t[i] = op(t[i], t[i + step]);
  return t[0];
}

// ---------------------------------------------------------------- forward

constexpr int FWD_THREADS = 128;  // one warp group, 16 query rows a warp
// the ring (a Q panel and a K panel a stage), V's slice of the key tile,
// and the padding rows' column sums
constexpr size_t FWD_SMEM = sizeof(bf16) * (STAGES * 2 + 2) * TILE_ELEMS +
                            sizeof(float) * (SLICE + FWD_THREADS * 8) + wg::ALIGN;

__global__ void __launch_bounds__(FWD_THREADS)
fwd_tc_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ q_len,
                   const int* __restrict__ m_len, bf16* __restrict__ o, float* __restrict__ m_out,
                   float* __restrict__ s_out, int H, int Tq, int Tk, int D, float scale,
                   int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(wg::aligned_smem(smem_raw));  // [STAGES][Q, K panel]
  bf16* sV = ring + STAGES * 2 * TILE_ELEMS;  // [64][SLICE]: the key tile's v in the slice
  float* sum = reinterpret_cast<float*>(sV + 2 * TILE_ELEMS);  // [SLICE], then scratch

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int qb = blockIdx.y, q0 = qb * BQ;
  const int q_rows = min(BQ, Tq - q0);
  const int c0 = (int)blockIdx.z * SLICE;  // this block's columns of o and v
  const bool writes_stats = blockIdx.z == 0;
  const int np = D / PANEL;  // panels a row
  const int qlen = q_len ? q_len[b] : Tq;
  const int klim = max(0, min(Tk, m_len ? m_len[b] : Tk));  // keys a valid row may see
  const size_t q_base = (size_t)bh * Tq * D;
  const size_t k_base = (size_t)bh * Tk * D;
  const size_t stat_base = (size_t)bh * Tq;

  // rows below pad0 have an unmasked key (key 0), the others are uniform;
  // valid rows see no key at or past k_end: those terms are exp(NEG - m) = 0
  const int pad0 = klim > 0 ? max(0, min(qlen, Tq)) : 0;
  const int rows_end = min(q0 + q_rows, pad0);
  const int k_end = causal ? min(klim, rows_end) : klim;
  const int n_tiles = q0 < pad0 ? (k_end + BK - 1) / BK : 0;
  const int n_steps = n_tiles * np;  // one step a (key tile, panel)

  // step s: panel s % np of Q and of key tile s / np's K, into stage s % 2
  auto load_step = [&](int s) {
    const int t = s / np, p = s - t * np;
    bf16* stage = ring + (s & 1) * 2 * TILE_ELEMS;
    load_tile<FWD_THREADS, PANEL>(stage, q + q_base + p * PANEL, D, q0, rows_end, tid);
    load_tile<FWD_THREADS, PANEL>(stage + TILE_ELEMS, k + k_base + p * PANEL, D, t * BK, k_end,
                                  tid);
  };
  if (n_steps > 0) {
    load_step(0);
    tc::cp_async_commit();
  }

  // One block of the (b, h, slice) writes the rows at or past pad0 while
  // the copies above land: the first block whose rows start there, else
  // the last block. o = mean(v) in the slice; slice 0 writes m = NEG, s = Tk.
  const int writer = min((pad0 + BQ - 1) / BQ, (int)gridDim.y - 1);
  if (pad0 < Tq && qb == writer) {
    constexpr int TPR = SLICE / 8;  // threads a row, 8 columns each
    slice_sums<FWD_THREADS>(sum, sum + SLICE, v + k_base + c0, D, 0, Tk, nullptr);
    const int c8 = (tid & (TPR - 1)) * 8;
    uint4 mean;
    __nv_bfloat162* mean2 = reinterpret_cast<__nv_bfloat162*>(&mean);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mean2[i] = __floats2bfloat162_rn(sum[c8 + 2 * i] / (float)Tk, sum[c8 + 2 * i + 1] / (float)Tk);
    for (int r = pad0 + tid / TPR; r < Tq; r += FWD_THREADS / TPR)
      *reinterpret_cast<uint4*>(o + q_base + (size_t)r * D + c0 + c8) = mean;
    for (int r = pad0 + tid; writes_stats && r < Tq; r += FWD_THREADS) {
      m_out[stat_base + r] = NEG;
      s_out[stat_base + r] = (float)Tk;
    }
  }
  if (n_steps == 0) return;

  // this lane's two rows (g and g + 8 of the warp's 16), their unmasked
  // keys [0, lim), and its column pair
  const int row_lo = q0 + warp * 16 + (lane >> 2), row_hi = row_lo + 8;
  const int col_in = (lane & 3) * 2;
  auto row_lim = [&](int row) {
    const int lim = row < pad0 ? klim : 0;
    return causal ? min(lim, row + 1) : lim;
  };
  const int lim[2] = {row_lim(row_lo), row_lim(row_hi)};
  float acc[SLICE / 8][4];  // O in the slice, wgmma's D fragment
  float row_max[2] = {NEG, NEG}, row_sum[2] = {0.f, 0.f};
  float sc[BK / 8][4];  // S of the key tile, summed over the panels
  wg::zero(acc);

  for (int s = 0; s < n_steps; ++s) {
    const int t = s / np, p = s - t * np;
    if (s + 1 < n_steps) load_step(s + 1);
    // the tile's V slice, read after its last panel: its stage was last
    // read by the tile before, whose steps have all passed the barrier
    if (p == 0) load_tile<FWD_THREADS, SLICE>(sV, v + k_base + c0, D, t * BK, k_end, tid);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // step s's panels have landed (and V, by the last panel)
    wg::fence_async_smem();
    __syncthreads();
    const bf16* stage = ring + (s & 1) * 2 * TILE_ELEMS;
    if (p == 0) wg::zero(sc);
    wg::fence_acc(sc);
    wg::fence();
    const uint64_t dq = wg::desc(stage), dk = wg::desc(stage + TILE_ELEMS);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::mma_ss<BK>(sc, dq + 2 * kk, dk + 2 * kk);
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(sc);

    if (p == np - 1) {
      // the mask and the online softmax, as masked_attention_fwd_tc.cu's
      // fwd_tile: masked columns NEG, columns past Tk -inf; a warp whose
      // rows see every column of the tile skips the mask
      const int kt = t * BK;
      if (__all_sync(0xffffffffu, kt + BK <= min(lim[0], lim[1]))) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] *= scale;
      } else {
        const int base = kt + col_in;
        const int bound[2] = {lim[0] - base, lim[1] - base};
        const int keys = Tk - base;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + (e & 1);
            sc[j][e] = c < bound[e >> 1] ? sc[j][e] * scale : (c < keys ? NEG : -INFINITY);
          }
      }
      float alpha[2], part[2], m_log2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tm[BK / 8];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) tm[j] = fmaxf(sc[j][2 * h], sc[j][2 * h + 1]);
        float tile_max = tree<BK / 8>(tm, [](float a, float b) { return fmaxf(a, b); });
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
        const float m_new = fmaxf(row_max[h], tile_max);
        alpha[h] = __expf(row_max[h] - m_new);
        row_max[h] = m_new;
        // a row whose max is still NEG (every key masked: a row past q_len,
        // never written) takes 0 for its terms
        m_log2[h] = m_new == NEG ? 0.f : m_new * LOG2E;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = wg::ex2(fmaf(sc[j][e], LOG2E, -m_log2[e >> 1]));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ts[BK / 8];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) ts[j] = sc[j][2 * h] + sc[j][2 * h + 1];
        part[h] = tree<BK / 8>(ts, [](float a, float b) { return a + b; });
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < SLICE / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) row_sum[h] = row_sum[h] * alpha[h] + part[h];

      // O += P_hi . V + P_lo . V over the slice's two panels of V
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) wg::a_split(p_hi[ks], p_lo[ks], sc, ks);
      wg::fence_acc(acc);
      wg::fence();
      const uint64_t dv = wg::desc(sV);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {  // keys 16 ks .. 16 ks + 15
        wg::mma_rs64_mn(acc, p_hi[ks], dv + 128 * ks);
        wg::mma_rs64_mn(acc, p_lo[ks], dv + 128 * ks);
        wg::mma_rs64_mn<8>(acc, p_hi[ks], dv + PANEL_DESC + 128 * ks);
        wg::mma_rs64_mn<8>(acc, p_lo[ks], dv + PANEL_DESC + 128 * ks);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_acc(acc);
    }
    __syncthreads();  // the next step refills this stage
  }
  tc::cp_async_wait<0>();

  // o = acc / s for the rows below rows_end, staged through stage 0 of the
  // ring (two panels)
  wg::stage_acc(ring, acc, 1.f / row_sum[0], 1.f / row_sum[1]);
  wg::stage_acc<8>(ring + TILE_ELEMS, acc, 1.f / row_sum[0], 1.f / row_sum[1]);
  if (writes_stats && (lane & 3) == 0) {
    if (row_lo < rows_end) {
      m_out[stat_base + row_lo] = row_max[0];
      s_out[stat_base + row_lo] = row_sum[0];
    }
    if (row_hi < rows_end) {
      m_out[stat_base + row_hi] = row_max[1];
      s_out[stat_base + row_hi] = row_sum[1];
    }
  }
  __syncthreads();
  store_slice<FWD_THREADS>(o + q_base + c0, ring, D, q0, rows_end - q0);
}

// -------------------------------------------------------------------- dQ

constexpr int DQ_THREADS = 128;  // one warp group, 16 query rows a warp
// the ring (a Q, dO, K and V panel a stage) and K's slice of the key tile
constexpr size_t DQ_SMEM = sizeof(bf16) * (STAGES * 4 + 2) * TILE_ELEMS + wg::ALIGN;

__global__ void __launch_bounds__(DQ_THREADS)
dq_tc_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const bf16* __restrict__ o, const int* __restrict__ q_len,
                  const int* __restrict__ m_len, const float* __restrict__ m_in,
                  const float* __restrict__ s_in, float* __restrict__ delta_out,
                  bf16* __restrict__ dq, int H, int Tq, int Tk, int D, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(wg::aligned_smem(smem_raw));  // [STAGES][Q, dO, K, V]
  bf16* sK = ring + STAGES * 4 * TILE_ELEMS;  // [64][SLICE]: the key tile's k in the slice

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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
    zero_slice<DQ_THREADS>(dq + q_base + c0, D, q0, q_rows);
    for (int r = tid; writes_delta && r < q_rows; r += DQ_THREADS) delta_out[stat_base + q0 + r] = 0.f;
    return;
  }
  // keys at or past k_end are masked for every row of the block
  const int k_end = causal ? min(mlen, rows_end) : mlen;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int n_steps = n_tiles * np;

  auto load_step = [&](int s) {
    const int t = s / np, p = s - t * np;
    bf16* stage = ring + (s & 1) * 4 * TILE_ELEMS;
    load_tile<DQ_THREADS, PANEL>(stage, q + q_base + p * PANEL, D, q0, rows_end, tid);
    load_tile<DQ_THREADS, PANEL>(stage + TILE_ELEMS, dout + q_base + p * PANEL, D, q0, rows_end,
                                 tid);
    load_tile<DQ_THREADS, PANEL>(stage + 2 * TILE_ELEMS, k + k_base + p * PANEL, D, t * BK, k_end,
                                 tid);
    load_tile<DQ_THREADS, PANEL>(stage + 3 * TILE_ELEMS, v + k_base + p * PANEL, D, t * BK, k_end,
                                 tid);
  };
  load_step(0);
  tc::cp_async_commit();

  // delta over the whole width, while step 0 lands: thread tid sums
  // columns [D / 2 h, D / 2 (h + 1)) of row r of dO * O from device
  // memory, 16 bytes a load (rows without a key read nothing: delta 0).
  // Each 16-byte chunk's 8 products (exact in fp32) are added as a tree,
  // and the chunks into 4 sums in turn (D / 16 chunks, a multiple of 8),
  // so that no chain of additions grows long with D.
  const int d_row = tid >> 1, d_half = tid & 1;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  if (q0 + d_row < rows_end) {
    const size_t at = q_base + (size_t)(q0 + d_row) * D + d_half * (D / 2);
    for (int c = 0; c < D / 2; c += 32) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint4 g_raw = *reinterpret_cast<const uint4*>(dout + at + c + 8 * u);
        const uint4 o_raw = *reinterpret_cast<const uint4*>(o + at + c + 8 * u);
        const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&g_raw);
        const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&o_raw);
        float prod[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 gf = __bfloat1622float2(gh[j]), of = __bfloat1622float2(oh[j]);
          prod[2 * j] = gf.x * of.x;
          prod[2 * j + 1] = gf.y * of.y;
        }
        part[u] += tree<8>(prod, [](float x, float y) { return x + y; });
      }
    }
  }
  float dsum = (part[0] + part[1]) + (part[2] + part[3]);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  if (writes_delta && d_half == 0 && d_row < q_rows) delta_out[stat_base + q0 + d_row] = dsum;

  // this lane's two rows: their unmasked keys, m log2(e), 1/s and delta
  // (row warp * 16 + j's delta sits in lanes 2 j and 2 j + 1 of its warp)
  const int row_lo = q0 + warp * 16 + (lane >> 2);
  int lim[2];
  float m_log2[2], inv_s[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    const bool in = row < rows_end;
    lim[h] = in ? (causal ? min(mlen, row + 1) : mlen) : 0;
    m_log2[h] = in ? m_in[stat_base + row] * LOG2E : 0.f;
    inv_s[h] = in ? 1.f / s_in[stat_base + row] : 0.f;
  }
  delta[0] = __shfl_sync(0xffffffffu, dsum, 2 * (lane >> 2));
  delta[1] = __shfl_sync(0xffffffffu, dsum, 2 * (lane >> 2) + 16);

  const int col_in = (lane & 3) * 2;
  const float scale_log2 = scale * LOG2E;
  float acc[SLICE / 8][4];  // dQ in the slice
  float sc[BK / 8][4], dp[BK / 8][4];
  wg::zero(acc);

  for (int s = 0; s < n_steps; ++s) {
    const int t = s / np, p = s - t * np;
    if (s + 1 < n_steps) load_step(s + 1);
    if (p == 0) load_tile<DQ_THREADS, SLICE>(sK, k + k_base + c0, D, t * BK, k_end, tid);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    wg::fence_async_smem();
    __syncthreads();
    const bf16* stage = ring + (s & 1) * 4 * TILE_ELEMS;
    if (p == 0) {
      wg::zero(sc);
      wg::zero(dp);
    }
    wg::fence_acc(sc);
    wg::fence_acc(dp);
    wg::fence();
    const uint64_t dq_d = wg::desc(stage), ddo = wg::desc(stage + TILE_ELEMS);
    const uint64_t dk = wg::desc(stage + 2 * TILE_ELEMS), dv = wg::desc(stage + 3 * TILE_ELEMS);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg::mma_ss<BK>(sc, dq_d + 2 * kk, dk + 2 * kk);
      wg::mma_ss<BK>(dp, ddo + 2 * kk, dv + 2 * kk);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(sc);
    wg::fence_acc(dp);

    if (p == np - 1) {
      // dS into dp, as masked_attention_bwd_dq_tc.cu's dq_tile: a masked
      // key of a row with a key has P = 0 exactly and dS = 0; rows without
      // a key (lim 0) take no part
      const int kt = t * BK;
      auto ds = [&](int j, int e) {
        const int h = e >> 1;
        const float pr = wg::ex2(fmaf(sc[j][e], scale_log2, -m_log2[h])) * inv_s[h];
        dp[j][e] = pr * (dp[j][e] - delta[h]);
      };
      if (__all_sync(0xffffffffu, kt + BK <= min(lim[0], lim[1]))) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ds(j, e);
      } else {
        const int base = kt + col_in;
        const int bound[2] = {lim[0] - base, lim[1] - base};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j * 8 + (e & 1) < bound[e >> 1]) {
              ds(j, e);
            } else {
              dp[j][e] = 0.f;
            }
          }
      }
      // dQ += dS_hi . K + dS_lo . K over the slice's two panels of K
      uint32_t ds_hi[BK / 16][4], ds_lo[BK / 16][4];
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) wg::a_split(ds_hi[ks], ds_lo[ks], dp, ks);
      wg::fence_acc(acc);
      wg::fence();
      const uint64_t dks = wg::desc(sK);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        wg::mma_rs64_mn(acc, ds_hi[ks], dks + 128 * ks);
        wg::mma_rs64_mn(acc, ds_lo[ks], dks + 128 * ks);
        wg::mma_rs64_mn<8>(acc, ds_hi[ks], dks + PANEL_DESC + 128 * ks);
        wg::mma_rs64_mn<8>(acc, ds_lo[ks], dks + PANEL_DESC + 128 * ks);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_acc(acc);
    }
    __syncthreads();  // the next step refills this stage
  }
  tc::cp_async_wait<0>();

  // dQ * scale, staged through stage 0 of the ring; rows without a key are zeros
  wg::stage_acc(ring, acc, scale, scale);
  wg::stage_acc<8>(ring + TILE_ELEMS, acc, scale, scale);
  __syncthreads();
  store_slice<DQ_THREADS>(dq + q_base + c0, ring, D, q0, q_rows);
}

// ----------------------------------------------------------------- dK/dV

constexpr int DKV_THREADS = 256;  // two warp groups, each 64 columns of the slice
// the ring (a K, V, Q and dO panel a stage), the q-tile's Q and dO slices,
// its statistics, the padding rows' sums and their scratch
constexpr size_t DKV_SMEM = sizeof(bf16) * (STAGES * 4 + 4) * TILE_ELEMS +
                            sizeof(float) * (3 * BQ + SLICE + DKV_THREADS * 8) + wg::ALIGN;

__global__ void __launch_bounds__(DKV_THREADS)
dkv_tc_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const int* __restrict__ q_len, const int* __restrict__ m_len,
                   const float* __restrict__ m_in, const float* __restrict__ s_in,
                   const float* __restrict__ delta_in, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int H, int Tq, int Tk, int D, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(wg::aligned_smem(smem_raw));  // [STAGES][K, V, Q, dO]
  bf16* sQ = ring + STAGES * 4 * TILE_ELEMS;  // [64][SLICE]: the q-tile's q in the slice
  bf16* sDO = sQ + 2 * TILE_ELEMS;            // [64][SLICE]: the same of dO
  float* sStat = reinterpret_cast<float*>(sDO + 2 * TILE_ELEMS);  // [3][BQ]: m log2(e), 1/s, delta
  float* usum = sStat + 3 * BQ;  // [SLICE]: the uniform rows' dO / s
  float* scratch = usum + SLICE;  // [THREADS * 8]

  // group g owns columns c0 + 64 g .. c0 + 64 g + 63 of dK and dV; both
  // groups form the same S^T and dP^T
  const int tid = threadIdx.x, lane = tid & 31;
  const int group = tid / 128, warp = (tid & 127) >> 5;
  const int c0 = (int)blockIdx.z * SLICE;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int k0 = blockIdx.y * BK;
  const int k_rows = min(BK, Tk - k0);
  const int np = D / PANEL;
  const int mlen = max(0, min(m_len ? m_len[b] : Tk, Tk));
  // rows below valid_end have an unmasked key; the others are uniform
  const int valid_end = mlen > 0 ? max(0, min(q_len ? q_len[b] : Tq, Tq)) : 0;
  const size_t q_base = (size_t)bh * Tq * D;
  const size_t k_base = (size_t)bh * Tk * D;
  const size_t stat_base = (size_t)bh * Tq;

  // Rows below valid_end see no key of this block when the block starts at
  // or past m_len; when causal, rows before the block's first key see none.
  const int r_begin = causal ? k0 : 0;
  const int r_end = k0 < mlen ? valid_end : 0;
  const int n_tiles = r_begin < r_end ? (r_end - r_begin + BQ - 1) / BQ : 0;
  const int n_steps = n_tiles * np;

  // step s: panel s % np of the block's K and V and of q-tile s / np's Q
  // and dO (keys at or past m_len and rows at or past r_end load as zeros)
  auto load_step = [&](int s) {
    const int t = s / np, p = s - t * np;
    const int qt = r_begin + t * BQ;
    bf16* stage = ring + (s & 1) * 4 * TILE_ELEMS;
    load_tile<DKV_THREADS, PANEL>(stage, k + k_base + p * PANEL, D, k0, mlen, tid);
    load_tile<DKV_THREADS, PANEL>(stage + TILE_ELEMS, v + k_base + p * PANEL, D, k0, mlen, tid);
    load_tile<DKV_THREADS, PANEL>(stage + 2 * TILE_ELEMS, q + q_base + p * PANEL, D, qt, r_end,
                                  tid);
    load_tile<DKV_THREADS, PANEL>(stage + 3 * TILE_ELEMS, dout + q_base + p * PANEL, D, qt, r_end,
                                  tid);
  };
  if (n_steps > 0) {
    load_step(0);
    tc::cp_async_commit();
  }

  const int col_in = (lane & 3) * 2;
  const float scale_log2 = scale * LOG2E;
  // this lane's two keys (g and g + 8 of the warp's 16)
  const int key_lo = k0 + warp * 16 + (lane >> 2), key_hi = key_lo + 8;
  float acc_dk[8][4], acc_dv[8][4];  // the group's 64 columns of dK and dV
  float sT[BQ / 8][4], dpT[BQ / 8][4];  // S^T and dP^T of the q-tile, summed over the panels
  wg::zero(acc_dk);
  wg::zero(acc_dv);

  for (int s = 0; s < n_steps; ++s) {
    const int t = s / np, p = s - t * np;
    const int qt = r_begin + t * BQ;
    if (s + 1 < n_steps) load_step(s + 1);
    if (p == 0) {
      // the q-tile's Q and dO slices and statistics, read after its last
      // panel (rows at or past r_end take m = 0, 1/s = 1, delta = 0, unused)
      load_tile<DKV_THREADS, SLICE>(sQ, q + q_base + c0, D, qt, r_end, tid);
      load_tile<DKV_THREADS, SLICE>(sDO, dout + q_base + c0, D, qt, r_end, tid);
      if (tid < BQ) {
        const int row = qt + tid;
        const bool in = row < r_end;
        sStat[tid] = in ? m_in[stat_base + row] * LOG2E : 0.f;
        sStat[BQ + tid] = in ? 1.f / s_in[stat_base + row] : 1.f;
        sStat[2 * BQ + tid] = in ? delta_in[stat_base + row] : 0.f;
      }
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    wg::fence_async_smem();
    __syncthreads();
    const bf16* stage = ring + (s & 1) * 4 * TILE_ELEMS;
    if (p == 0) {
      wg::zero(sT);
      wg::zero(dpT);
    }
    wg::fence_acc(sT);
    wg::fence_acc(dpT);
    wg::fence();
    const uint64_t dk_d = wg::desc(stage), dv_d = wg::desc(stage + TILE_ELEMS);
    const uint64_t dq_d = wg::desc(stage + 2 * TILE_ELEMS);
    const uint64_t ddo_d = wg::desc(stage + 3 * TILE_ELEMS);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg::mma_ss<BQ>(sT, dk_d + 2 * kk, dq_d + 2 * kk);
      wg::mma_ss<BQ>(dpT, dv_d + 2 * kk, ddo_d + 2 * kk);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(sT);
    wg::fence_acc(dpT);

    if (p == np - 1) {
      // P^T into sT, dS^T into dpT, as masked_attention_bwd_dkv_tc.cu's
      // dkv_tile: rows at or past r_end and keys at or past m_len take no
      // part, a masked key of a valid row has P = 0 exactly and dS = 0
      auto p_ds = [&](int j, int e, const float2& m, const float2& is, const float2& dl) {
        const float mj = e & 1 ? m.y : m.x, isj = e & 1 ? is.y : is.x, dlj = e & 1 ? dl.y : dl.x;
        const float pr = wg::ex2(fmaf(sT[j][e], scale_log2, -mj)) * isj;
        sT[j][e] = pr;
        dpT[j][e] = pr * (dpT[j][e] - dlj);
      };
      if (__all_sync(0xffffffffu,
                     qt + BQ <= r_end && key_hi < mlen && (!causal || key_hi <= qt))) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int rl = j * 8 + col_in;
          const float2 m = *reinterpret_cast<const float2*>(sStat + rl);
          const float2 is = *reinterpret_cast<const float2*>(sStat + BQ + rl);
          const float2 dl = *reinterpret_cast<const float2*>(sStat + 2 * BQ + rl);
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
        for (int j = 0; j < BQ / 8; ++j) {
          const int rl = j * 8 + col_in;
          const float2 m = *reinterpret_cast<const float2*>(sStat + rl);
          const float2 is = *reinterpret_cast<const float2*>(sStat + BQ + rl);
          const float2 dl = *reinterpret_cast<const float2*>(sStat + 2 * BQ + rl);
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
      // dV += P^T . dO and dK += dS^T . Q on the group's panel of the
      // slices, each as hi and lo parts
      uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4], ds_hi[BQ / 16][4], ds_lo[BQ / 16][4];
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks) {
        wg::a_split(p_hi[ks], p_lo[ks], sT, ks);
        wg::a_split(ds_hi[ks], ds_lo[ks], dpT, ks);
      }
      wg::fence_acc(acc_dv);
      wg::fence_acc(acc_dk);
      wg::fence();
      const uint64_t dqs = wg::desc(sQ) + group * PANEL_DESC;
      const uint64_t ddos = wg::desc(sDO) + group * PANEL_DESC;
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks) {  // rows 16 ks .. 16 ks + 15
        wg::mma_rs64_mn(acc_dv, p_hi[ks], ddos + 128 * ks);
        wg::mma_rs64_mn(acc_dv, p_lo[ks], ddos + 128 * ks);
        wg::mma_rs64_mn(acc_dk, ds_hi[ks], dqs + 128 * ks);
        wg::mma_rs64_mn(acc_dk, ds_lo[ks], dqs + 128 * ks);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_acc(acc_dv);
      wg::fence_acc(acc_dk);
    }
    __syncthreads();  // the next step refills this stage
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // Rows in [valid_end, Tq) are uniform over the Tk keys: each adds
  // dO_row / s_row to every dV row, summed in the slice's columns from
  // device memory (keys past m_len and blocks with no q-tile included)
  slice_sums<DKV_THREADS>(usum, scratch, dout + q_base + c0, D, valid_end, Tq, s_in + stat_base);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dv[j][e] += usum[64 * group + j * 8 + col_in + (e & 1)];

  // dK * scale and dV, staged through the slices' tiles, each group into its panel
  wg::stage_acc(sQ + group * TILE_ELEMS, acc_dk, scale, scale);
  wg::stage_acc(sDO + group * TILE_ELEMS, acc_dv, 1.f, 1.f);
  __syncthreads();
  store_slice<DKV_THREADS>(dk + k_base + c0, sQ, D, k0, k_rows);
  store_slice<DKV_THREADS>(dv + k_base + c0, sDO, D, k0, k_rows);
}

}  // namespace

namespace wide {

cudaError_t fwd_tc(const void* q, const void* k, const void* v, const void* q_len,
                   const void* m_len, void* o, void* m, void* s, int B, int H, int Tq, int Tk,
                   int D, float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;
  const cudaError_t err = opt_in(fwd_tc_wide_kernel, FWD_SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ, D / SLICE);
  fwd_tc_wide_kernel<<<grid, FWD_THREADS, FWD_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(q_len), static_cast<const int*>(m_len), static_cast<bf16*>(o),
      static_cast<float*>(m), static_cast<float*>(s), H, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

cudaError_t dq_tc(const void* q, const void* k, const void* v, const void* dout, const void* o,
                  const void* q_len, const void* m_len, const void* m, const void* s,
                  void* delta, void* dq, int B, int H, int Tq, int Tk, int D, float scale,
                  int causal, cudaStream_t stream) {
  static bool smem_set = false;
  const cudaError_t err = opt_in(dq_tc_wide_kernel, DQ_SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ, D / SLICE);
  dq_tc_wide_kernel<<<grid, DQ_THREADS, DQ_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(o),
      static_cast<const int*>(q_len), static_cast<const int*>(m_len),
      static_cast<const float*>(m), static_cast<const float*>(s), static_cast<float*>(delta),
      static_cast<bf16*>(dq), H, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

cudaError_t dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                   const void* q_len, const void* m_len, const void* m, const void* s,
                   const void* delta, void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
                   float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;
  const cudaError_t err = opt_in(dkv_tc_wide_kernel, DKV_SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tk + BK - 1) / BK, D / SLICE);
  dkv_tc_wide_kernel<<<grid, DKV_THREADS, DKV_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const int*>(q_len),
      static_cast<const int*>(m_len), static_cast<const float*>(m),
      static_cast<const float*>(s), static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace wide
