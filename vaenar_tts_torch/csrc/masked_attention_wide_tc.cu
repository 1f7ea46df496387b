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
// The backward: why a design of its own. Every D <= 256 kernel holds at
// least one operand at the full width in shared memory: at D = 384 the dQ
// kernel's Q, dO and K/V ring (294,912 bytes) pass the 232,448 bytes a
// block has. So no backward block holds an operand at the full width, and
// nothing grows with D:
//   * the grid has an axis over D / 128 slices of 128 output columns (dQ,
//     or dK and dV), as the D = 256 kernels' two slices;
//   * S = Q.K^T and dP = dO.V^T are summed over the D / 64 panels of 64
//     columns, which stream through a two-stage ring of cp.async copies
//     (the next panel loading while this one multiplies), each panel a
//     wgmma K-major operand (wgmma_bf16.cuh's swizzled layout);
//   * a block holds besides only its own 128-column slice of the operand
//     that the second product reads (K in dQ, Q and dO in dK/dV), loaded
//     with a tile's first panel and read after its last, and the row
//     statistics of the tile.
// Each slice forms its own S and dP: they are formed D / 128 times. Slice 0
// writes delta (dQ); every slice forms delta, from O's and dO's whole rows
// in device memory. Shared memory a block: 81,920 (dQ), 108,800 (dK/dV)
// bytes with the 1 KB alignment, at every width. What bounds them at the
// head_widths model's sites (one head of 384, B = 4 at synthesis, 32 at a
// train step) is neither bytes nor operations, by chip_smoke.py's count,
// but a block's chain of dependent steps, D / 64 panel steps a key tile,
// each a round of copies, a barrier and a wgmma of 4 k-steps: one warp
// group (two in dK/dV) a block, tiles of 64 not narrowed, Q (or K) panels
// read again for every tile. Their times beside the bound: PERF.md §6.
//
// The forward (fwd_tc_wide_kernel) forms S once a (q-block, key tile) for
// up to 512 output columns. Its first version had the backward's shape
// (one warp group a block, D / 128 slices, S formed in each, a chain of
// D / 64 ring steps a key tile), and lost to SDPA at 1024 x 4104: there
// 20 q-blocks with keys x D / 128 slices are each a chain of 65 key tiles
// x D / 64 dependent steps on 132 SMs. Here:
//   * a block takes 64 query rows and ceil(D / 512)-th of o's columns (one
//     slice at D = 384 and 512), with G warp groups (G = 3 at D = 384,
//     else 4), each owning 128 of the slice's columns in registers (64
//     floats a thread);
//   * of every key tile, group g forms S for its share of the 64 keys (16
//     each at G = 4; 24, 24 and 16 at G = 3) over the whole width, one
//     wgmma chain without a barrier; the groups share their row maxima
//     through shared memory (every group then takes the same max, and so
//     the same rescale of o), and write P split into bf16 high and low
//     parts (as in masked_attention_fwd_tc.cu: P rounded once to bf16
//     missed chip_smoke.py's tolerance) into two shared panels, which
//     every group reads as wgmma's A operand for O += P_hi.V + P_lo.V
//     over its columns: three barriers a key tile;
//   * Q stays in shared memory for the block's life (64 x D bf16: 48 KB at
//     D = 384, 64 KB at 512), a key tile's K (all D columns) and V (the
//     slice) load whole, K for the next tile while this one's P.V runs and
//     V while its S is formed; above 512 columns Q and K go in chunks of
//     512, one after the other (no width above 512 is on a model's path);
//   * a grid of few q-blocks and long rows of keys splits each q-block's
//     key tiles over a cluster of up to 4 blocks (wide::key_ranks, as the
//     fp32 3xTF32 forward), which merge their (row max, row sum, o)
//     through distributed shared memory;
//   * rows at or past q_len: the first q-block of the (b, h, slice) that
//     holds only such rows and the ones after it (and their ranks) share
//     the 128-column passes of mean(v) over the slice, in V's buffer
//     before the first tile loads there.
// Shared memory a block: 168,448 bytes at G = 3, 218,112 at G = 4 (one
// block an SM). What bounds it: bytes, by chip_smoke.py's count (at
// 1024 x 4104 0.0078 ms at D = 384, 0.0104 at 512), and it takes about ten
// times that (PERF.md §6): a block's chain of key tiles, each two whole
// loads (K, V) of which only one is in flight while the block computes,
// three block barriers and two dependent wgmma chains.
//
// Per block of the backward:
//   dQ (one warp group, 64 query rows, one slice of dQ): delta from O and
//     dO, then per key tile S and dP over the panels, dS = P * (dP -
//     delta) where unmasked, dQ += dS_hi.K + dS_lo.K over the slice.
//   dK/dV (two warp groups, 64 keys, one slice of dK and dV; group g owns
//     its 64 columns, as in masked_attention_bwd_dkv_tc.cu): per q-tile
//     S^T and dP^T over the panels, formed by both groups, then P^T and
//     dS^T, dV += P^T.dO and dK += dS^T.Q over the group's panel of the
//     slice; after the loop the fully masked rows' dO / s, summed over the
//     slice's columns from device memory, is added to every dV row.

#include <cooperative_groups.h>

#include "attention_wide.cuh"
#include "wgmma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;

using tc::bf16;
using tc::NEG;
using wg::PANEL_DESC;
using wg::TILE_ELEMS;

constexpr int BQ = 64;      // query rows of a block (forward, dQ) or of a q-tile (dK/dV)
constexpr int BK = 64;      // keys of a tile (forward, dQ) or of a block (dK/dV)
constexpr int PANEL = 64;   // columns of a streamed panel
constexpr int SLICE = 128;  // output columns of a backward block, and of a padding-row pass
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

constexpr int GROUP_COLS = 128;  // o's columns a consumer warp group owns: two panels
constexpr int FWD_MAX_RANKS = 4;  // blocks of a cluster, which split a q-block's key tiles
constexpr int FWD_MIN_TILES_A_RANK = 8;  // key tiles a rank keeps at least, when keys are split

// Warp groups a block: G = 4 (512 output columns a slice, and Q and K in
// chunks of 512 columns), or G = 3 at D = 384. Each owns 128 columns of o.
// Of every key tile, group g forms S for the 8 fwd_frags<G>() keys from
// fwd_key0<G>(g), and owns those from its fragment fwd_first<G>(g): 16
// keys each at G = 4; 24 each at G = 3, where the last group forms keys
// 40-63 and drops 40-47, the second group's (one product width for every
// group: a product whose width depended on the group would be a branch
// that ptxas serializes every wgmma of the kernel for).
template <int G>
__host__ __device__ constexpr int fwd_frags() { return G == 4 ? 2 : 3; }
template <int G>
__host__ __device__ constexpr int fwd_key0(int g) { return G == 4 ? 16 * g : g < 2 ? 24 * g : 40; }
template <int G>
__host__ __device__ constexpr int fwd_first(int g) { return G == 3 && g == 2 ? 1 : 0; }

// Shared memory of a block: the Q chunk (resident when D <= 128 G), the key
// tile's K chunk and V slice, 2 G panels each; P's bf16 high and low parts
// (a panel each); each group's row maxima and row sums of a tile [G][64];
// each rank's row max and sum [FWD_MAX_RANKS][2][64]; 1 KB for alignment
template <int G>
__host__ __device__ constexpr size_t fwd_smem() {
  return sizeof(bf16) * (3 * 2 * G + 2) * TILE_ELEMS +
         sizeof(float) * (2 * G * BQ + 2 * FWD_MAX_RANKS * BQ) + wg::ALIGN;
}

// `panels` 64-column panels of rows [row0, row0 + 64) of a bf16 matrix whose
// rows are ld elements apart (src at the first panel's column 0) into
// consecutive swizzled panels, as asynchronous copies by THREADS threads;
// rows at or past `rows_end` become zeros.
template <int THREADS>
__device__ __forceinline__ void load_panels(bf16* dst, const bf16* __restrict__ src, int ld,
                                            int panels, int row0, int rows_end, int tid) {
  for (int c = tid; c < panels * BQ * 8; c += THREADS) {
    const int p = c >> 9, r = (c >> 3) & (BQ - 1), ch = c & 7;
    const bool in = row0 + r < rows_end;
    tc::cp_async16(dst + p * TILE_ELEMS + wg::swz(r, ch),
                   in ? src + (size_t)(row0 + r) * ld + p * PANEL + ch * 8 : src, in);
  }
}

// sc (8 J keys of S) += Q . K^T over `panels` panels: dq at Q's first
// panel, dk at K's first panel from the group's first key
template <int J>
__device__ __forceinline__ void s_product(float (&sc)[J][4], uint64_t dq, uint64_t dk,
                                          int panels) {
  wg::fence_acc(sc);
  wg::fence();
  for (int p = 0; p < panels; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_ss<8 * J>(sc, dq + p * PANEL_DESC + 2 * kk, dk + p * PANEL_DESC + 2 * kk);
  wg::commit();
  wg::wait<0>();
  wg::fence_acc(sc);
}

template <int G>
__global__ void __launch_bounds__(128 * G)
fwd_tc_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ q_len,
                   const int* __restrict__ m_len, bf16* __restrict__ o, float* __restrict__ m_out,
                   float* __restrict__ s_out, int H, int Tq, int Tk, int D, float scale,
                   int causal, int ranks) {
  constexpr int THREADS = 128 * G;
  constexpr int W = GROUP_COLS * G;  // columns of a slice of o, and of a chunk of Q and K
  constexpr int NPAN = W / PANEL;    // panels of the Q, K and V buffers
  constexpr int J = fwd_frags<G>();  // S fragments a thread (8 keys each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(wg::aligned_smem(smem_raw));  // [NPAN] panels of Q
  bf16* sK = sQ + NPAN * TILE_ELEMS;  // the key tile's K; stages o at the end
  bf16* sV = sK + NPAN * TILE_ELEMS;  // its V in the slice; the padding sums' scratch first
  bf16* sP = sV + NPAN * TILE_ELEMS;  // P's high part, then its low part
  float* sMax = reinterpret_cast<float*>(sP + 2 * TILE_ELEMS);  // [G][64]: row maxima of a tile
  float* sSum = sMax + G * BQ;                                  // [G][64]: row sums at the end
  float* sRank = sSum + G * BQ;  // [ranks][2][64]: each rank's row max and sum

  const int tid = threadIdx.x, lane = tid & 31;
  const int grp = tid >> 7, warp = (tid >> 5) & 3;  // warp group, warp in it (rows 16 warp ..)
  const int bh = blockIdx.x;                         // b * H + h
  const int b = bh / H;
  // the last q-block first: when causal its chain of key tiles is the longest
  const int qb = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int q0 = qb * BQ;
  const int q_rows = min(BQ, Tq - q0);
  // blockIdx.z = slice * ranks + rank: the slice's ranks are one cluster,
  // rank r takes the q-block's key tiles r, r + ranks, ...
  const int rank = (int)blockIdx.z % ranks;
  const int c0 = ((int)blockIdx.z / ranks) * W;  // this slice's columns of o and v
  const int cols = min(W, D - c0);               // a multiple of 128
  const bool writes_stats = (int)blockIdx.z < ranks;  // slice 0
  // the group owns columns of o (every group at D <= W; past `cols` a
  // group multiplies a panel of its own, unused, so that no wgmma is in a
  // branch)
  const bool has_cols = grp * GROUP_COLS < cols;
  const int chunks = (D + W - 1) / W;  // Q and K column chunks a tile: 1 (Q resident) at D <= W
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
  const int n_tiles = q0 < pad0 ? (k_end + BK - 1) / BK : 0;  // the q-block's
  const int my_tiles = n_tiles > rank ? (n_tiles - rank + ranks - 1) / ranks : 0;

  // Q's and K's chunk ch of this rank's tile i (Q only when streamed)
  auto load_qk = [&](int i, int ch) {
    const int panels = min(W, D - ch * W) / PANEL;
    if (chunks > 1) load_panels<THREADS>(sQ, q + q_base + ch * W, D, panels, q0, rows_end, tid);
    load_panels<THREADS>(sK, k + k_base + ch * W, D, panels, (rank + i * ranks) * BK, k_end, tid);
  };
  if (my_tiles > 0) {
    if (chunks == 1) load_panels<THREADS>(sQ, q + q_base, D, D / PANEL, q0, rows_end, tid);
    load_qk(0, 0);
    tc::cp_async_commit();
  }

  // The rows at or past pad0 of the (b, h, slice), in its columns, while
  // the copies above land: o = mean(v), and in slice 0 m = NEG, s = Tk.
  // The first q-block whose rows start there and the q-blocks after it,
  // which hold padding rows only, take the 128-column passes in turn (a
  // pass reads v's column block once and writes every padding row); the
  // sums go through V's buffer, which loads after them
  const int writer = min((pad0 + BQ - 1) / BQ, (int)gridDim.y - 1);
  if (pad0 < Tq && qb >= writer) {
    constexpr int TPR = SLICE / 8;  // threads a row, 8 columns each
    float* sum = reinterpret_cast<float*>(sV);
    const int slot = (qb - writer) * ranks + rank, slots = ((int)gridDim.y - writer) * ranks;
    for (int c = SLICE * slot; c < cols; c += SLICE * slots) {
      slice_sums<THREADS>(sum, sum + SLICE, v + k_base + c0 + c, D, 0, Tk, nullptr);
      const int c8 = (tid % TPR) * 8;
      uint4 mean;
      __nv_bfloat162* mean2 = reinterpret_cast<__nv_bfloat162*>(&mean);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mean2[i] = __floats2bfloat162_rn(sum[c8 + 2 * i] / (float)Tk,
                                         sum[c8 + 2 * i + 1] / (float)Tk);
      for (int r = pad0 + tid / TPR; r < Tq; r += THREADS / TPR)
        *reinterpret_cast<uint4*>(o + q_base + (size_t)r * D + c0 + c + c8) = mean;
    }
    for (int r = pad0 + tid; writes_stats && slot == 0 && r < Tq; r += THREADS) {
      m_out[stat_base + r] = NEG;
      s_out[stat_base + r] = (float)Tk;
    }
    __syncthreads();  // every thread is done with the sums before V loads there
  }
  // (the same for every rank of the cluster, which must all reach its
  // barriers: a rank without a tile holds m = NEG, sum 0, o = 0)
  if (n_tiles == 0) return;

  // this lane's two rows (g and g + 8 of its warp's 16), their unmasked
  // keys [0, lim), its column pair; the group's keys of a tile
  const int rl_lo = warp * 16 + (lane >> 2);  // in the block
  const int row_lo = q0 + rl_lo, row_hi = row_lo + 8;
  const int col_in = (lane & 3) * 2;
  auto row_lim = [&](int row) {
    const int lim = row < pad0 ? klim : 0;
    return causal ? min(lim, row + 1) : lim;
  };
  const int lim[2] = {row_lim(row_lo), row_lim(row_hi)};
  const int kg = fwd_key0<G>(grp), j0 = fwd_first<G>(grp);
  float acc[GROUP_COLS / 8][4];  // O in the group's columns, wgmma's D fragment
  float row_max[2] = {NEG, NEG}, row_sum[2] = {0.f, 0.f};  // row_sum: the group's keys
  float sc[J][4];
  wg::zero(acc);

  for (int i = 0; i < my_tiles; ++i) {
    const int kt = (rank + i * ranks) * BK;

    // S = Q.K^T over the chunks' panels, the group's keys
    wg::zero(sc);
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch > 0) {  // every group is done with chunk ch - 1
        __syncthreads();
        load_qk(i, ch);
        tc::cp_async_commit();
      }
      tc::cp_async_wait<0>();  // chunk ch of Q and K has landed
      wg::fence_async_smem();
      __syncthreads();
      if (ch == 0) {  // the tile's V, read after S: every group is done with the tile before
        load_panels<THREADS>(sV, v + k_base + c0, D, cols / PANEL, kt, k_end, tid);
        tc::cp_async_commit();
      }
      const int panels = min(W, D - ch * W) / PANEL;
      s_product(sc, wg::desc(sQ), wg::desc(sK + kg * PANEL), panels);
    }

    // mask and scale (masked columns NEG, columns past Tk -inf; a warp
    // whose rows see every key of the group skips the mask), then the
    // group's row maxima of its keys of the tile to sMax
    if (__all_sync(0xffffffffu, kt + kg + 8 * J <= min(lim[0], lim[1]))) {
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= scale;
    } else {
      const int base = kt + kg + col_in;
      const int bound[2] = {lim[0] - base, lim[1] - base};
      const int keys = Tk - base;
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + (e & 1);
          sc[j][e] = c < bound[e >> 1] ? sc[j][e] * scale : (c < keys ? NEG : -INFINITY);
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (j >= j0) tile_max = fmaxf(tile_max, fmaxf(sc[j][2 * h], sc[j][2 * h + 1]));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      if ((lane & 3) == 0) sMax[grp * BQ + rl_lo + 8 * h] = tile_max;
    }
    __syncthreads();  // every group's maxima are in sMax, and every group is done with K
    if (i + 1 < my_tiles) load_qk(i + 1, 0);  // the next tile's K, while P.V runs
    tc::cp_async_commit();

    // the online softmax: every group takes the same row max, so alpha and
    // the rescale of o agree over the groups
    float alpha[2], m_log2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m_tile = NEG;
#pragma unroll
      for (int g = 0; g < G; ++g) m_tile = fmaxf(m_tile, sMax[g * BQ + rl_lo + 8 * h]);
      const float m_new = fmaxf(row_max[h], m_tile);
      alpha[h] = __expf(row_max[h] - m_new);
      row_max[h] = m_new;
      // a row whose max is still NEG (every key masked: a row past q_len,
      // never written, or a rank's partial, which the merge weighs by 0)
      // takes 0 for its terms
      m_log2[h] = m_new == NEG ? 0.f : m_new * LOG2E;
    }
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = wg::ex2(fmaf(sc[j][e], LOG2E, -m_log2[e >> 1]));
        if (j >= j0) part[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) row_sum[h] = row_sum[h] * alpha[h] + part[h];
    if (has_cols && __any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < GROUP_COLS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    }
    // P of the group's keys to sP as bf16 high and low parts (split once,
    // here), for every group's P.V
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j < j0) continue;
      uint32_t hi, lo;
      const int at_lo = wg::swz(rl_lo, kg / 8 + j) + col_in;
      const int at_hi = wg::swz(rl_lo + 8, kg / 8 + j) + col_in;
      tc::split_bf16(sc[j][0], sc[j][1], hi, lo);
      *reinterpret_cast<uint32_t*>(sP + at_lo) = hi;
      *reinterpret_cast<uint32_t*>(sP + TILE_ELEMS + at_lo) = lo;
      tc::split_bf16(sc[j][2], sc[j][3], hi, lo);
      *reinterpret_cast<uint32_t*>(sP + at_hi) = hi;
      *reinterpret_cast<uint32_t*>(sP + TILE_ELEMS + at_hi) = lo;
    }
    tc::cp_async_wait<1>();  // the tile's V has landed (the next K may still be in flight)
    wg::fence_async_smem();
    __syncthreads();  // P and V are in shared memory

    // O += P_hi . V + P_lo . V over the group's two panels of V
    wg::fence_acc(acc);
    wg::fence();
    const uint64_t dph = wg::desc(sP), dpl = wg::desc(sP + TILE_ELEMS);
    const uint64_t dv = wg::desc(sV + 2 * grp * TILE_ELEMS);
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {  // keys 16 s .. 16 s + 15
      wg::mma_ss64_mn(acc, dph + 2 * s, dv + 128 * s);
      wg::mma_ss64_mn(acc, dpl + 2 * s, dv + 128 * s);
      wg::mma_ss64_mn<8>(acc, dph + 2 * s, dv + PANEL_DESC + 128 * s);
      wg::mma_ss64_mn<8>(acc, dpl + 2 * s, dv + PANEL_DESC + 128 * s);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(acc);
  }
  tc::cp_async_wait<0>();

  // the rows' sums over the block's groups (a quad, then the groups)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
    if ((lane & 3) == 0) sSum[grp * BQ + rl_lo + 8 * h] = row_sum[h];
  }
  __syncthreads();  // and every group is done with K and V
  float total[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int g = 0; g < G; ++g) total[h] += sSum[g * BQ + rl_lo + 8 * h];

  if (ranks == 1) {
    // o = acc / s for the rows below rows_end, staged through K's buffer,
    // each group into its two panels
    if (has_cols) {
      wg::stage_acc(sK + 2 * grp * TILE_ELEMS, acc, 1.f / total[0], 1.f / total[1]);
      wg::stage_acc<8>(sK + (2 * grp + 1) * TILE_ELEMS, acc, 1.f / total[0], 1.f / total[1]);
    }
    if (writes_stats && grp == 0 && (lane & 3) == 0) {
      if (row_lo < rows_end) {
        m_out[stat_base + row_lo] = row_max[0];
        s_out[stat_base + row_lo] = total[0];
      }
      if (row_hi < rows_end) {
        m_out[stat_base + row_hi] = row_max[1];
        s_out[stat_base + row_hi] = total[1];
      }
    }
    __syncthreads();
    const int cpr = cols / 8;  // 16-byte chunks a row
    for (int c = tid; c < (rows_end - q0) * cpr; c += THREADS) {
      const int r = c / cpr, ch = c - r * cpr;
      *reinterpret_cast<uint4*>(o + q_base + (size_t)(q0 + r) * D + c0 + ch * 8) =
          *reinterpret_cast<const uint4*>(sK + wg::swz(r, ch));
    }
    return;
  }

  // Ranks > 1: rank r owns columns [r own, (r + 1) own) of the slice. Every
  // rank sends its partial o there, and its row max and sum to every rank,
  // through distributed shared memory; the owner merges them as the online
  // softmax merges two tiles (a rank without a key of a row holds m = NEG
  // and drops out with weight exp(NEG - m) = 0) in rank order, and writes
  // its columns of o (rank 0: m and s too).
  cg::cluster_group cluster = cg::this_cluster();
  const int own = cols / ranks;  // a multiple of 32
  float* xbuf = reinterpret_cast<float*>(sQ);  // [ranks][64][own + 4], over Q, K and V
  cluster.sync();  // every rank is done with its Q, K, V and P
  if (grp == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      for (int r = 0; r < ranks; ++r) {
        float* stat = cluster.map_shared_rank(sRank, r);
        stat[(2 * rank) * BQ + rl_lo + 8 * h] = row_max[h];
        stat[(2 * rank + 1) * BQ + rl_lo + 8 * h] = total[h];
      }
    }
  }
  if (has_cols) {
#pragma unroll
    for (int j = 0; j < GROUP_COLS / 8; ++j) {
      const int col = grp * GROUP_COLS + 8 * j + col_in, owner = col / own;
      float* dst = cluster.map_shared_rank(xbuf, owner) + (rank * BQ + rl_lo) * (own + 4) + col -
                   owner * own;
      *reinterpret_cast<float2*>(dst) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(dst + 8 * (own + 4)) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  cluster.sync();  // every rank's partials have landed
  const int c4s = own / 4;  // 4-column chunks of a row
  for (int c = tid; c < BQ * c4s; c += THREADS) {
    const int rl = c / c4s, col = (c - rl * c4s) * 4, row = q0 + rl;
    if (row >= rows_end) continue;
    float m_all = NEG;
    for (int r = 0; r < ranks; ++r) m_all = fmaxf(m_all, sRank[2 * r * BQ + rl]);
    float sum = 0.f;
    float4 x_all = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < ranks; ++r) {
      const float w = __expf(sRank[2 * r * BQ + rl] - m_all);
      sum = fmaf(sRank[(2 * r + 1) * BQ + rl], w, sum);
      const float4 x = *reinterpret_cast<const float4*>(xbuf + (r * BQ + rl) * (own + 4) + col);
      x_all = make_float4(fmaf(x.x, w, x_all.x), fmaf(x.y, w, x_all.y), fmaf(x.z, w, x_all.z),
                          fmaf(x.w, w, x_all.w));
    }
    const float inv = 1.f / sum;
    uint2 out;
    __nv_bfloat162* out2 = reinterpret_cast<__nv_bfloat162*>(&out);
    out2[0] = __floats2bfloat162_rn(x_all.x * inv, x_all.y * inv);
    out2[1] = __floats2bfloat162_rn(x_all.z * inv, x_all.w * inv);
    *reinterpret_cast<uint2*>(o + q_base + (size_t)row * D + c0 + rank * own + col) = out;
    if (writes_stats && rank == 0 && col == 0) {
      m_out[stat_base + row] = m_all;
      s_out[stat_base + row] = sum;
    }
  }
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

// The forward at G warp groups a block (D = 384: 3; else 4): ceil(D / 128 G)
// slices, each q-block's key tiles split over a cluster of wide::key_ranks
// blocks
template <int G>
cudaError_t fwd_tc_launch(const void* q, const void* k, const void* v, const void* q_len,
                          const void* m_len, void* o, void* m, void* s, int B, int H, int Tq,
                          int Tk, int D, float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;
  const cudaError_t err = wide::opt_in(fwd_tc_wide_kernel<G>, fwd_smem<G>(), smem_set);
  if (err != cudaSuccess) return err;
  const int slices = (D + GROUP_COLS * G - 1) / (GROUP_COLS * G), q_blocks = (Tq + BQ - 1) / BQ;
  const int ranks = wide::key_ranks(B * H * q_blocks * slices, (Tk + BK - 1) / BK, FWD_MAX_RANKS,
                                    FWD_MIN_TILES_A_RANK, 1);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * H, q_blocks, slices * ranks);
  config.blockDim = dim3(128 * G);
  config.dynamicSmemBytes = fwd_smem<G>();
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = ranks;
  config.attrs = cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, fwd_tc_wide_kernel<G>, static_cast<const bf16*>(q),
                            static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                            static_cast<const int*>(q_len), static_cast<const int*>(m_len),
                            static_cast<bf16*>(o), static_cast<float*>(m), static_cast<float*>(s),
                            H, Tq, Tk, D, scale, causal, ranks);
}

}  // namespace

namespace wide {

cudaError_t fwd_tc(const void* q, const void* k, const void* v, const void* q_len,
                   const void* m_len, void* o, void* m, void* s, int B, int H, int Tq, int Tk,
                   int D, float scale, int causal, cudaStream_t stream) {
  return D == 384 ? fwd_tc_launch<3>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, D, scale,
                                     causal, stream)
                  : fwd_tc_launch<4>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, D, scale,
                                     causal, stream);
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
