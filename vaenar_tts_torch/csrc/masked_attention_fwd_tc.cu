// Masked multi-head attention, forward, bf16 on Hopper's tensor cores
// (wgmma), for sm_90a. Plain C interface, bound from Python with ctypes
// (vaenar_tts_torch/ops/flash_attention.py); bf16 q, k, v take this kernel,
// fp32 ones masked_attention_fwd.cu.
//
// Replaces the two forward Pallas kernels of
// vaenar_tts_tpu/ops/flash_attention.py for bf16 inputs:
//   _fwd_kernel          (l.104, pallas_call l.299)
//   _fwd_kernel_blocked  (l.142, pallas_call l.224; Tk > 4096)
// One online-softmax loop over 64-key tiles serves both.
//
// Contract (the Pallas kernels', and masked_attention_fwd.cu's):
// logits = q.k^T * scale; the mask is row < q_len[b] && col < m_len[b]
// (&& col <= row when causal); masked logits become NEG = -2^32+1, not -inf,
// and the running max starts at NEG, so a row with nothing unmasked comes
// out uniform over the Tk keys (o = mean(v), m = NEG, s = Tk); columns past
// Tk contribute nothing. Softmax, row max m and row sum s are fp32; o is
// written in bf16, m and s as fp32 [B, H, Tq]. Null length pointers mean
// full lengths.
//
// What bounds it on an H100 at the main path's bf16 shapes (B=4, H=4, D=64;
// synthesis: text 160, reduced mel 1680 of which ~460-580 rows are valid;
// train step: batch 32, text 32, reduced mel 240 with 54-144 valid): not
// bytes or operations. By chip_smoke.py's count a synthesis call's sites
// need 0.062 ms (bytes) and a train step's 0.082 ms; the kernel takes
// several times that, because a launch lasts as long as its heaviest
// block's chain of dependent steps (scripts/torch_attention_blocks.py
// times every block): the lengths, the loads of Q and the first K/V tile,
// then per key tile the product S = Q.K^T, the mask and the softmax's
// exponentials and reductions, the split of P and the product O += P.V,
// then the store. With one warp group a block, each scheduler of the SM
// has one warp of the chain to issue, so a tile's elementwise work, not
// its products, is most of its time. At the synthesis causal site the last
// valid q-tile walks ~9 key tiles, and the rows past q_len (~1,100 at that
// site) need a pass over all 1,680 rows of V.
//
// Design for that chain. A block takes one (b, h) and 64 query rows with
// one warp group, or with two when Tk > 512, which split the key tiles
// (even and odd; a group with no tile drops out of the merge) and merge
// (row max, row sum, accumulator) through shared memory at the end, as the
// online softmax merges two tiles.
//   * Products are wgmma.mma_async over the whole warp group (m64nNk16):
//     S = Q.K^T with Q and K from shared memory, N = the tile's keys;
//     O += P.V with P from registers (the D fragment of S is the A
//     fragment of P.V) and V from shared memory as an MN-major B.
//   * Tiles land in wgmma's 128-byte-swizzled layout straight from
//     cp.async (chunk c of row r at c ^ (r & 7)), so no copy or ldmatrix
//     sits between a load and a product; each group streams its K and V
//     tiles through its own two-stage ring, the next tile loading while
//     the current one multiplies.
//   * The last key tile is narrowed to the keys it needs (at m_len, or at
//     the q-tile's last valid row when causal), rounded up to 16:
//     N = 16, 32, 48 or 64, each width its own instantiation.
//   * Fewer instructions on the chain: each row's mask is one bound, and a
//     warp whose rows see the whole tile skips it; the row max and sum are
//     trees; exp is one fma and ex2; the accumulator is rescaled only
//     when a row max of the warp moved.
//   * The padding rows are shared out over up to 4 blocks (a single
//     writer ran as long as the heaviest key loop), and a block that also
//     has valid rows issues its Q and K/V loads before its share, which
//     then runs while they land.
// The online softmax runs in fp32 registers; a row's max and sum are
// reduced over the 4 lanes (a quad) that hold it, as in the D layout of
// wgmma_bf16.cuh. o is staged through shared memory for 16-byte stores.
//
// P's precision: the plain version keeps P fp32 for P.V. Here P is split
// into a bf16 high part and a bf16 low part, and P.V = P_hi.V + P_lo.V, two
// products (about 16 bits of P kept, relative error <= 2^-17). P rounded
// once to bf16 (relative error up to 2^-9) exceeded chip_smoke.py's bf16
// tolerance, 1e-3 + 2^-7 |o| (unchanged), at every checked shape, on rows
// where p.v terms cancel; with the split, the measured worst share of that
// tolerance is in PERF.md §6.
//
// Work skipped without changing the result:
//   * rows at or past q_len (all rows when m_len == 0) are fully masked;
//     the writers above give them mean(v), NEG and Tk (masked_attention_fwd.cu
//     makes that pass in every block that holds such rows);
//   * the key loop stops at m_len and, when causal, at the tile's last
//     valid row: each skipped term is exp(NEG - m) = 0 exactly in fp32.
//
// Resources (ptxas -v, CUDA 12.8; chip_smoke.py and
// scripts/torch_attention_sites.py print them): 128 registers a thread with
// one group, 127 with two, no spills, so four blocks (two) fit on an SM.
// Shared memory: Q and a two-stage K/V ring for each group, 5 or 9 tiles of
// 64 x 64 bf16 and 1 KB for alignment = 41,984 or 74,752 bytes a block.

// Head widths. The kernel is a template of the head width, compiled for
// D = 64 (the design above) and D = 128; the C entry point runs the one
// its D names, and the wrapper pads every other width up to 128 with zero
// columns. At D = 128 a tile is two 64-column swizzled panels
// (wgmma_bf16.cuh): S = Q.K^T runs 4 k-steps on each panel, and O += P.V
// is two products of N = 64, one into each half of a 64 x 128 fp32
// accumulator (64 floats a thread in place of 32); the softmax, the warp
// groups and the narrowed key tiles are D = 64's. Shared memory 82,944 or
// 148,480 bytes a block; registers in PERF.md §6.
//
// D = 256 (slices of 128 columns). One group's 64 x 256 fp32 accumulator
// would be 128 floats a thread, near ptxas's cap of 255 registers, and two
// groups' rings at the full width (295,936 bytes) do not fit. So the grid
// gains an axis over two column slices of o: each block forms S = Q.K^T
// over all four 64-column panels of Q and K (16 k-steps) and O += P.V over
// the two panels of V in its slice, so its accumulator, softmax and
// narrowed key tiles are D = 128's. S is formed once a slice, twice in
// all. Both slices compute the same m and s; slice 0 writes them (and the
// padding rows' NEG and Tk), each slice its columns of o and of the
// padding rows' mean(v). Shared memory: Q at the full width and, for each
// group, a two-stage ring of a full-width K tile and a sliced V tile,
// 132,096 or 230,400 bytes a block.

#include "attention_wide.cuh"
#include "wgmma_bf16.cuh"

namespace {

using tc::bf16;
using tc::NEG;
using wg::PANEL_DESC;
using wg::TILE_ELEMS;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int GROUP_THREADS = 128;  // a warp group: 4 warps, 16 query rows each
constexpr int STAGES = 2;  // K/V tiles in a group's ring: one loads while one multiplies
// Keys above which a block takes two warp groups: measured on an H100, two
// groups shorten the long sites (Tk 1680 and 4104) and slow the short ones
// (at Tk > 128 the train step's causal 240 site no longer fits its blocks on
// the SMs at once)
constexpr int TWO_GROUPS_MIN_TK = 512;
constexpr int PAD_DEPTH = 16;  // loads in flight a thread in the padding rows' pass
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WRITERS = 4;       // blocks of a (b, h) that share the padding rows,
constexpr int WRITER_ROWS = 256;  // each taking this many rows at least

using wg::slice_width;

// Q, then each group's ring: a stage is a K tile of the head width and a V
// tile of the slice, KR + 1 V tiles with KR = HD / slice_width (1, or 2 at
// D = 256)
template <int HD, int GROUPS>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(bf16) * (wg::tile_elems<HD>() +
                         GROUPS * STAGES * (HD / slice_width<HD>() + 1) *
                             wg::tile_elems<slice_width<HD>()>()) +
         wg::ALIGN;
}

// Per-thread state of one warp group's online softmax over its rows, OW
// columns of o.
template <int OW>
struct RowState {
  float acc[OW / 8][4];  // O accumulator, wgmma's D fragment
  float row_max[2], row_sum[2];  // rows g and g + 8 of the warp's 16
};

// op(t[0], ..., t[N - 1]) as a tree: pairs at distance 1, then 2, 4, ...
template <int N, typename Op>
__device__ __forceinline__ float tree(float (&t)[N], Op op) {
#pragma unroll
  for (int step = 1; step < N; step *= 2)
#pragma unroll
    for (int i = 0; i + step < N; i += 2 * step) t[i] = op(t[i], t[i + step]);
  return t[0];
}

// One key tile of NK keys (16, 32, 48 or 64) starting at key kt: S = Q.K^T
// over the HD / 64 panels of Q and K, the mask, the online softmax, O +=
// P_hi.V + P_lo.V over the OW / 64 panels of the V tile (the block's
// slice). Of this thread's two rows, columns below lim_lo (lim_hi) are
// unmasked; the others are masked (NEG), or have no term at all at or past
// Tk (-inf).
template <int HD, int OW, int NK>
__device__ __forceinline__ void fwd_tile(RowState<OW>& st, uint64_t dq, const bf16* tK,
                                         const bf16* tV, int kt, int col_in, int lim_lo,
                                         int lim_hi, int Tk, float scale) {
  constexpr int J = NK / 8;
  float sc[J][4];
  wg::zero(sc);
  wg::fence_acc(sc);
  wg::fence();
  const uint64_t dk = wg::desc(tK);
#pragma unroll
  for (int p = 0; p < HD / 64; ++p)  // the head width's panels, 4 k-steps each
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_ss<NK>(sc, dq + p * PANEL_DESC + 2 * kk, dk + p * PANEL_DESC + 2 * kk);
  wg::commit();
  wg::wait<0>();
  wg::fence_acc(sc);

  // mask, online softmax in fp32; a warp whose rows see every column of
  // the tile skips the mask
  if (__all_sync(0xffffffffu, kt + NK <= min(lim_lo, lim_hi))) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] *= scale;
  } else {
    // column kt + col_in + c of the tile against the bounds, c constant
    const int base = kt + col_in;
    const int bound[2] = {lim_lo - base, lim_hi - base};
    const int keys = Tk - base;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + (e & 1);
        sc[j][e] = c < bound[e >> 1] ? sc[j][e] * scale : (c < keys ? NEG : -INFINITY);
      }
  }
  // each row's max over its 8 J / 4 columns, as a tree (short dependency
  // chains: one warp a scheduler has little else to issue meanwhile)
  float tile_max[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t[J];
#pragma unroll
    for (int j = 0; j < J; ++j) t[j] = fmaxf(sc[j][2 * h], sc[j][2 * h + 1]);
    tile_max[h] = tree<J>(t, [](float a, float b) { return fmaxf(a, b); });
  }
  float alpha[2], part[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 1));
    tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 2));
    const float m_new = fmaxf(st.row_max[h], tile_max[h]);
    alpha[h] = __expf(st.row_max[h] - m_new);
    st.row_max[h] = m_new;
  }
  // exp(x - m) as 2^(x log2(e) - m log2(e)), one fma; a row whose max is
  // still NEG (every key so far masked) takes m log2(e) = 0, so its terms
  // are 0 and not exp(0) = 1: such a row is past q_len (never written) or a
  // second group's partial, which the merge weighs by exp(NEG - m) = 0
  float m_log2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) m_log2[h] = st.row_max[h] == NEG ? 0.f : st.row_max[h] * LOG2E;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = wg::ex2(fmaf(sc[j][e], LOG2E, -m_log2[e >> 1]));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t[J];
#pragma unroll
    for (int j = 0; j < J; ++j) t[j] = sc[j][2 * h] + sc[j][2 * h + 1];
    part[h] = tree<J>(t, [](float a, float b) { return a + b; });
  }
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a row max moved
#pragma unroll
    for (int j = 0; j < OW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.acc[j][e] *= alpha[e >> 1];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
    part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
    st.row_sum[h] = st.row_sum[h] * alpha[h] + part[h];
  }

  // O += P_hi . V + P_lo . V: P from registers, V an MN-major B, one
  // product of N = 64 for each panel of V
  uint32_t p_hi[NK / 16][4], p_lo[NK / 16][4];
#pragma unroll
  for (int s = 0; s < NK / 16; ++s) wg::a_split(p_hi[s], p_lo[s], sc, s);
  wg::fence_acc(st.acc);
  wg::fence();
  const uint64_t dv = wg::desc(tV);
#pragma unroll
  for (int s = 0; s < NK / 16; ++s) {  // keys 16 s .. 16 s + 15
    wg::mma_rs64_mn(st.acc, p_hi[s], dv + 128 * s);
    wg::mma_rs64_mn(st.acc, p_lo[s], dv + 128 * s);
    if constexpr (OW == 128) {
      wg::mma_rs64_mn<8>(st.acc, p_hi[s], dv + PANEL_DESC + 128 * s);
      wg::mma_rs64_mn<8>(st.acc, p_lo[s], dv + PANEL_DESC + 128 * s);
    }
  }
  wg::commit();
  wg::wait<0>();
  wg::fence_acc(st.acc);
}

template <int HD, int GROUPS>
__global__ void __launch_bounds__(GROUPS * GROUP_THREADS)
masked_attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const int* __restrict__ q_len,
                               const int* __restrict__ m_len, bf16* __restrict__ o,
                               float* __restrict__ m_out, float* __restrict__ s_out, int H,
                               int Tq, int Tk, float scale, int causal) {
  constexpr int THREADS = GROUPS * GROUP_THREADS;
  constexpr int TILE = wg::tile_elems<HD>();
  constexpr int OW = slice_width<HD>(), SLICES = HD / OW, KR = SLICES;
  constexpr int VTILE = wg::tile_elems<OW>();  // a V tile; a K tile is KR of them
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [64][HD] swizzled; stages o at the end

  const int tid = threadIdx.x, lane = tid & 31;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int q0 = blockIdx.y * BQ;
  const int q_rows = min(BQ, Tq - q0);
  const int qlen = q_len ? q_len[b] : Tq;
  const int mlen = m_len ? m_len[b] : Tk;
  const size_t q_base = (size_t)bh * Tq * HD;
  const size_t k_base = (size_t)bh * Tk * HD;
  const size_t stat_base = (size_t)bh * Tq;
  // this block's columns of o and v, [c0, c0 + OW); slice 0 writes m and s
  const int c0 = SLICES > 1 ? (int)blockIdx.z * OW : 0;
  const bool writes_stats = SLICES == 1 || blockIdx.z == 0;

  // Rows at or past pad0 (q_len; every row when m_len <= 0) are fully
  // masked: uniform attention over the Tk keys, o = mean(v), m = NEG,
  // s = Tk. Up to WRITERS blocks of the (b, h) whose tiles start at or past
  // pad0 write them, each a share of the rows, 16 bytes a thread, after its
  // own pass over V in fp32; without such a block the last block writes
  // them all. (A block's bytes move through one SM's share of the memory
  // system: a single writer of the synthesis causal site's ~1,100 rows,
  // after its pass over 1,680 rows of V, ran as long as the longest key
  // loop.)
  const int pad0 = mlen > 0 ? max(0, min(qlen, Tq)) : 0;
  const int first_pad = (pad0 + BQ - 1) / BQ;  // the first block whose tile starts there
  const int pad_blocks = (int)gridDim.y - first_pad;
  const int writers =
      pad0 >= Tq ? 0
                 : (pad_blocks > 0
                        ? max(1, min(min(WRITERS, pad_blocks), (Tq - pad0) / WRITER_ROWS))
                        : 1);
  const int writer = (int)blockIdx.y - (pad_blocks > 0 ? first_pad : (int)gridDim.y - 1);
  const bool computes = q0 < pad0;

  // Valid rows see no key at or past m_len, nor past the diagonal when
  // causal: those terms are exp(NEG - m) = 0 exactly, so the loop stops there.
  const int rows_end = min(q0 + q_rows, pad0);
  int k_end = min(Tk, mlen);
  if (causal) k_end = min(k_end, rows_end);
  const int n_tiles = computes ? (k_end + BK - 1) / BK : 0;

  // Each group's ring holds stage s's K tile at (KR + 1) s V tiles and its
  // V tile (the block's slice) right after it: at 2 s and 2 s + 1 when a
  // block computes every column.
  const int group = tid / GROUP_THREADS, gtid = tid % GROUP_THREADS, gwarp = gtid / 32;
  bf16* ring = sQ + TILE + group * (KR + 1) * STAGES * VTILE;
  auto load_kv = [&](int stage, int t) {
    wg::load_tile_async<GROUP_THREADS, HD>(ring + (KR + 1) * stage * VTILE, k + k_base, t * BK,
                                           Tk, gtid);
    wg::load_tile_async<GROUP_THREADS, OW, HD>(ring + ((KR + 1) * stage + KR) * VTILE,
                                               v + k_base + c0, t * BK, Tk, gtid);
  };
  // Q, loaded by every thread; then each group's first STAGES - 1 tiles, one
  // commit group a tile; issued before the padding rows' pass, which a block
  // with valid rows runs while they land
  if (computes) {
    wg::load_tile_async<THREADS, HD>(sQ, q + q_base, q0, q0 + q_rows, tid);
    tc::cp_async_commit();
#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) {
      const int t = group + p * GROUPS;
      if (t < n_tiles) load_kv(p, t);
      tc::cp_async_commit();
    }
  }

  if (writer >= 0 && writer < writers) {
    // scratch: group 0's last stage, which no load fills before the loop
    constexpr int TPR = OW / 8;  // threads a row, 8 columns each
    float* sum = reinterpret_cast<float*>(sQ + TILE + (KR + 1) * (STAGES - 1) * VTILE);
    wg::column_sums<THREADS, PAD_DEPTH, OW, HD>(sum, sum + OW, v + k_base + c0, 0, Tk, nullptr);
    const int c8 = (tid & (TPR - 1)) * 8;
    uint4 mean;
    __nv_bfloat162* mean2 = reinterpret_cast<__nv_bfloat162*>(&mean);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mean2[i] = __floats2bfloat162_rn(sum[c8 + 2 * i] / (float)Tk, sum[c8 + 2 * i + 1] / (float)Tk);
    const int share = (Tq - pad0 + writers - 1) / writers;
    const int r0 = pad0 + writer * share, r1 = min(Tq, r0 + share);
    for (int r = r0 + (tid >> cpa::log2i(TPR)); r < r1; r += THREADS / TPR) {
      *reinterpret_cast<uint4*>(o + q_base + (size_t)r * HD + c0 + c8) = mean;
    }
    for (int r = r0 + tid; writes_stats && r < r1; r += THREADS) {
      m_out[stat_base + r] = NEG;
      s_out[stat_base + r] = (float)Tk;
    }
    __syncthreads();  // the scratch is a stage of the ring
  }
  if (!computes) return;  // no valid row in this tile
  tc::cp_async_wait<STAGES - 1>();  // this thread's part of Q has landed
  wg::fence_async_smem();
  __syncthreads();  // Q is read by both groups' products

  // this lane's two rows (g and g + 8 of the warp's 16) and column pair
  const int row_lo = q0 + gwarp * 16 + (lane >> 2), row_hi = row_lo + 8;
  const int col_in = (lane & 3) * 2;
  // each row's unmasked columns: [0, lim), none for a row past q_len
  auto row_lim = [&](int row) {
    const int lim = row < qlen ? min(mlen, Tk) : 0;
    return causal ? min(lim, row + 1) : lim;
  };
  const int lim_lo = row_lim(row_lo), lim_hi = row_lim(row_hi);
  RowState<OW> st;
  wg::zero(st.acc);
  st.row_max[0] = st.row_max[1] = NEG;
  st.row_sum[0] = st.row_sum[1] = 0.f;
  const uint64_t dq = wg::desc(sQ);

  // this group's key tiles: group, group + GROUPS, ...
  for (int i = 0, t = group; t < n_tiles; ++i, t += GROUPS) {
    const int buf = i % STAGES;
    const int ahead = t + (STAGES - 1) * GROUPS;  // into the stage of this group's last tile
    if (ahead < n_tiles) load_kv((i + STAGES - 1) % STAGES, ahead);
    tc::cp_async_commit();
    tc::cp_async_wait<STAGES - 1>();  // tile t has landed
    wg::fence_async_smem();
    tc::group_sync(1 + group, GROUP_THREADS);
    const bf16* tK = ring + (KR + 1) * buf * VTILE;
    const bf16* tV = ring + ((KR + 1) * buf + KR) * VTILE;
    const int kt = t * BK;
    const int kn = min(BK, k_end - kt);  // keys this tile needs
    if (kn > 48) {
      fwd_tile<HD, OW, 64>(st, dq, tK, tV, kt, col_in, lim_lo, lim_hi, Tk, scale);
    } else if (kn > 32) {
      fwd_tile<HD, OW, 48>(st, dq, tK, tV, kt, col_in, lim_lo, lim_hi, Tk, scale);
    } else if (kn > 16) {
      fwd_tile<HD, OW, 32>(st, dq, tK, tV, kt, col_in, lim_lo, lim_hi, Tk, scale);
    } else {
      fwd_tile<HD, OW, 16>(st, dq, tK, tV, kt, col_in, lim_lo, lim_hi, Tk, scale);
    }
    tc::group_sync(1 + group, GROUP_THREADS);  // the next tile refills this stage
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // every group is done with its ring and with Q

  // With two groups, group 1 hands its partial (row max, row sum, o
  // accumulator) to group 0 through shared memory, element-major so that
  // lanes hit distinct banks; group 0 merges them as the online softmax
  // merges two tiles: a group with no tile, or a row that saw only masked
  // keys in it, holds m = NEG and drops out with weight exp(NEG - m) = 0.
  if (GROUPS == 2) {
    float* xch = reinterpret_cast<float*>(sQ + TILE);  // [4 + OW / 2][GROUP_THREADS]
    if (group == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xch[h * GROUP_THREADS + gtid] = st.row_max[h];
        xch[(2 + h) * GROUP_THREADS + gtid] = st.row_sum[h];
      }
#pragma unroll
      for (int j = 0; j < OW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[(4 + j * 4 + e) * GROUP_THREADS + gtid] = st.acc[j][e];
    }
    __syncthreads();
    if (group == 0) {
      float a0[2], a1[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m1 = xch[h * GROUP_THREADS + gtid];
        const float m_new = fmaxf(st.row_max[h], m1);
        a0[h] = __expf(st.row_max[h] - m_new);
        a1[h] = __expf(m1 - m_new);
        st.row_sum[h] = st.row_sum[h] * a0[h] + xch[(2 + h) * GROUP_THREADS + gtid] * a1[h];
        st.row_max[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < OW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st.acc[j][e] = st.acc[j][e] * a0[e >> 1] +
                         xch[(4 + j * 4 + e) * GROUP_THREADS + gtid] * a1[e >> 1];
    }
  }

  if (group == 0) {
    // o = acc / s for the rows below rows_end, staged through sQ
    wg::stage_acc(sQ, st.acc, 1.f / st.row_sum[0], 1.f / st.row_sum[1]);
    if constexpr (OW == 128)
      wg::stage_acc<8>(sQ + TILE_ELEMS, st.acc, 1.f / st.row_sum[0], 1.f / st.row_sum[1]);
    if (writes_stats && (lane & 3) == 0) {
      if (row_lo < rows_end) {
        m_out[stat_base + row_lo] = st.row_max[0];
        s_out[stat_base + row_lo] = st.row_sum[0];
      }
      if (row_hi < rows_end) {
        m_out[stat_base + row_hi] = st.row_max[1];
        s_out[stat_base + row_hi] = st.row_sum[1];
      }
    }
  }
  __syncthreads();
  wg::store_tile<THREADS, OW, HD>(o + q_base + c0, sQ, q0, rows_end - q0);
}

template <int HD, int GROUPS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_len,
                   const void* m_len, void* o, void* m, void* s, int B, int H, int Tq, int Tk,
                   float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;  // above 48 KB needs an explicit opt-in
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(masked_attention_fwd_tc_kernel<HD, GROUPS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem_bytes<HD, GROUPS>());
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ, HD / slice_width<HD>());
  masked_attention_fwd_tc_kernel<HD, GROUPS>
      <<<grid, GROUPS * GROUP_THREADS, smem_bytes<HD, GROUPS>(), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const int*>(q_len), static_cast<const int*>(m_len), static_cast<bf16*>(o),
          static_cast<float*>(m), static_cast<float*>(s), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: contiguous bf16 [B, H, T, D], D = 64, 128, 256 or a multiple of
// 128 above (the wide kernel, masked_attention_wide_tc.cu; the wrapper pads
// other widths with zero columns to the next of those); q_len, m_len: int32 [B] or
// null; o like q; m, s: fp32 [B, H, Tq]. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int masked_attention_fwd_tc(const void* q, const void* k, const void* v,
                                       const void* q_len, const void* m_len, void* o, void* m,
                                       void* s, int B, int H, int Tq, int Tk, int D,
                                       float scale, int causal, void* stream) {
  if ((D != 64 && D != 128 && D != 256 && !wide::takes(D)) || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 ||
      (Tq + BQ - 1) / BQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide::takes(D)) {  // every multiple of 128 above 256
    return (int)wide::fwd_tc(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, D, scale, causal, st);
  }
  const bool two = Tk > TWO_GROUPS_MIN_TK;
  if (D == 256) {
    return (int)(two ? launch<256, 2>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, scale,
                                      causal, st)
                     : launch<256, 1>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, scale,
                                      causal, st));
  }
  if (D == 128) {
    return (int)(two ? launch<128, 2>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, scale,
                                      causal, st)
                     : launch<128, 1>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, scale,
                                      causal, st));
  }
  return (int)(two ? launch<64, 2>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, scale, causal,
                                   st)
                   : launch<64, 1>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, scale, causal,
                                   st));
}

// Dynamic shared memory a D = 64 block of two warp groups asks for, in
// bytes (a block of one group asks for 41,984; at D = 128 82,944 and
// 148,480; at D = 256 132,096 and 230,400).
extern "C" int masked_attention_fwd_tc_shared_bytes(void) { return (int)smem_bytes<64, 2>(); }
