// Masked multi-head attention, forward, fp32 inputs at D = 128, 256 and at
// every multiple of 128 above, on Hopper's tensor cores in 3xTF32, for
// sm_90a. Reached through the masked_attention_fwd C entry point
// (masked_attention_fwd.cu), which sends every D but 64 here
// (wide::fwd_f32); the backward kernels at those widths stay where they
// were (masked_attention_bwd*.cu, masked_attention_wide.cu).
//
// Replaces, for fp32 inputs at those widths, the forward Pallas kernels of
// vaenar_tts_tpu/ops/flash_attention.py: _fwd_kernel (l.104, pallas_call
// l.299) and _fwd_kernel_blocked (l.142, pallas_call l.224). The contract
// is masked_attention_fwd.cu's: NEG = -2^32+1 for a masked logit, a row
// with no key comes out as mean(v) with m = NEG and s = Tk, m and s (not
// the lse) written, the key loop stopped at m_len and at the causal edge,
// the padding rows written from one read of v's columns, the last q-block
// first.
//
// 3xTF32. Each fp32 operand x of both products is split into a TF32 big
// part, big = x with its 13 low bits cleared, and a TF32 small part, small
// = rna(x - big) (round to nearest, ties away, as cvt.rna.tf32.f32; x -
// big is exact in fp32). A product a.b is then a_small.b_big + a_big.b_small
// + a_big.b_big, three mma.sync.m16n8k8.tf32, small terms first; the dropped
// a_small.b_small and the small parts' rounding leave about 2^-20 of |a.b|
// per term, against 2^-10 for one TF32 product, which would not hold the
// fp32 path's tolerance (tests/test_torch_tf32_split.py emulates both). The
// tensor core truncates the low bits of the sum it accumulates, so a
// running sum fed through it over D / 8 steps drifts toward zero (D = 1024,
// logits of a few tens: 2.4e-4 in m, against TOL_M 1e-4): each 64-column
// panel's products go into a fresh accumulator, which fp32 adds to the
// running sum. The scale, the mask and the softmax stay fp32 after
// S = Q.K^T, as in the SIMT kernels; P is split like the other operands.
//
// What bounds it, and what this design does about it. Work: 4 D operations
// a (row, key) pair, three tensor-core products each: at a third of the
// 495 TFLOP/s dense TF32 rate 165 TFLOP/s, against 67 for fp32 FMAs on the
// SIMT units, which the kernels this one replaced reached about half of.
// Measured on an H100 (PERF.md §6, scripts/torch_fwd_3xtf32_ablation.py),
// a block issues its products at well under the tensor pipe's rate (at
// D = 128 and 256 about 6x the bound at 1024 x 4104): its 8
// warps (2 a scheduler) spend their issue slots on the split (3
// instructions an element: and, subtract, add), loads and copies as well,
// so the design keeps those few.
//   * a block of 64 query rows has 8 warps (two warp groups): warp w owns
//     rows 16 (w % 4) .. + 15 and, of every 64-key tile, keys 32 (w / 4) ..
//     + 31 of S; of every 64-column panel of o, columns 32 (w / 4) .. + 31;
//     one block a streaming multiprocessor, but two at D = 128, where the
//     ring has two stages (108,032 bytes a block) and ptxas is held to 128
//     registers a thread (blocks_an_sm): a block's chain of barriers and
//     dependent products then shares the SM with another's (a deeper ring
//     at one block an SM was slower at the model's sites, PERF.md §6);
//   * S is formed once a (q-block, key tile) for all of a slice's output
//     columns, and o for up to 512 columns stays in registers (W / 4
//     floats a thread): D = 128, 256, 384 and 512 run in one slice (S
//     formed once), wider heads in ceil(D / 512) slices;
//   * up to D = 512, Q stays in shared memory for the block's life (64 x
//     (D + 4) floats); wider, a slice streams Q's 64-column panels beside
//     K's;
//   * K's 64-column panels (S = Q.K^T, summed over D / 64 panels) and then
//     V's 64-column panels of the slice (O += P.V) stream through one
//     cp.async ring of four stages (three at D = 512), one barrier a step;
//     a thread's copy pointers are formed once and advanced a step;
//   * the two warps of a row group share row maxima through shared memory
//     once a tile, and P through a 64 x 64 tile that both read, with its
//     small part beside it, split once when written;
//   * a grid of few q-blocks and long rows of keys (1024 x 4104 at one
//     head: 20 q-blocks with keys, on 132 SMs) splits each q-block's key
//     tiles over a cluster of up to 4 blocks (wide::key_ranks), which merge
//     their (row max, row sum, o) through distributed shared memory; of
//     the one-head models' sites, the synthesis causal self-attention
//     (4 x 1680: 108 blocks of 27 key tiles) takes 2 ranks, the rest 1;
//     at D = 128 a wave is two blocks an SM, so that site (216 blocks at
//     two heads) takes 2 and 1024 x 4104 (128 blocks) 4.
// Fragments: Q, K and P by ldmatrix (m8n8.x4 of b16 pairs is 8 rows of 4
// fp32, the m16n8k8 TF32 A and B layouts), row strides of 68 floats
// (D + 4 for a resident Q), which put ldmatrix's 8 rows in 8 bank groups.
// P.V runs as O^T = V^T.P^T, V the A operand as 8-byte loads straight into
// the fragment's registers (row stride 72 keeps them on distinct banks).
// A tile with 32 keys or fewer skips the second warp of each row group in
// S, and P.V stops at the tile's last key (P is 0 past it and V's rows
// there are zeros). Registers and shared memory: PERF.md §6.

#include <cooperative_groups.h>
#include <stdint.h>

#include "attention_wide.cuh"
#include "tile_f32.cuh"

namespace {

namespace cg = cooperative_groups;
using f32::NEG;

constexpr int THREADS = 256;  // 8 warps: 4 row groups x 2 key (and column) halves
constexpr int BQ = 64;        // query rows of a block
constexpr int BK = 64;        // keys of a tile
constexpr int PANEL = 64;     // columns of a streamed panel of Q, K or V
// the ring: three panels load while one multiplies (two where Q resident
// at D = 512 leaves room for three stages only); at D = 128 one loads while
// one multiplies, which leaves room for two blocks an SM (BLOCKS_AN_SM)
template <int W, bool QRES>
__host__ __device__ constexpr int stages() { return W == 128 ? 2 : QRES && W == 512 ? 3 : 4; }
// blocks an SM: two at D = 128 (108,032 bytes of shared memory and at most
// 128 registers a thread each), else one; wide::key_ranks counts a wave as
// that many blocks on each SM
template <int W>
__host__ __device__ constexpr int blocks_an_sm() { return W == 128 ? 2 : 1; }
constexpr int LDK = PANEL + 4;  // row stride of a Q or K panel and of P (ldmatrix)
constexpr int LDV = PANEL + 8;  // row stride of a V panel (8-byte loads)
constexpr int PANEL_FLOATS = BK * LDV;
constexpr int MAX_RESIDENT_D = 512;  // widest Q held in shared memory; o columns a slice
constexpr int SUM_COLS = 64;         // columns of a padding-row sum pass
constexpr int MAX_RANKS = 4;         // blocks of a cluster, which split a q-block's key tiles
constexpr int MIN_TILES_A_RANK = 8;  // key tiles a rank keeps at least, when keys are split

// Shared memory of a block, in floats: [resident Q] [ring] [P, P's small
// part] [row maxima or sums of both halves] [each rank's row maxima and
// sums]; after the key loop, the partial o of each rank in this block's
// columns (below P)
template <int W, bool QRES>
__host__ __device__ constexpr int ring_floats() {
  return stages<W, QRES>() * (QRES ? 1 : 2) * PANEL_FLOATS;
}
template <int W, bool QRES>
__host__ constexpr size_t smem_bytes() {
  return sizeof(float) * ((QRES ? (size_t)BQ * (W + 4) : 0) + ring_floats<W, QRES>() +
                          2 * BQ * LDK + 2 * BQ + 2 * MAX_RANKS * BQ);
}

// x = big + small (+ at most 2^-21 |x|): big is x with its low 13 bits
// cleared (TF32 toward zero), small = x - big is exact in fp32, and small
// + 0x1000 on the bits is rna(small) once the tensor core drops its low 13
// bits, as it does for every TF32 operand
__device__ __forceinline__ uint32_t small_part(uint32_t x) {
  return __float_as_uint(__uint_as_float(x) - __uint_as_float(x & 0xffffe000u)) + 0x1000u;
}
__device__ __forceinline__ void split(uint32_t x, uint32_t& big, uint32_t& small) {
  big = x & 0xffffe000u;
  small = small_part(x);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(cpa::smem_addr(p)));
}

// c += a . b, m16n8k8, TF32 operands, fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[j] += a . b[j] for the warp's 4 n-tiles in 3xTF32: every small term,
// then every big.big one (each accumulator in the order small.big,
// big.small, big.big; neighbouring products independent). The tensor core
// adds a product to its accumulator with the sum's low bits truncated, so
// callers keep each accumulator to one panel (8 steps) and add it to their
// running sum in fp32.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4][4], const uint32_t (&a)[4],
                                           const uint32_t (&b)[4][2]) {
  uint32_t ab[4], as[4], bb[4][2], bs[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ab[i], as[i]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(b[j][0], bb[j][0], bs[j][0]);
    split(b[j][1], bb[j][1], bs[j][1]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(c[j], as, bb[j][0], bb[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(c[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(c[j], ab, bb[j][0], bb[j][1]);
}

// S (16 rows x 32 keys, the warp's) += Q (rows, 64 columns) . K (keys, the
// same columns)^T; `qp` at the warp's first row and the panel's first
// column (rows ldq floats apart), `kp` at the warp's first key
__device__ __forceinline__ void s_panel(float (&sacc)[4][4], const float* qp, int ldq,
                                        const float* kp, int lane) {
  float part[4][4] = {};
  // ldmatrix row addresses: A's four 8 x 4 matrices are (rows 0-7, 8-15) x
  // (columns 0-3, 4-7); B's are (keys 0-7: columns 0-3, 4-7), (keys 8-15: ...)
  const float* a_at = qp + ((lane & 7) + (lane & 8)) * ldq + (lane >> 4) * 4;
  const float* b_at = kp + ((lane & 7) + ((lane >> 4) << 3)) * LDK + (lane & 8) / 2;
#pragma unroll
  for (int kk = 0; kk < PANEL; kk += 8) {
    uint32_t a[4], b[4][2], r[4];
    ldsm_x4(a, a_at + kk);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      ldsm_x4(r, b_at + 16 * jp * LDK + kk);
      b[2 * jp][0] = r[0];
      b[2 * jp][1] = r[1];
      b[2 * jp + 1][0] = r[2];
      b[2 * jp + 1][1] = r[3];
    }
    mma_3xtf32(part, a, b);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] += part[j][e];
}

// O (16 rows x the warp's 32 columns of a V panel) += P (rows, keys
// [0, KEYS)) . V (keys, columns), formed as O^T = V^T . P^T: V is the A
// operand (two m-tiles of 16 columns), P the B operand (two n-tiles of 8
// rows), given split (`pb` its big part, P itself, at the warp's first
// row; `ps` its small part), so that only V splits here. m index n of an
// m-tile is its column 2 n (n < 8) or 2 (n - 8) + 1, so a thread's A
// fragment is two 8-byte loads of V's rows t and t + 4 (`vp` at the warp's
// first column), and its C elements are rows 8 nt + 2 t (+ 1) by columns
// 16 mt + 2 g (+ 1): oacc[mt][nt] = {(r, c), (r + 1, c), (r, c + 1),
// (r + 1, c + 1)}.
template <int KEYS>
__device__ __forceinline__ void pv_panel(float (&oacc)[2][2][4], const float* pb, const float* ps,
                                         const float* vp, int lane) {
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LDK + (lane & 8) / 2;
  const float* v_at = vp + (lane & 3) * LDV + 2 * (lane >> 2);
  float part[2][2][4] = {};
#pragma unroll
  for (int kk = 0; kk < KEYS; kk += 8) {
    uint32_t bb[4], bs[4], ab[2][4], as[2][4];
    ldsm_x4(bb, pb + b_off + kk);  // b0, b1 of n-tile 0, then of n-tile 1
    ldsm_x4(bs, ps + b_off + kk);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float2 lo = *reinterpret_cast<const float2*>(v_at + kk * LDV + 16 * mt);
      const float2 hi = *reinterpret_cast<const float2*>(v_at + (kk + 4) * LDV + 16 * mt);
      const uint32_t a[4] = {__float_as_uint(lo.x), __float_as_uint(lo.y), __float_as_uint(hi.x),
                             __float_as_uint(hi.y)};
#pragma unroll
      for (int i = 0; i < 4; ++i) split(a[i], ab[mt][i], as[mt][i]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_tf32(part[mt][nt], as[mt], bb[2 * nt], bb[2 * nt + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_tf32(part[mt][nt], ab[mt], bs[2 * nt], bs[2 * nt + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_tf32(part[mt][nt], ab[mt], bb[2 * nt], bb[2 * nt + 1]);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mt][nt][e] += part[mt][nt][e];
}

// Rows [row0, row0 + 64) of `cols` columns (a multiple of 4) of a matrix
// whose rows are `ld` floats apart into shared memory of row stride `lds`,
// as 16-byte asynchronous copies by the block; rows at or past `rows_end`
// become zeros (the resident Q, once a block).
__device__ __forceinline__ void load_rows(float* dst, int lds, const float* __restrict__ src,
                                          int ld, int cols, int row0, int rows_end, int tid) {
  const int chunks = cols / 4;
  for (int c = tid; c < BQ * chunks; c += THREADS) {
    const int r = c / chunks, col = (c - r * chunks) * 4;
    const bool in = row0 + r < rows_end;
    cpa::cp_async16(dst + r * lds + col, in ? src + (size_t)(row0 + r) * ld + col : src, in);
  }
}

// W: o columns a block (its slice); QRES: Q resident (D = W <= 512), else
// streamed beside K
template <int W, bool QRES>
__global__ void __launch_bounds__(THREADS, blocks_an_sm<W>())
fwd_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ q_len,
                  const int* __restrict__ m_len, float* __restrict__ o,
                  float* __restrict__ m_out, float* __restrict__ s_out, int H, int Tq, int Tk,
                  int D, float scale, int causal, int ranks) {
  constexpr int NP = W / PANEL;  // V panels (o register blocks) of a full slice
  constexpr int STAGES = stages<W, QRES>();
  extern __shared__ __align__(16) float smem[];
  const int ldq = QRES ? D + 4 : LDK;
  float* sQ = smem;                             // [64][D + 4] when resident
  float* ring = sQ + (QRES ? BQ * ldq : 0);     // [STAGES][K or V panel (, Q panel)]
  float* sP = ring + ring_floats<W, QRES>();    // [64][LDK]; the padding sums' scratch first
  float* sPs = sP + BQ * LDK;                   // [64][LDK]: P's small part
  float* sRow = sPs + BQ * LDK;                 // [2][64]: each half's row maxima, then sums
  float* sRank = sRow + 2 * BQ;                 // [ranks][2][64]: each rank's row max and sum

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wh = warp >> 2;  // row group (rows 16 wr ..), key / column half
  const int g = lane >> 2, t = lane & 3;    // the fragments' row (g, g + 8) and column index
  const int bh = blockIdx.x;                // b * H + h
  const int b = bh / H;
  // the last q-block first: when causal its chain of key tiles is the longest
  const int qb = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int q0 = qb * BQ;
  const int q_rows = min(BQ, Tq - q0);
  // blockIdx.z = slice * ranks + rank: the slice's ranks are one cluster,
  // rank r takes the q-block's key tiles r, r + ranks, ...
  const int rank = (int)blockIdx.z % ranks;
  const int c0 = ((int)blockIdx.z / ranks) * W;  // this slice's columns of o and v
  const int cols = min(W, D - c0);
  const bool writes_stats = (int)blockIdx.z < ranks;  // slice 0
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
  const int n_tiles = q0 < pad0 ? (k_end + BK - 1) / BK : 0;  // the q-block's
  const int my_tiles = n_tiles > rank ? (n_tiles - rank + ranks - 1) / ranks : 0;
  const int nk = D / PANEL, nv = cols / PANEL;  // K and V panels a tile
  const int per_tile = nk + nv;
  const int n_steps = my_tiles * per_tile;  // one ring step a panel

  auto stage_of = [&](int step) {
    return ring + (step % STAGES) * (QRES ? 1 : 2) * PANEL_FLOATS;
  };
  // The ring's steps load in order: this thread copies rows lr + 16 u
  // (u < 4), columns lc .. lc + 3 of each 64 x 64 panel, from pointers
  // formed once; (load_i, load_j) is the next step's (tile of this rank,
  // panel: K's nk, then V's nv)
  const int lr = tid >> 4, lc = (tid & 15) * 4;
  const size_t rows16 = (size_t)16 * D;  // 16 rows of q, k or v
  const float* k_at = k + k_base + (size_t)lr * D + lc;
  const float* v_at = v + k_base + (size_t)lr * D + c0 + lc;
  const float* q_at = q + q_base + (size_t)(q0 + lr) * D + lc;
  int load_i = 0, load_j = 0;
  auto load_next = [&](int step) {
    float* stage = stage_of(step) + lr * (load_j < nk ? LDK : LDV) + lc;
    const int key0 = (rank + load_i * ranks) * BK;
    const float* src =
        load_j < nk ? k_at + (size_t)key0 * D + load_j * PANEL
                    : v_at + (size_t)key0 * D + (load_j - nk) * PANEL;
    const int ld = load_j < nk ? LDK : LDV;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = key0 + lr + 16 * u < k_end;
      cpa::cp_async16(stage + 16 * u * ld, in ? src + u * rows16 : k, in);
    }
    if (!QRES && load_j < nk) {
      float* qstage = stage_of(step) + PANEL_FLOATS + lr * LDK + lc;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool in = q0 + lr + 16 * u < rows_end;
        cpa::cp_async16(qstage + 16 * u * LDK, in ? q_at + u * rows16 + load_j * PANEL : q, in);
      }
    }
    if (++load_j == per_tile) {
      load_j = 0;
      ++load_i;
    }
  };
  // Q (when resident) and the first STAGES - 1 steps, one commit group a step
  if (n_steps > 0) {
    if (QRES) load_rows(sQ, ldq, q + q_base, D, D, q0, rows_end, tid);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_steps) load_next(s);
      cpa::cp_async_commit();
    }
  }

  // The rows at or past pad0 of the (b, h, slice), in its columns, while
  // the copies above land: o = mean(v), and in slice 0 m = NEG, s = Tk.
  // masked_attention_fwd.cu's writer q-block and the q-blocks after it,
  // which hold padding rows only, take the 64-column passes in turn (a
  // pass reads v's column block once and writes every padding row)
  const int writer = min((pad0 + BQ - 1) / BQ, (int)gridDim.y - 1);
  if (pad0 < Tq && qb >= writer) {
    constexpr int TPR = SUM_COLS / 4;  // threads a row, 4 columns each
    const float n = (float)Tk;
    const int slot = (qb - writer) * ranks + rank, slots = ((int)gridDim.y - writer) * ranks;
    for (int c = SUM_COLS * slot; c < cols; c += SUM_COLS * slots) {
      wide::slice_sums<THREADS, SUM_COLS>(sP, sP + SUM_COLS, v + k_base + c0 + c, D, 0, Tk,
                                          nullptr);
      const int c4 = (tid % TPR) * 4;
      const float4 mean = make_float4(sP[c4] / n, sP[c4 + 1] / n, sP[c4 + 2] / n, sP[c4 + 3] / n);
      for (int r = pad0 + tid / TPR; r < Tq; r += THREADS / TPR)
        *reinterpret_cast<float4*>(o + q_base + (size_t)r * D + c0 + c + c4) = mean;
    }
    for (int r = pad0 + tid; writes_stats && slot == 0 && r < Tq; r += THREADS) {
      m_out[stat_base + r] = NEG;
      s_out[stat_base + r] = n;
    }
  }
  // (the same for every rank of the cluster, which must all reach its
  // barriers: a rank without a tile holds m = NEG, sum 0, o = 0)
  if (n_tiles == 0) return;

  const float scale2 = scale * f32::LOG2E;
  // rows 16 wr + g and + 8: running max (log2 units), this thread's share of
  // the row sum (its keys only, until the end); o in the warp's columns of
  // each panel, on rows 16 wr + 8 nt + 2 t (+ 1) (pv_panel's layout)
  float row_max[2] = {NEG, NEG}, row_sum[2] = {0.f, 0.f};
  float oacc[NP][2][2][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[p][mt][nt][e] = 0.f;

  int s = 0;  // the ring step about to run
  // step s's panels have landed and every warp is done with step s - 1,
  // whose stage then loads step s + STAGES - 1
  auto advance = [&]() {
    cpa::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < n_steps) load_next(s + STAGES - 1);
    cpa::cp_async_commit();
  };

  for (int i = 0; i < my_tiles; ++i) {
    const int kt = (rank + i * ranks) * BK;
    const int n_keys = min(BK, k_end - kt);

    // S = Q.K^T over the D / 64 panels, the warp's 16 rows x 32 keys
    float sacc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
    const bool has_keys = 32 * wh < n_keys;  // else every key of the warp is masked
    for (int j = 0; j < nk; ++j, ++s) {
      advance();
      if (has_keys) {
        const float* qp = QRES ? sQ + 16 * wr * ldq + j * PANEL
                               : stage_of(s) + PANEL_FLOATS + 16 * wr * LDK;
        s_panel(sacc, qp, ldq, stage_of(s) + 32 * wh * LDK, lane);
      }
    }

    // mask, scale, this half's row maxima (a quad holds a row's 32 keys)
    float tile_max[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + 16 * wr + g + 8 * (e >> 1);
        const int col = kt + 32 * wh + 8 * j + 2 * t + (e & 1);
        sacc[j][e] = col < k_end && (!causal || col <= row) ? sacc[j][e] * scale2 : NEG;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], sacc[j][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 1));
      tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 2));
      if (t == 0) sRow[wh * BQ + 16 * wr + g + 8 * i] = tile_max[i];
    }
    __syncthreads();  // both halves' maxima are in sRow
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float other = sRow[(1 - wh) * BQ + 16 * wr + g + 8 * i];
      const float m_new = fmaxf(row_max[i], fmaxf(tile_max[i], other));
      alpha[i] = exp2f(row_max[i] - m_new);
      row_max[i] = m_new;
    }
    // P to sP and its small part to sPs (read by both halves after the next
    // step's barrier)
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[j][e] = exp2f(sacc[j][e] - row_max[e >> 1]);
        part[e >> 1] += sacc[j][e];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int at = (16 * wr + g + 8 * i) * LDK + 32 * wh + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(sP + at) = make_float2(sacc[j][2 * i], sacc[j][2 * i + 1]);
        *reinterpret_cast<float2*>(sPs + at) =
            make_float2(__uint_as_float(small_part(__float_as_uint(sacc[j][2 * i]))),
                        __uint_as_float(small_part(__float_as_uint(sacc[j][2 * i + 1]))));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) row_sum[i] = row_sum[i] * alpha[i] + part[i];
    // o's rows 16 wr + 8 nt + 2 t + d take the alpha of the lanes whose g
    // is 2 t + d
    float alpha_o[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int d = 0; d < 2; ++d) alpha_o[nt][d] = __shfl_sync(0xffffffffu, alpha[nt], 8 * t + 4 * d);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) oacc[p][mt][nt][e] *= alpha_o[nt][e & 1];

    // O += P.V over the slice's V panels, the warp's 32 columns of each;
    // keys 32-63 only where the tile has them
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (p < nv) {
        advance();
        if (n_keys > 32)
          pv_panel<BK>(oacc[p], sP + 16 * wr * LDK, sPs + 16 * wr * LDK, stage_of(s) + 32 * wh,
                       lane);
        else
          pv_panel<BK / 2>(oacc[p], sP + 16 * wr * LDK, sPs + 16 * wr * LDK,
                           stage_of(s) + 32 * wh, lane);
        ++s;
      }
    }
  }
  cpa::cp_async_wait<0>();

  // this block's row sums over both halves (a quad, then the other half's
  // warp); every warp read its last maxima from sRow before the last tile's
  // V steps, each behind a barrier
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 1);
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 2);
    if (t == 0) sRow[wh * BQ + 16 * wr + g + 8 * i] = row_sum[i];
  }
  __syncthreads();

  if (ranks == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = 16 * wr + g + 8 * i, row = q0 + rl;
      if (writes_stats && wh == 0 && t == 0 && row < rows_end) {
        m_out[stat_base + row] = row_max[i] * f32::LN2;
        s_out[stat_base + row] = sRow[rl] + sRow[BQ + rl];
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int rl = 16 * wr + 8 * nt + 2 * t + d, row = q0 + rl;
        if (row >= rows_end) continue;  // past Tq, or a padding row written by the writer
        const float inv = 1.f / (sRow[rl] + sRow[BQ + rl]);
        float* orow = o + q_base + (size_t)row * D + c0 + 32 * wh + 2 * g;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          if (p >= nv) continue;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            *reinterpret_cast<float2*>(orow + PANEL * p + 16 * mt) =
                make_float2(oacc[p][mt][nt][d] * inv, oacc[p][mt][nt][2 + d] * inv);
        }
      }
    return;
  }

  // Ranks > 1: rank r owns columns [r own, (r + 1) own) of the slice. Every
  // rank sends its partial o there, and its row max and sum to every rank,
  // through distributed shared memory; the owner merges them as the online
  // softmax merges two tiles (a rank without a key of a row holds m = NEG
  // and drops out with weight exp2(NEG - m) = 0) in rank order, and writes
  // its columns of o (rank 0: m and s too).
  cg::cluster_group cluster = cg::this_cluster();
  const int own = cols / ranks;           // a multiple of 32
  float* xbuf = smem;                     // [ranks][64][own + 4], over Q and the ring
  cluster.sync();  // every rank is done with its Q, ring and P
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rl = 16 * wr + g + 8 * i;
    if (wh == 0 && t == 0) {
      const float sum = sRow[rl] + sRow[BQ + rl];
      for (int r = 0; r < ranks; ++r) {
        float* stat = cluster.map_shared_rank(sRank, r);
        stat[(2 * rank) * BQ + rl] = row_max[i];
        stat[(2 * rank + 1) * BQ + rl] = sum;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if (p >= nv) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int col = PANEL * p + 32 * wh + 16 * mt + 2 * g, owner = col / own;
      float* dst = cluster.map_shared_rank(xbuf, owner) + rank * BQ * (own + 4) + col - owner * own;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int d = 0; d < 2; ++d)
          *reinterpret_cast<float2*>(dst + (16 * wr + 8 * nt + 2 * t + d) * (own + 4)) =
              make_float2(oacc[p][mt][nt][d], oacc[p][mt][nt][2 + d]);
    }
  }
  cluster.sync();  // every rank's partials have landed
  const int chunks = own / 4;  // 16-byte chunks of a row
  for (int c = tid; c < BQ * chunks; c += THREADS) {
    const int rl = c / chunks, col = (c - rl * chunks) * 4, row = q0 + rl;
    if (row >= rows_end) continue;
    float m_all = NEG;
    for (int r = 0; r < ranks; ++r) m_all = fmaxf(m_all, sRank[2 * r * BQ + rl]);
    float sum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < ranks; ++r) {
      const float w = exp2f(sRank[2 * r * BQ + rl] - m_all);
      sum = fmaf(sRank[(2 * r + 1) * BQ + rl], w, sum);
      const float4 x = *reinterpret_cast<const float4*>(xbuf + (r * BQ + rl) * (own + 4) + col);
      acc = make_float4(fmaf(x.x, w, acc.x), fmaf(x.y, w, acc.y), fmaf(x.z, w, acc.z),
                        fmaf(x.w, w, acc.w));
    }
    const float inv = 1.f / sum;
    *reinterpret_cast<float4*>(o + q_base + (size_t)row * D + c0 + rank * own + col) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    if (writes_stats && rank == 0 && col == 0) {
      m_out[stat_base + row] = m_all * f32::LN2;
      s_out[stat_base + row] = sum;
    }
  }
}

template <int W, bool QRES>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_len,
                   const void* m_len, void* o, void* m, void* s, int B, int H, int Tq, int Tk,
                   int D, float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set && blocks_an_sm<W>() > 1) {  // two blocks an SM: the whole carveout as shared
    const cudaError_t err = cudaFuncSetAttribute(fwd_3xtf32_kernel<W, QRES>,
                                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  const size_t bytes = smem_bytes<W, QRES>();  // QRES: D = W
  const cudaError_t err = wide::opt_in(fwd_3xtf32_kernel<W, QRES>, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const int slices = (D + W - 1) / W, q_blocks = (Tq + BQ - 1) / BQ;
  const int ranks = wide::key_ranks(B * H * q_blocks * slices, (Tk + BK - 1) / BK, MAX_RANKS,
                                    MIN_TILES_A_RANK, blocks_an_sm<W>());
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * H, q_blocks, slices * ranks);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = ranks;
  config.attrs = cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, fwd_3xtf32_kernel<W, QRES>, static_cast<const float*>(q),
                            static_cast<const float*>(k), static_cast<const float*>(v),
                            static_cast<const int*>(q_len), static_cast<const int*>(m_len),
                            static_cast<float*>(o), static_cast<float*>(m),
                            static_cast<float*>(s), H, Tq, Tk, D, scale, causal, ranks);
}

}  // namespace

namespace wide {

cudaError_t fwd_f32(const void* q, const void* k, const void* v, const void* q_len,
                    const void* m_len, void* o, void* m, void* s, int B, int H, int Tq, int Tk,
                    int D, float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 128:
      return launch<128, true>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, D, scale, causal,
                               stream);
    case 256:
      return launch<256, true>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, D, scale, causal,
                               stream);
    case 384:
      return launch<384, true>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, D, scale, causal,
                               stream);
    case MAX_RESIDENT_D:
      return launch<MAX_RESIDENT_D, true>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, D, scale,
                                          causal, stream);
    default:  // slices of 512 columns (the last one narrower), Q streamed
      return launch<MAX_RESIDENT_D, false>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, D, scale,
                                           causal, stream);
  }
}

}  // namespace wide
