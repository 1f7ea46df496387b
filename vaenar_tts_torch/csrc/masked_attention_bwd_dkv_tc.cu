// Masked multi-head attention, backward, the dK/dV kernel, bf16 on the
// tensor cores, for sm_90a. Plain C interface, bound from Python with
// ctypes (vaenar_tts_torch/ops/flash_attention.py,
// masked_flash_attention_backward); bf16 inputs take this kernel, fp32 ones
// masked_attention_bwd.cu's dK/dV kernel. At bf16 the dQ kernel,
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
// Design. A block of 4 warps owns 64 keys of one (b, h); each warp owns 16
// of them, with fp32 accumulators for its 16 rows of dK and dV in
// registers. K and V stay in shared memory; Q and dO stream through a
// two-stage ring of 64-row tiles filled with cp.async (16 bytes a thread),
// the next tile loading while the current one multiplies (a third stage
// measured no faster). Per q-tile and
// warp, on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32 accumulate):
//   S^T  = K . Q^T    (K A fragments by ldmatrix, Q B fragments by ldmatrix)
//   dP^T = V . dO^T   (the same, with V and dO)
//   dV  += P^T . dO   (P^T from registers, dO by ldmatrix.trans)
//   dK  += dS^T . Q   (dS^T from registers, Q by ldmatrix.trans)
// P^T and dS^T are formed in fp32 registers from S^T and dP^T with the q-tile's
// m, 1/s and delta, which sit in shared memory.
//
// P's and dS's precision: the plain version keeps them fp32. Here P^T and
// dS^T are each split into a bf16 high and low part, and each of the last two
// products is two mma (about 16 bits kept, relative error <= 2^-17). Rounded
// once to bf16 they exceeded chip_smoke.py's bf16 tolerance,
// 1e-3 + 2^-7 |g| (unchanged), at every checked shape; with the split, the
// measured worst share of that tolerance is in PERF.md §6.
//
// Work skipped without changing the result (as masked_attention_bwd.cu):
//   * a row with nothing unmasked (row >= q_len, or every row when
//     m_len == 0) has m = NEG and s = Tk, so P = 1/s on all Tk keys and
//     dS = 0: it adds dO_row / s_row to every dV row and nothing to dK. The
//     block sums those rows' dO / s once (one pass over dO, fp32) and starts
//     its dV accumulators from that sum;
//   * the q-tile loop covers only the rows with an unmasked key, stops at
//     q_len, skips key blocks at or past m_len and, when causal, starts at
//     the key block's first row: every skipped term is exp(NEG - m) = 0.
//
// What bounds it on an H100 at the training path's bf16 shapes (batch 32,
// H=4, D=64, text 32, reduced mel 240 at r = 2, of which 54-144 rows are
// valid): bytes. An unmasked (row, key) pair costs 8*D operations, 4.3
// GFLOP a train step at r = 2 (4.4 us at 989 TFLOP/s), while the rows read
// and the gradients written whole (zero rows included) come to ~20 MB in
// bf16 (6 us at 3.35 TB/s). The design reads each Q/dO tile once per key
// block through the ring, keeps every intermediate in registers, and writes
// each gradient row once, 16 bytes a thread, staged through shared memory.
//
// Shared memory: K, V and a two-stage Q/dO ring, 6 tiles of 64 x 72 bf16,
// and two stages of the q-tile's m, 1/s, delta: 56,832 bytes a block.

#include "mma_bf16.cuh"

namespace {

using tc::bf16;
using tc::HD;
using tc::LDS;
using tc::NEG;
using tc::TILE_ELEMS;

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per block
constexpr int THREADS = 128;
constexpr int STAGES = 2;  // Q/dO tiles in the ring: one loads while one multiplies
constexpr size_t SMEM_BYTES =
    sizeof(bf16) * (2 + 2 * STAGES) * TILE_ELEMS + sizeof(float) * STAGES * 3 * BQ;

__global__ void __launch_bounds__(THREADS)
masked_attention_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                   const int* __restrict__ q_len, const int* __restrict__ m_len,
                                   const float* __restrict__ m_in,
                                   const float* __restrict__ s_in,
                                   const float* __restrict__ delta_in, bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int H, int Tq, int Tk, float scale,
                                   int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [64][LDS], this block's keys
  bf16* sV = sK + TILE_ELEMS;                    // [64][LDS]
  bf16* sQ = sV + TILE_ELEMS;                    // [STAGES][64][LDS], the q-tile ring
  bf16* sDO = sQ + STAGES * TILE_ELEMS;          // [STAGES][64][LDS]
  float* sStat = reinterpret_cast<float*>(sDO + STAGES * TILE_ELEMS);  // [STAGES][3][BQ]:
                                                                        // m, 1/s, delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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

  // Rows in [valid_end, Tq) are uniform over the Tk keys: each adds
  // dO_row / s_row to every dV row. Summed once, in fp32, from one pass over
  // those rows of dO; every dV accumulator starts from the sum.
  float* usum = reinterpret_cast<float*>(smem_raw);  // [HD], then scratch
  tc::column_sums<THREADS>(usum, usum + HD, dout + q_base, valid_end, Tq, s_in + stat_base);
  const int col_in = (lane & 3) * 2;
  float acc_dk[8][4], acc_dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_dk[j][e] = 0.f;
      acc_dv[j][e] = usum[j * 8 + col_in + (e & 1)];
    }
  __syncthreads();  // shared memory is reused below

  // Rows below valid_end see no key of this block when the block starts at
  // or past m_len; when causal, rows before the block's first key see none.
  const int r_begin = causal ? k0 : 0;
  const int r_end = k0 < mlen ? valid_end : 0;
  const int n_tiles = r_begin < r_end ? (r_end - r_begin + BQ - 1) / BQ : 0;

  // one commit group per q-tile: K and V with the first, then STAGES - 2
  // more ahead
  if (n_tiles > 0) {
    tc::load_tile_async<THREADS>(sK, k + k_base, k0, Tk, tid);
    tc::load_tile_async<THREADS>(sV, v + k_base, k0, Tk, tid);
  }
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n_tiles) {
      tc::load_tile_async<THREADS>(sQ + p * TILE_ELEMS, q + q_base, r_begin + p * BQ, r_end, tid);
      tc::load_tile_async<THREADS>(sDO + p * TILE_ELEMS, dout + q_base, r_begin + p * BQ, r_end,
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
  if (n_tiles > 0) fetch_stats(r_begin);

  // this lane's two keys (g and g + 8 of the warp's 16)
  const int key_lo = k0 + warp * 16 + (lane >> 2), key_hi = key_lo + 8;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % STAGES;
    const int qt = r_begin + t * BQ;
    const int ahead = t + STAGES - 1;  // into the stage that tile t - 1 used
    if (ahead < n_tiles) {
      const int row0 = r_begin + ahead * BQ;
      tc::load_tile_async<THREADS>(sQ + (ahead % STAGES) * TILE_ELEMS, q + q_base, row0, r_end,
                                   tid);
      tc::load_tile_async<THREADS>(sDO + (ahead % STAGES) * TILE_ELEMS, dout + q_base, row0,
                                   r_end, tid);
    }
    tc::cp_async_commit();
    float* stat = sStat + buf * 3 * BQ;
    if (tid < BQ) {
      stat[tid] = next_stat[0];
      stat[BQ + tid] = 1.f / next_stat[1];
      stat[2 * BQ + tid] = next_stat[2];
    }
    if (t + 1 < n_tiles) fetch_stats(qt + BQ);
    tc::cp_async_wait<STAGES - 1>();  // q-tile t (and K, V) have landed
    __syncthreads();
    const bf16* tQ = sQ + buf * TILE_ELEMS;
    const bf16* tDO = sDO + buf * TILE_ELEMS;

    // S^T = K . Q^T and dP^T = V . dO^T: 16 keys x 64 rows a warp
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ka[4], va[4];
      const int a_off = (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8;
      tc::ldmatrix_x4(ka, sK + a_off);
      tc::ldmatrix_x4(va, sV + a_off);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk * 16 +
                          ((lane >> 3) & 1) * 8;
        uint32_t qb[4], ob[4];
        tc::ldmatrix_x4(qb, tQ + b_off);
        tc::ldmatrix_x4(ob, tDO + b_off);
        tc::mma(st[2 * np], ka, qb[0], qb[1]);
        tc::mma(st[2 * np + 1], ka, qb[2], qb[3]);
        tc::mma(dpt[2 * np], va, ob[0], ob[1]);
        tc::mma(dpt[2 * np + 1], va, ob[2], ob[3]);
      }
    }

    // P^T into st, dS^T into dpt, in fp32
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? key_lo : key_hi;
        const int rl = j * 8 + col_in + (e & 1);
        const int row = qt + rl;
        // rows at or past r_end and keys past Tk take no part; a masked key
        // of a valid row has P = exp(NEG - m) = 0 exactly and dS = 0
        const bool unmasked = row < r_end && key < mlen && (!causal || key <= row);
        float p = 0.f, ds = 0.f;
        if (unmasked) {
          p = __expf(st[j][e] * scale - stat[rl]) * stat[BQ + rl];
          ds = p * (dpt[j][e] - stat[2 * BQ + rl]);
        }
        st[j][e] = p;
        dpt[j][e] = ds;
      }
    }

    // dV += P^T . dO and dK += dS^T . Q, each as hi and lo parts: the A
    // operands from registers, dO and Q through ldmatrix.trans
#pragma unroll
    for (int s = 0; s < 4; ++s) {  // rows 16 s .. 16 s + 15 of the q-tile
      uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
      tc::a_split_from_acc(p_hi, p_lo, st, s);
      tc::a_split_from_acc(ds_hi, ds_lo, dpt, s);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {  // head-width columns 16 dp .. 16 dp + 15
        const int off = (s * 16 + (lane & 15)) * LDS + dp * 16 + (lane >> 4) * 8;
        uint32_t ob[4], qb[4];
        tc::ldmatrix_x4_trans(ob, tDO + off);
        tc::ldmatrix_x4_trans(qb, tQ + off);
        tc::mma(acc_dv[2 * dp], p_hi, ob[0], ob[1]);
        tc::mma(acc_dv[2 * dp + 1], p_hi, ob[2], ob[3]);
        tc::mma(acc_dv[2 * dp], p_lo, ob[0], ob[1]);
        tc::mma(acc_dv[2 * dp + 1], p_lo, ob[2], ob[3]);
        tc::mma(acc_dk[2 * dp], ds_hi, qb[0], qb[1]);
        tc::mma(acc_dk[2 * dp + 1], ds_hi, qb[2], qb[3]);
        tc::mma(acc_dk[2 * dp], ds_lo, qb[0], qb[1]);
        tc::mma(acc_dk[2 * dp + 1], ds_lo, qb[2], qb[3]);
      }
    }
    __syncthreads();  // the next iteration refills the stage of this tile
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // dK * scale and dV, staged through the first stage of the ring
  tc::stage_acc(sQ, acc_dk, warp * 16, scale, scale);
  tc::stage_acc(sDO, acc_dv, warp * 16, 1.f, 1.f);
  __syncthreads();
  tc::store_tile<THREADS>(dk + k_base, sQ, k0, k_rows);
  tc::store_tile<THREADS>(dv + k_base, sDO, k0, k_rows);
}

}  // namespace

// q, dout: contiguous bf16 [B, H, Tq, 64]; k, v: bf16 [B, H, Tk, 64]; q_len,
// m_len: int32 [B] or null; m, s, delta: fp32 [B, H, Tq] (the forward's row
// max and row sum, and rowsum(dO * O)); dk, dv like k. Returns the CUDA
// error code of the launch.
extern "C" int masked_attention_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                           const void* dout, const void* q_len,
                                           const void* m_len, const void* m, const void* s,
                                           const void* delta, void* dk, void* dv, int B,
                                           int H, int Tq, int Tk, int D, float scale,
                                           int causal, void* stream) {
  if (D != HD || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || (Tk + BK - 1) / BK > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  static bool smem_set = false;  // above 48 KB needs an explicit opt-in
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_attention_bwd_dkv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid(B * H, (Tk + BK - 1) / BK);
  masked_attention_bwd_dkv_tc_kernel<<<grid, THREADS, SMEM_BYTES,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const int*>(q_len),
      static_cast<const int*>(m_len), static_cast<const float*>(m),
      static_cast<const float*>(s), static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

// Dynamic shared memory each block asks for, in bytes.
extern "C" int masked_attention_bwd_dkv_tc_shared_bytes(void) { return (int)SMEM_BYTES; }
