// Masked multi-head attention, backward, the dQ kernel, bf16 on the tensor
// cores, for sm_90a. Plain C interface, bound from Python with ctypes
// (vaenar_tts_torch/ops/flash_attention.py,
// masked_flash_attention_backward); bf16 inputs take this kernel, fp32 ones
// masked_attention_bwd.cu's dQ kernel. It also forms delta = rowsum(dO * O),
// which the dK/dV kernel (masked_attention_bwd_dkv_tc.cu), launched after it
// on the same stream, reads.
//
// Replaces _dq_kernel of vaenar_tts_tpu/ops/flash_attention.py (l.320,
// pallas_call l.442) for bf16 inputs, and the delta that _pallas_backward
// forms outside its kernels (l.425-427).
//
// Contract (masked_attention_bwd.cu's): logits = q.k^T * scale; mask =
// row < q_len[b] && col < m_len[b] (&& col <= row when causal); from the
// forward's row stats (max m, sum s),
//   delta = rowsum(dO * O) in fp32 on every row with an unmasked key, 0 on
//           the others (their dS is 0, so no gradient reads their delta)
//   P     = exp(where(mask, logits, NEG) - m) / s
//   dS    = where(mask, P * (dO.V^T - delta), 0)
//   dQ    = dS . K * scale, accumulated in fp32 and rounded once to bf16
// A row with no unmasked key (row >= q_len, or every row when m_len == 0)
// has dQ = 0. Null length pointers mean full lengths.
//
// Design (masked_attention_bwd_dkv_tc.cu turned around). A block of 4 warps
// owns 64 query rows of one (b, h); each warp owns 16 of them, with its
// 16 x 64 fp32 dQ accumulator in registers. The block loads its Q and dO
// tiles once by cp.async (16 bytes a thread) and each warp keeps its Q and
// dO A fragments in registers for the whole key loop. K and V stream
// through a two-stage ring of 64-key tiles filled with cp.async, the next
// tile loading while the current one multiplies. Per key tile and warp, on
// the tensor cores (mma.sync.m16n8k16, bf16 in, fp32 accumulate):
//   S  = Q . K^T    (K B fragments by ldmatrix)
//   dP = dO . V^T   (V B fragments by ldmatrix)
//   dQ += dS . K    (dS from registers, K by ldmatrix.trans)
// with P and dS formed in fp32 registers from the row's m, 1/s and delta.
// dS is split into a bf16 high and low part, so the last product is two mma
// (about 16 bits kept, relative error <= 2^-17): rounded once to bf16, P and
// dS failed chip_smoke.py's bf16 tolerance, 1e-3 + 2^-7 |g| (unchanged), at
// every checked shape of the dK/dV kernel (PERF.md §6).
//
// delta is formed at the start of the block, while key tile 0 is in flight:
// two threads a row, each reading 32 columns of O from device memory (16
// bytes a load, the rows with a key only) and of dO from the shared tile;
// the warp's lanes pass the sums to the lanes whose rows they are by
// shuffles. It is written once, before any product needs it.
//
// Work skipped without changing the result (as masked_attention_bwd.cu):
//   * the key loop stops at m_len and, when causal, at the tile's last row
//     with a key: every skipped term is exp(NEG - m) = 0 exactly in fp32;
//   * K and V rows past that end are not read (their tile rows are zeros);
//   * a block whose rows all lack a key reads nothing: it writes its zero dQ
//     rows with 16-byte stores and its zero delta with 4-byte stores, one
//     float a thread, coalesced (a block's delta need not start at a 16-byte
//     boundary).
// One warp group a block: at the training sites Tk <= 240, so a block runs
// 1-4 key tiles, and the forward's two-groups split paid only at Tk > 512
// (PERF.md §6).
//
// What bounds it on an H100 at the training path's bf16 shapes (batch 32,
// H=4, D=64, text 32, reduced mel 240 at r = 2, of which 54-144 rows are
// valid): bytes, by chip_smoke.py's count (q, dO and O of the valid rows,
// the K and V rows they see, dQ written whole in bf16 and delta whole in
// fp32); an unmasked (row, key) pair costs 6*D operations on the tensor
// cores. The design reads each input row once, keeps every intermediate in
// registers, and writes each dQ row once, 16 bytes a thread, staged through
// shared memory; what remains is a block's chain of 1-4 dependent key tiles,
// each two rounds of products with the exp between them (PERF.md §6).
//
// Registers: the Q and dO A fragments (32), the dQ accumulator (32) and a
// tile's S and dP (64) per thread; ptxas (CUDA 12.8) gives 162, no spills,
// so three blocks fit on an SM.
// Shared memory: Q, dO, and a two-stage K/V ring, 6 tiles of 64 x 72 bf16:
// 55,296 bytes a block.

#include "mma_bf16.cuh"

namespace {

using tc::bf16;
using tc::HD;
using tc::LDS;
using tc::TILE_ELEMS;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int THREADS = 128;
constexpr int STAGES = 2;  // K/V tiles in the ring: one loads while one multiplies
constexpr size_t SMEM_BYTES = sizeof(bf16) * (2 + 2 * STAGES) * TILE_ELEMS;

__global__ void __launch_bounds__(THREADS)
masked_attention_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                  const bf16* __restrict__ o, const int* __restrict__ q_len,
                                  const int* __restrict__ m_len, const float* __restrict__ m_in,
                                  const float* __restrict__ s_in, float* __restrict__ delta_out,
                                  bf16* __restrict__ dq, int H, int Tq, int Tk, float scale,
                                  int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [64][LDS], this block's rows
  bf16* sDO = sQ + TILE_ELEMS;                   // [64][LDS]
  bf16* sK = sDO + TILE_ELEMS;                   // [STAGES][64][LDS], the key-tile ring
  bf16* sV = sK + STAGES * TILE_ELEMS;           // [STAGES][64][LDS]

  // The dK/dV kernel, launched next on the same stream as a programmatic
  // dependent launch, may start now: it loads what this kernel does not
  // write while this one runs, and waits for this whole grid before it
  // reads delta.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
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
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int chunk = tid; chunk < q_rows * 8; chunk += THREADS)
      *reinterpret_cast<uint4*>(dq + q_base + (size_t)(q0 + (chunk >> 3)) * HD +
                                (chunk & 7) * 8) = zero;
    for (int r = tid; r < q_rows; r += THREADS) delta_out[stat_base + q0 + r] = 0.f;
    return;
  }
  // keys at or past k_end are masked for every row of the block
  const int k_end = causal ? min(mlen, rows_end) : mlen;
  const int n_tiles = (k_end + BK - 1) / BK;

  // commit groups: Q and dO, then key tiles 0 .. STAGES - 2, then one per
  // key tile in the loop
  tc::load_tile_async<THREADS>(sQ, q + q_base, q0, rows_end, tid);
  tc::load_tile_async<THREADS>(sDO, dout + q_base, q0, rows_end, tid);
  tc::cp_async_commit();
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n_tiles) {
      tc::load_tile_async<THREADS>(sK + p * TILE_ELEMS, k + k_base, p * BK, k_end, tid);
      tc::load_tile_async<THREADS>(sV + p * TILE_ELEMS, v + k_base, p * BK, k_end, tid);
    }
    tc::cp_async_commit();
  }

  // delta: thread tid sums columns [32 h, 32 h + 32) of row r of dO * O
  const int d_row = tid >> 1, d_half = tid & 1;
  uint4 o_raw[4];
  const bool d_in = q0 + d_row < rows_end;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o_raw[i] = d_in ? *reinterpret_cast<const uint4*>(o + q_base + (size_t)(q0 + d_row) * HD +
                                                      d_half * 32 + i * 8)
                    : make_uint4(0u, 0u, 0u, 0u);
  // this lane's two rows (g and g + 8 of the warp's 16): m and 1/s
  const int row_lo = q0 + warp * 16 + (lane >> 2), row_hi = row_lo + 8;
  const float m_lo = row_lo < rows_end ? m_in[stat_base + row_lo] : 0.f;
  const float m_hi = row_hi < rows_end ? m_in[stat_base + row_hi] : 0.f;
  const float inv_s_lo = row_lo < rows_end ? 1.f / s_in[stat_base + row_lo] : 0.f;
  const float inv_s_hi = row_hi < rows_end ? 1.f / s_in[stat_base + row_hi] : 0.f;

  tc::cp_async_wait<STAGES - 1>();  // Q and dO have landed
  __syncthreads();
  float dsum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 g_raw =
        *reinterpret_cast<const uint4*>(sDO + d_row * LDS + d_half * 32 + i * 8);
    const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&g_raw);
    const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&o_raw[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 gf = __bfloat1622float2(gh[j]), of = __bfloat1622float2(oh[j]);
      dsum = fmaf(gf.x, of.x, dsum);
      dsum = fmaf(gf.y, of.y, dsum);
    }
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  // rows without a key read zeros (dO tile rows and o_raw): their delta is 0
  if (d_half == 0 && d_row < q_rows) delta_out[stat_base + q0 + d_row] = dsum;
  // row warp * 16 + j sits in lanes 2 j and 2 j + 1 of its own warp
  const float delta_lo = __shfl_sync(0xffffffffu, dsum, 2 * (lane >> 2));
  const float delta_hi = __shfl_sync(0xffffffffu, dsum, 2 * (lane >> 2) + 16);

  // this warp's Q and dO A fragments, 16 rows x 64 head-width columns
  uint32_t qa[4][4], oa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int a_off = (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8;
    tc::ldmatrix_x4(qa[kk], sQ + a_off);
    tc::ldmatrix_x4(oa[kk], sDO + a_off);
  }

  const int col_in = (lane & 3) * 2;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % STAGES;
    const int kt = t * BK;
    const int ahead = t + STAGES - 1;  // into the stage that tile t - 1 used
    if (ahead < n_tiles) {
      tc::load_tile_async<THREADS>(sK + (ahead % STAGES) * TILE_ELEMS, k + k_base, ahead * BK,
                                   k_end, tid);
      tc::load_tile_async<THREADS>(sV + (ahead % STAGES) * TILE_ELEMS, v + k_base, ahead * BK,
                                   k_end, tid);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<STAGES - 1>();  // key tile t has landed
    __syncthreads();
    const bf16* tK = sK + buf * TILE_ELEMS;
    const bf16* tV = sV + buf * TILE_ELEMS;

    // S = Q . K^T and dP = dO . V^T: 16 rows x 64 keys a warp
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk * 16 +
                          ((lane >> 3) & 1) * 8;
        uint32_t kb[4], vb[4];
        tc::ldmatrix_x4(kb, tK + b_off);
        tc::ldmatrix_x4(vb, tV + b_off);
        tc::mma(sc[2 * np], qa[kk], kb[0], kb[1]);
        tc::mma(sc[2 * np + 1], qa[kk], kb[2], kb[3]);
        tc::mma(dp[2 * np], oa[kk], vb[0], vb[1]);
        tc::mma(dp[2 * np + 1], oa[kk], vb[2], vb[3]);
      }
    }

    // dS into dp, in fp32
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const int row = hi ? row_hi : row_lo;
        const int key = kt + j * 8 + col_in + (e & 1);
        // a masked key of a row with a key has P = exp(NEG - m) = 0 exactly
        // and dS = 0; rows without a key take no part
        const bool unmasked = row < rows_end && key < mlen && (!causal || key <= row);
        float ds = 0.f;
        if (unmasked) {
          const float p = __expf(sc[j][e] * scale - (hi ? m_hi : m_lo)) *
                          (hi ? inv_s_hi : inv_s_lo);
          ds = p * (dp[j][e] - (hi ? delta_hi : delta_lo));
        }
        dp[j][e] = ds;
      }
    }

    // dQ += dS . K as hi and lo parts: dS from registers, K through
    // ldmatrix.trans
#pragma unroll
    for (int s = 0; s < 4; ++s) {  // keys 16 s .. 16 s + 15 of the tile
      uint32_t ds_hi[4], ds_lo[4];
      tc::a_split_from_acc(ds_hi, ds_lo, dp, s);
#pragma unroll
      for (int dc = 0; dc < 4; ++dc) {  // head-width columns 16 dc .. 16 dc + 15
        const int off = (s * 16 + (lane & 15)) * LDS + dc * 16 + (lane >> 4) * 8;
        uint32_t kb[4];
        tc::ldmatrix_x4_trans(kb, tK + off);
        tc::mma(acc[2 * dc], ds_hi, kb[0], kb[1]);
        tc::mma(acc[2 * dc + 1], ds_hi, kb[2], kb[3]);
        tc::mma(acc[2 * dc], ds_lo, kb[0], kb[1]);
        tc::mma(acc[2 * dc + 1], ds_lo, kb[2], kb[3]);
      }
    }
    __syncthreads();  // the next iteration refills the stage of this tile
  }
  tc::cp_async_wait<0>();

  // dQ * scale, staged through the Q tile (every warp read its fragments
  // before the loop's first barrier); rows without a key are zeros
  tc::stage_acc(sQ, acc, warp * 16, scale, scale);
  __syncthreads();
  tc::store_tile<THREADS>(dq + q_base, sQ, q0, q_rows);
}

}  // namespace

// q, dout, o: contiguous bf16 [B, H, Tq, 64]; k, v: bf16 [B, H, Tk, 64];
// q_len, m_len: int32 [B] or null; m, s: fp32 [B, H, Tq] (the forward's row
// max and row sum); delta: fp32 [B, H, Tq], written (rowsum(dO * O) on rows
// with a key, else 0); dq like q. Returns the CUDA error code of the launch.
extern "C" int masked_attention_bwd_dq_tc(const void* q, const void* k, const void* v,
                                          const void* dout, const void* o, const void* q_len,
                                          const void* m_len, const void* m, const void* s,
                                          void* delta, void* dq, int B, int H, int Tq, int Tk,
                                          int D, float scale, int causal, void* stream) {
  if (D != HD || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || (Tq + BQ - 1) / BQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  static bool smem_set = false;  // above 48 KB needs an explicit opt-in
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_attention_bwd_dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  masked_attention_bwd_dq_tc_kernel<<<grid, THREADS, SMEM_BYTES,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(o),
      static_cast<const int*>(q_len), static_cast<const int*>(m_len),
      static_cast<const float*>(m), static_cast<const float*>(s), static_cast<float*>(delta),
      static_cast<bf16*>(dq), H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

// Dynamic shared memory each block asks for, in bytes.
extern "C" int masked_attention_bwd_dq_tc_shared_bytes(void) { return (int)SMEM_BYTES; }
