// Masked multi-head attention, backward, the dQ kernel, bf16 on Hopper's
// tensor cores (wgmma), for sm_90a. Plain C interface, bound from Python
// with ctypes (vaenar_tts_torch/ops/flash_attention.py,
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
// What bounds it on an H100 at the training path's bf16 shapes (batch 32,
// H=4, D=64, text 32, reduced mel 240 at r = 2, of which 54-144 rows are
// valid): by chip_smoke.py's count (q, dO and O of the valid rows, the K
// and V rows they see, dQ written whole in bf16 and delta whole in fp32;
// an unmasked (row, key) pair costs 6*D operations) bytes, 0.092 ms a step
// over 36 launches; the kernel takes several times that, because a launch
// lasts as long as its heaviest block's chain of dependent steps
// (scripts/torch_attention_blocks.py times every block): the lengths, the
// loads of Q, dO and the first K/V tile, delta, then per key tile two
// rounds of products with the exponentials between them, then the store.
//
// Design for that chain (masked_attention_bwd_dkv_tc.cu turned around). A
// block of one warp group (4 warps, 128 threads) owns 64 query rows of one
// (b, h), with its 64 x 64 fp32 dQ accumulator in registers (wgmma's D
// fragment: each warp 16 rows). Q and dO stay in shared memory; K and V
// stream through a two-stage ring of 64-key tiles, the next tile loading
// while the current one multiplies. All tiles land in wgmma's
// 128-byte-swizzled layout straight from cp.async (16 bytes a thread), so
// no copy or ldmatrix sits between a load and a product. Per key tile,
// wgmma.mma_async over the warp group (m64nNk16, bf16 in, fp32 accumulate):
//   S   = Q . K^T    (Q and K from shared memory, both K-major)
//   dP  = dO . V^T   (the same, with dO and V)
//   dQ += dS . K     (dS from registers, K an MN-major B)
// P and dS are formed in fp32 registers from S and dP with the row's
// m log2(e), 1/s and delta; the D fragment of the first two products is
// the A fragment of the last.
//   * The last key tile is narrowed to the keys it needs (at m_len, or at
//     the q-tile's last valid row when causal), rounded up to 16: N of the
//     first two products and the k-steps of the last are 16, 32, 48 or 64
//     keys, each width its own instantiation, so that the 32-key encoder
//     and cross sites multiply 32 keys, not 64.
//   * Fewer instructions on the chain: each row's mask is one bound, and a
//     warp whose rows see the whole tile skips it; P is one fma and ex2.
//   * delta is formed while key tile 0 is in flight: two threads a row,
//     each reading 32 columns of O from device memory (16 bytes a load, the
//     rows with a key only) and of dO from the shared tile; the warp's
//     lanes pass the sums to the lanes whose rows they are by shuffles. It
//     is written once, before any product needs it.
//   * The dK/dV kernel is its programmatic dependent: the first instruction
//     lets that grid start while this one runs.
// One warp group a block: at the training sites Tk <= 240, so a block runs
// 1-4 key tiles; two groups split the forward's key tiles to its gain only
// at Tk > 512 (PERF.md §6), and 64 rows and 127 registers a block keep the
// causal 240 site's 512 blocks on the SMs at once (four a SM). Measured
// and rejected on an H100 (PERF.md §6): forming delta while key tile 0's
// first products run (157 registers: three blocks a SM, later starts),
// the same capped at 128 registers (spills), and dQ stored from registers
// in 4-byte pieces (slower wherever many blocks write at once).
//
// dS's precision: the plain version keeps it fp32. Here dS is split into a
// bf16 high and low part, and dQ += dS . K is two products (about 16 bits
// kept, relative error <= 2^-17): rounded once to bf16, P and dS failed
// chip_smoke.py's bf16 tolerance, 1e-3 + 2^-7 |g| (unchanged), at every
// checked shape of the dK/dV kernel (PERF.md §6).
//
// Work skipped without changing the result (as masked_attention_bwd.cu):
//   * the key loop stops at m_len and, when causal, at the tile's last row
//     with a key: every skipped term is exp(NEG - m) = 0 exactly in fp32;
//   * K and V rows past that end are not read (their tile rows are zeros);
//   * a block whose rows all lack a key reads nothing: it writes its zero dQ
//     rows with 16-byte stores and its zero delta with 4-byte stores, one
//     float a thread, coalesced (a block's delta need not start at a 16-byte
//     boundary).
//
// Resources: the dQ accumulator (32 floats), a tile's S and dP (up to 64)
// and dS's hi and lo fragments (up to 32) a thread; ptxas -v gives 127
// registers, no spills (chip_smoke.py and scripts/torch_attention_sites.py
// print it). Shared memory: Q, dO and a two-stage K/V ring, 6 tiles of
// 64 x 64 bf16, and 1 KB for alignment: 50,176 bytes a block.

// Head widths. A template of the head width, compiled for D = 64 (the
// design above) and D = 128; the C entry point runs the one its D names.
// At D = 128 each tile is two 64-column swizzled panels: S and dP run 4
// k-steps on each, dQ += dS . K is two products of N = 64 into the two
// halves of a 64 x 128 accumulator, and delta takes two threads a row of
// 64 columns each. Shared memory 99,328 bytes a block; registers in
// PERF.md §6.
//
// D = 256 (slices of 128 columns). A 64 x 256 fp32 dQ accumulator (128
// floats a thread) beside S, dP and dS's fragments would pass ptxas's cap
// of 255 registers, so the grid gains an axis over two column slices of
// dQ: each block forms S and dP over all four 64-column panels of its
// tiles (16 k-steps each) and dQ += dS . K over the two panels of K in its
// slice, which keeps D = 128's accumulator and fragments. S, dP and delta
// are formed by both slices, twice in all; slice 0 writes delta. Q, dO and
// the two-stage K/V ring stay whole at the full width: 197,632 bytes a
// block.

#include "attention_wide.cuh"
#include "wgmma_bf16.cuh"

namespace {

using tc::bf16;
using wg::PANEL_DESC;
using wg::TILE_ELEMS;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int THREADS = 128;
constexpr int STAGES = 2;  // K/V tiles in the ring: one loads while one multiplies
constexpr float LOG2E = 1.4426950408889634f;
template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(bf16) * (2 + 2 * STAGES) * wg::tile_elems<HD>() + wg::ALIGN;
}

// This thread's two rows (g and g + 8 of its warp's 16): the unmasked keys
// [0, lim), m log2(e), 1/s and delta.
struct RowStats {
  int lim[2];
  float m_log2[2], inv_s[2], delta[2];
};

using wg::slice_width;

// One key tile of NK keys (16, 32, 48 or 64) starting at key kt: S and dP
// over the HD / 64 panels of the tiles, then P and dS, then dQ += dS_hi . K
// + dS_lo . K over the OW / 64 panels of K from `slice` descriptor units
// in. P = 2^(S * scale_log2 - m log2(e)) / s with scale_log2 = scale *
// log2(e).
template <int HD, int OW, int NK>
__device__ __forceinline__ void dq_tile(float (&acc)[OW / 8][4], uint64_t dq_desc,
                                        uint64_t ddo_desc,
                                        const bf16* tK, const bf16* tV, const RowStats& rs,
                                        int kt, int col_in, float scale_log2, uint64_t slice) {
  constexpr int J = NK / 8;
  float sc[J][4], dp[J][4];
  wg::zero(sc);
  wg::zero(dp);
  wg::fence_acc(sc);
  wg::fence_acc(dp);
  wg::fence();
  const uint64_t dk = wg::desc(tK), dv = wg::desc(tV);
#pragma unroll
  for (int p = 0; p < HD / 64; ++p)  // the head width's panels, 4 k-steps each
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t at = p * PANEL_DESC + 2 * kk;
      wg::mma_ss<NK>(sc, dq_desc + at, dk + at);
      wg::mma_ss<NK>(dp, ddo_desc + at, dv + at);
    }
  wg::commit();
  wg::wait<0>();
  wg::fence_acc(sc);
  wg::fence_acc(dp);

  // dS into dp, in fp32. A masked key of a row with a key has P =
  // exp(NEG - m) = 0 exactly and dS = 0; rows without a key (lim 0) take
  // no part. Column kt + col_in + c of the tile (c constant) is tested
  // against each row's bound; a warp whose rows see every key of the tile
  // skips the test.
  auto ds = [&](int j, int e) {
    const int h = e >> 1;
    const float p = wg::ex2(fmaf(sc[j][e], scale_log2, -rs.m_log2[h])) * rs.inv_s[h];
    dp[j][e] = p * (dp[j][e] - rs.delta[h]);
  };
  if (__all_sync(0xffffffffu, kt + NK <= min(rs.lim[0], rs.lim[1]))) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds(j, e);
  } else {
    const int base = kt + col_in;
    const int bound[2] = {rs.lim[0] - base, rs.lim[1] - base};
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j * 8 + (e & 1) < bound[e >> 1]) {
          ds(j, e);
        } else {
          dp[j][e] = 0.f;
        }
      }
  }

  // dQ += dS . K as hi and lo parts: dS from registers, K an MN-major B
  // (one product of N = 64 for each panel), k-step s = keys 16 s .. 16 s + 15
  uint32_t ds_hi[NK / 16][4], ds_lo[NK / 16][4];
#pragma unroll
  for (int s = 0; s < NK / 16; ++s) wg::a_split(ds_hi[s], ds_lo[s], dp, s);
  wg::fence_acc(acc);
  wg::fence();
#pragma unroll
  for (int s = 0; s < NK / 16; ++s) {
    wg::mma_rs64_mn(acc, ds_hi[s], dk + slice + 128 * s);
    wg::mma_rs64_mn(acc, ds_lo[s], dk + slice + 128 * s);
    if constexpr (OW == 128) {
      wg::mma_rs64_mn<8>(acc, ds_hi[s], dk + slice + PANEL_DESC + 128 * s);
      wg::mma_rs64_mn<8>(acc, ds_lo[s], dk + slice + PANEL_DESC + 128 * s);
    }
  }
  wg::commit();
  wg::wait<0>();
  wg::fence_acc(acc);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
masked_attention_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                  const bf16* __restrict__ o, const int* __restrict__ q_len,
                                  const int* __restrict__ m_len, const float* __restrict__ m_in,
                                  const float* __restrict__ s_in, float* __restrict__ delta_out,
                                  bf16* __restrict__ dq, int H, int Tq, int Tk, float scale,
                                  int causal) {
  // The dK/dV kernel, launched next on the same stream as a programmatic
  // dependent launch, may start now: it loads what this kernel does not
  // write while this one runs, and waits for this whole grid before it
  // reads delta.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  constexpr int TILE = wg::tile_elems<HD>();
  constexpr int OW = slice_width<HD>(), SLICES = HD / OW;
  // 16-byte chunks of a row in the block's slice
  constexpr int CHUNKS = OW / 8, SHIFT = cpa::log2i(CHUNKS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(wg::aligned_smem(smem_raw));  // [64][HD] swizzled
  bf16* sDO = sQ + TILE;                                            // [64][HD]
  bf16* sK = sDO + TILE;          // [STAGES][64][HD], the key-tile ring
  bf16* sV = sK + STAGES * TILE;  // [STAGES][64][HD]

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
  // this block's columns of dQ, [c0, c0 + OW), K's panels from `slice`
  // descriptor units in; slice 0 writes delta
  const int c0 = SLICES > 1 ? (int)blockIdx.z * OW : 0;
  const uint64_t slice = (uint64_t)(c0 / 64) * PANEL_DESC;
  const bool writes_delta = SLICES == 1 || blockIdx.z == 0;

  if (rows_end <= q0) {  // no row of the block has a key
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int chunk = tid; chunk < q_rows * CHUNKS; chunk += THREADS)
      *reinterpret_cast<uint4*>(dq + q_base + (size_t)(q0 + (chunk >> SHIFT)) * HD + c0 +
                                (chunk & (CHUNKS - 1)) * 8) = zero;
    for (int r = tid; writes_delta && r < q_rows; r += THREADS) {
      delta_out[stat_base + q0 + r] = 0.f;
    }
    return;
  }
  // keys at or past k_end are masked for every row of the block
  const int k_end = causal ? min(mlen, rows_end) : mlen;
  const int n_tiles = (k_end + BK - 1) / BK;

  // commit groups: Q and dO, then key tiles 0 .. STAGES - 2, then one per
  // key tile in the loop
  wg::load_tile_async<THREADS, HD>(sQ, q + q_base, q0, rows_end, tid);
  wg::load_tile_async<THREADS, HD>(sDO, dout + q_base, q0, rows_end, tid);
  tc::cp_async_commit();
  auto load_kv = [&](int stage, int t) {
    wg::load_tile_async<THREADS, HD>(sK + stage * TILE, k + k_base, t * BK, k_end, tid);
    wg::load_tile_async<THREADS, HD>(sV + stage * TILE, v + k_base, t * BK, k_end, tid);
  };
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n_tiles) load_kv(p, p);
    tc::cp_async_commit();
  }

  // delta: thread tid sums columns [HD / 2 h, HD / 2 (h + 1)) of row r of
  // dO * O, HD / 16 chunks of 16 bytes
  constexpr int D_CHUNKS = HD / 16;
  const int d_row = tid >> 1, d_half = tid & 1;
  uint4 o_raw[D_CHUNKS];
  const bool d_in = q0 + d_row < rows_end;
#pragma unroll
  for (int i = 0; i < D_CHUNKS; ++i)
    o_raw[i] = d_in ? *reinterpret_cast<const uint4*>(o + q_base + (size_t)(q0 + d_row) * HD +
                                                      d_half * (HD / 2) + i * 8)
                    : make_uint4(0u, 0u, 0u, 0u);
  // this lane's two rows: their unmasked keys, m log2(e) and 1/s
  RowStats rs;
  const int row_lo = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    const bool in = row < rows_end;
    rs.lim[h] = in ? (causal ? min(mlen, row + 1) : mlen) : 0;
    rs.m_log2[h] = in ? m_in[stat_base + row] * LOG2E : 0.f;
    rs.inv_s[h] = in ? 1.f / s_in[stat_base + row] : 0.f;
  }

  tc::cp_async_wait<STAGES - 1>();  // Q and dO have landed
  wg::fence_async_smem();
  __syncthreads();
  float dsum = 0.f;
#pragma unroll
  for (int i = 0; i < D_CHUNKS; ++i) {
    const uint4 g_raw =
        *reinterpret_cast<const uint4*>(sDO + wg::swz(d_row, d_half * D_CHUNKS + i));
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
  if (writes_delta && d_half == 0 && d_row < q_rows) delta_out[stat_base + q0 + d_row] = dsum;
  // row warp * 16 + j sits in lanes 2 j and 2 j + 1 of its own warp
  rs.delta[0] = __shfl_sync(0xffffffffu, dsum, 2 * (lane >> 2));
  rs.delta[1] = __shfl_sync(0xffffffffu, dsum, 2 * (lane >> 2) + 16);

  const int col_in = (lane & 3) * 2;
  const float scale_log2 = scale * LOG2E;
  const uint64_t dq_desc = wg::desc(sQ), ddo_desc = wg::desc(sDO);
  float acc[OW / 8][4];
  wg::zero(acc);

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % STAGES;
    const int kt = t * BK;
    const int ahead = t + STAGES - 1;  // into the stage that tile t - 1 used
    if (ahead < n_tiles) load_kv(ahead % STAGES, ahead);
    tc::cp_async_commit();
    tc::cp_async_wait<STAGES - 1>();  // key tile t has landed
    wg::fence_async_smem();
    __syncthreads();
    const bf16* tK = sK + buf * TILE;
    const bf16* tV = sV + buf * TILE;
    const int kn = min(BK, k_end - kt);  // keys this tile needs
    if (kn > 48) {
      dq_tile<HD, OW, 64>(acc, dq_desc, ddo_desc, tK, tV, rs, kt, col_in, scale_log2,
                             slice);
    } else if (kn > 32) {
      dq_tile<HD, OW, 48>(acc, dq_desc, ddo_desc, tK, tV, rs, kt, col_in, scale_log2,
                             slice);
    } else if (kn > 16) {
      dq_tile<HD, OW, 32>(acc, dq_desc, ddo_desc, tK, tV, rs, kt, col_in, scale_log2,
                             slice);
    } else {
      dq_tile<HD, OW, 16>(acc, dq_desc, ddo_desc, tK, tV, rs, kt, col_in, scale_log2,
                             slice);
    }
    __syncthreads();  // the next iteration refills the stage of this tile
  }
  tc::cp_async_wait<0>();

  // dQ * scale, staged through the Q tile (the loop's last barrier follows
  // every product that read it); rows without a key are zeros
  wg::stage_acc(sQ, acc, scale, scale);
  if constexpr (OW == 128) wg::stage_acc<8>(sQ + TILE_ELEMS, acc, scale, scale);
  __syncthreads();
  wg::store_tile<THREADS, OW, HD>(dq + q_base + c0, sQ, q0, q_rows);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* o, const void* q_len, const void* m_len, const void* m,
                   const void* s, void* delta, void* dq, int B, int H, int Tq, int Tk,
                   float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;  // above 48 KB needs an explicit opt-in, per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(masked_attention_bwd_dq_tc_kernel<HD>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem_bytes<HD>());
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ, HD / slice_width<HD>());
  masked_attention_bwd_dq_tc_kernel<HD><<<grid, THREADS, smem_bytes<HD>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(o),
      static_cast<const int*>(q_len), static_cast<const int*>(m_len),
      static_cast<const float*>(m), static_cast<const float*>(s), static_cast<float*>(delta),
      static_cast<bf16*>(dq), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, dout, o: contiguous bf16 [B, H, Tq, D]; k, v: bf16 [B, H, Tk, D], D =
// 64, 128, 256 or a multiple of 128 above (the wide kernel,
// masked_attention_wide_tc.cu); q_len, m_len: int32 [B] or null; m, s: fp32 [B, H, Tq] (the
// forward's row max and row sum); delta: fp32 [B, H, Tq], written
// (rowsum(dO * O) on rows with a key, else 0); dq like q. Returns the CUDA
// error code of the launch.
extern "C" int masked_attention_bwd_dq_tc(const void* q, const void* k, const void* v,
                                          const void* dout, const void* o, const void* q_len,
                                          const void* m_len, const void* m, const void* s,
                                          void* delta, void* dq, int B, int H, int Tq, int Tk,
                                          int D, float scale, int causal, void* stream) {
  if ((D != 64 && D != 128 && D != 256 && !wide::takes(D)) || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 ||
      (Tq + BQ - 1) / BQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide::takes(D)) {  // every multiple of 128 above 256
    return (int)wide::dq_tc(q, k, v, dout, o, q_len, m_len, m, s, delta, dq, B, H, Tq, Tk, D, scale, causal, st);
  }
  if (D == 256) {
    return (int)launch<256>(q, k, v, dout, o, q_len, m_len, m, s, delta, dq, B, H, Tq, Tk, scale,
                            causal, st);
  }
  return (int)(D == 128 ? launch<128>(q, k, v, dout, o, q_len, m_len, m, s, delta, dq, B, H, Tq,
                                      Tk, scale, causal, st)
                        : launch<64>(q, k, v, dout, o, q_len, m_len, m, s, delta, dq, B, H, Tq,
                                     Tk, scale, causal, st));
}

// Dynamic shared memory each D = 64 block asks for, in bytes (a D = 128
// block 99,328, a D = 256 block 197,632).
extern "C" int masked_attention_bwd_dq_tc_shared_bytes(void) { return (int)smem_bytes<64>(); }
