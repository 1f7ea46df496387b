// Masked multi-head attention, forward, bf16 on the tensor cores, for
// sm_90a. Plain C interface, bound from Python with ctypes
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
// Design. A block takes one (b, h) and 64 query rows with a group of 4
// warps, each warp owning 16 of the rows; when Tk > 512 it takes two such
// groups, which split the key tiles (even and odd) so that a block's chain
// of tiles is half as long, and at the end group 1 hands its (row max, row
// sum, accumulator) to group 0 through shared memory, which merges them as
// the online softmax merges two tiles. Q is loaded once into registers as mma A
// fragments (one ldmatrix.x4 per 16 head-width columns). Each group streams
// its K and V tiles (64 keys) through its own two-stage shared-memory ring
// filled with cp.async (16 bytes a thread), the next tile loading while the
// current one multiplies, and waits on its own named barrier (a third stage
// measured no faster: the tile's products and softmax, not its load, set
// the pace). S = Q.K^T (K read with ldmatrix) and O += P.V (V read with
// ldmatrix.trans) are mma.sync.m16n8k16 bf16 products with fp32
// accumulators; P never leaves registers (the C fragment of S is the A
// fragment of P.V). The online softmax runs in fp32 registers; the row max
// and row sum of a row are reduced over the 4 lanes (a quad) that hold it.
// o is staged through shared memory for 16-byte stores.
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
//   * rows at or past q_len (all rows when m_len == 0) are fully masked; one
//     block of the (b, h) writes mean(v), NEG and Tk for all of them from one
//     pass over V (masked_attention_fwd.cu makes that pass in every block
//     that holds such rows);
//   * the key loop stops at m_len and, when causal, at the tile's last
//     valid row: each skipped term is exp(NEG - m) = 0 exactly in fp32.
//
// What bounds it on an H100 at the synthesis path's bf16 shapes (B=4, H=4,
// D=64, text 160, reduced mel 1680): bytes. A causal 1680 x 1680 site needs
// about 4*D*Tq*Tk/2*B*H = 5.8 GFLOP, 5.9 us at the 989 TFLOP/s bf16 tensor
// peak, against ~14 MB of q, k, v and o in bf16, 4.2 us at 3.35 TB/s, with
// the valid lengths cutting both; the cross and encoder sites are byte-bound
// by more. The design keeps every byte single-read from device memory per
// block (Q once; each K/V tile once; o written once) and hides the loads
// behind the products with the cp.async ring; the per-(b,h) K/V re-reads of
// the 27 q-tiles of a site hit the 50 MB L2. At these lengths a block's
// chain of dependent tiles (products, then the softmax's reductions, then
// products), not bytes or operations, sets the time; hence the two groups.
//
// Resources (ptxas -v; chip_smoke.py prints them): see
// PERF.md §6. Shared memory: Q and a two-stage K/V ring for each group, 5
// or 9 tiles of 64 x 72 bf16 = 46,080 or 82,944 bytes a block.

#include "mma_bf16.cuh"

namespace {

using tc::bf16;
using tc::HD;
using tc::LDS;
using tc::NEG;
using tc::TILE_ELEMS;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int GROUP_THREADS = 128;  // a warp group: 4 warps, 16 query rows each
constexpr int STAGES = 2;  // K/V tiles in a group's ring: one loads while one multiplies
// Keys above which a block takes two warp groups: measured on an H100, two
// groups shorten the long sites (Tk 1680 and 4104) and slow the short ones
// (Tk <= 240: a second group mostly idles and the bigger block fits fewer
// times on an SM)
constexpr int TWO_GROUPS_MIN_TK = 512;

template <int GROUPS>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (1 + GROUPS * 2 * STAGES) * TILE_ELEMS;
}

template <int GROUPS>
__global__ void __launch_bounds__(GROUPS * GROUP_THREADS)
masked_attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const int* __restrict__ q_len,
                               const int* __restrict__ m_len, bf16* __restrict__ o,
                               float* __restrict__ m_out, float* __restrict__ s_out, int H,
                               int Tq, int Tk, float scale, int causal) {
  constexpr int THREADS = GROUPS * GROUP_THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [64][LDS]; stages o at the end

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int q0 = blockIdx.y * BQ;
  const int q_rows = min(BQ, Tq - q0);
  const int qlen = q_len ? q_len[b] : Tq;
  const int mlen = m_len ? m_len[b] : Tk;
  const size_t q_base = (size_t)bh * Tq * HD;
  const size_t k_base = (size_t)bh * Tk * HD;
  const size_t stat_base = (size_t)bh * Tq;

  // Rows at or past pad0 (q_len; every row when m_len <= 0) are fully
  // masked: uniform attention over the Tk keys, o = mean(v), m = NEG,
  // s = Tk. One block of the (b, h) writes all of them, 16 bytes a thread,
  // from one pass over V in fp32: the first block whose tile starts at or
  // past pad0, else the last block.
  const int pad0 = mlen > 0 ? max(0, min(qlen, Tq)) : 0;
  const int writer = min((pad0 + BQ - 1) / BQ, (int)gridDim.y - 1);
  if (pad0 < Tq && (int)blockIdx.y == writer) {
    float* sum = reinterpret_cast<float*>(smem_raw);  // [HD], then scratch
    tc::column_sums<THREADS>(sum, sum + HD, v + k_base, 0, Tk, nullptr);
    const int c8 = (tid & 7) * 8;
    uint4 mean;
    __nv_bfloat162* mean2 = reinterpret_cast<__nv_bfloat162*>(&mean);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mean2[i] = __floats2bfloat162_rn(sum[c8 + 2 * i] / (float)Tk, sum[c8 + 2 * i + 1] / (float)Tk);
    for (int r = pad0 + (tid >> 3); r < Tq; r += THREADS / 8) {
      *reinterpret_cast<uint4*>(o + q_base + (size_t)r * HD + c8) = mean;
    }
    for (int r = pad0 + tid; r < Tq; r += THREADS) {
      m_out[stat_base + r] = NEG;
      s_out[stat_base + r] = (float)Tk;
    }
    __syncthreads();  // shared memory is reused below
  }
  if (q0 >= pad0) return;  // no valid row in this tile

  // Valid rows see no key at or past m_len, nor past the diagonal when
  // causal: those terms are exp(NEG - m) = 0 exactly, so the loop stops there.
  const int rows_end = min(q0 + q_rows, pad0);
  int k_end = min(Tk, mlen);
  if (causal) k_end = min(k_end, rows_end);
  const int n_tiles = (k_end + BK - 1) / BK;

  // Q, loaded by every thread; then each group's first STAGES - 1 tiles, one
  // commit group a tile
  const int group = tid / GROUP_THREADS, gtid = tid % GROUP_THREADS, gwarp = warp % 4;
  bf16* sK = sQ + TILE_ELEMS + group * 2 * STAGES * TILE_ELEMS;  // [STAGES][64][LDS]
  bf16* sV = sK + STAGES * TILE_ELEMS;                            // [STAGES][64][LDS]
  tc::load_tile_async<THREADS>(sQ, q + q_base, q0, q0 + q_rows, tid);
  tc::cp_async_commit();
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    const int t = group + p * GROUPS;
    if (t < n_tiles) {
      tc::load_tile_async<GROUP_THREADS>(sK + p * TILE_ELEMS, k + k_base, t * BK, Tk, gtid);
      tc::load_tile_async<GROUP_THREADS>(sV + p * TILE_ELEMS, v + k_base, t * BK, Tk, gtid);
    }
    tc::cp_async_commit();
  }
  tc::cp_async_wait<STAGES - 1>();  // this thread's part of Q has landed
  __syncthreads();
  uint32_t qf[4][4];  // Q's A fragments, one per 16 head-width columns
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::ldmatrix_x4(qf[kk], sQ + (gwarp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);

  // this lane's two rows (g and g + 8 of the warp's 16) and column pair
  const int row_lo = q0 + gwarp * 16 + (lane >> 2), row_hi = row_lo + 8;
  const int col_in = (lane & 3) * 2;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float row_max[2] = {NEG, NEG}, row_sum[2] = {0.f, 0.f};

  // this group's key tiles: group, group + GROUPS, ...
  for (int i = 0, t = group; t < n_tiles; ++i, t += GROUPS) {
    const int buf = i % STAGES;
    const int ahead = t + (STAGES - 1) * GROUPS;  // into the stage of this group's last tile
    if (ahead < n_tiles) {
      const int stage = (i + STAGES - 1) % STAGES;
      tc::load_tile_async<GROUP_THREADS>(sK + stage * TILE_ELEMS, k + k_base, ahead * BK, Tk, gtid);
      tc::load_tile_async<GROUP_THREADS>(sV + stage * TILE_ELEMS, v + k_base, ahead * BK, Tk, gtid);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<STAGES - 1>();  // tile t has landed
    tc::group_sync(1 + group, GROUP_THREADS);
    const bf16* tK = sK + buf * TILE_ELEMS;
    const bf16* tV = sV + buf * TILE_ELEMS;

    // S = Q . K^T: 16 rows x 64 keys a warp, 8 tiles of 16 x 8
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];  // B fragments of key tiles 2np and 2np+1
        tc::ldmatrix_x4(bfr, tK + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk * 16 +
                                 ((lane >> 3) & 1) * 8);
        tc::mma(sc[2 * np], qf[kk], bfr[0], bfr[1]);
        tc::mma(sc[2 * np + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // mask, online softmax in fp32
    const int kt = t * BK;
    float tile_max[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_lo : row_hi;
        const int col = kt + j * 8 + col_in + (e & 1);
        float x;
        if (col >= Tk) {
          x = -INFINITY;  // past the keys: no term at all
        } else if (row < qlen && col < mlen && (!causal || col <= row)) {
          x = sc[j][e] * scale;
        } else {
          x = NEG;
        }
        sc[j][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float alpha[2], part[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 1));
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 2));
      const float m_new = fmaxf(row_max[h], tile_max[h]);
      alpha[h] = __expf(row_max[h] - m_new);
      row_max[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = __expf(sc[j][e] - row_max[e >> 1]);
        part[e >> 1] += sc[j][e];
        acc[j][e] *= alpha[e >> 1];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
      row_sum[h] = row_sum[h] * alpha[h] + part[h];
    }

    // O += P_hi . V + P_lo . V: P from registers, V through ldmatrix.trans
#pragma unroll
    for (int s = 0; s < 4; ++s) {  // keys 16 s .. 16 s + 15
      uint32_t p_hi[4], p_lo[4];
      tc::a_split_from_acc(p_hi, p_lo, sc, s);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {  // head-width columns 16 dp .. 16 dp + 15
        uint32_t bfr[4];
        tc::ldmatrix_x4_trans(bfr, tV + (s * 16 + (lane & 15)) * LDS + dp * 16 + (lane >> 4) * 8);
        tc::mma(acc[2 * dp], p_hi, bfr[0], bfr[1]);
        tc::mma(acc[2 * dp + 1], p_hi, bfr[2], bfr[3]);
        tc::mma(acc[2 * dp], p_lo, bfr[0], bfr[1]);
        tc::mma(acc[2 * dp + 1], p_lo, bfr[2], bfr[3]);
      }
    }
    tc::group_sync(1 + group, GROUP_THREADS);  // the next tile refills this stage
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // every group is done with its ring

  // With two groups, group 1 hands its partial (row max, row sum, o
  // accumulator) to group 0 through shared memory, element-major so that
  // lanes hit distinct banks; group 0 merges them as the online softmax
  // merges two tiles: a group with no tile, or a row that saw only masked
  // keys in it, holds m = NEG and drops out with weight exp(NEG - m) = 0.
  if (GROUPS == 2) {
    float* xch = reinterpret_cast<float*>(sQ + TILE_ELEMS);  // [36][GROUP_THREADS]
    if (group == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xch[h * GROUP_THREADS + gtid] = row_max[h];
        xch[(2 + h) * GROUP_THREADS + gtid] = row_sum[h];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[(4 + j * 4 + e) * GROUP_THREADS + gtid] = acc[j][e];
    }
    __syncthreads();
    if (group == 0) {
      float a0[2], a1[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m1 = xch[h * GROUP_THREADS + gtid];
        const float m_new = fmaxf(row_max[h], m1);
        a0[h] = __expf(row_max[h] - m_new);
        a1[h] = __expf(m1 - m_new);
        row_sum[h] = row_sum[h] * a0[h] + xch[(2 + h) * GROUP_THREADS + gtid] * a1[h];
        row_max[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = acc[j][e] * a0[e >> 1] +
                      xch[(4 + j * 4 + e) * GROUP_THREADS + gtid] * a1[e >> 1];
    }
  }

  if (group == 0) {
    // o = acc / s for the rows below rows_end, staged through sQ (Q is in
    // registers)
    tc::stage_acc(sQ, acc, gwarp * 16, 1.f / row_sum[0], 1.f / row_sum[1]);
    if ((lane & 3) == 0) {
      if (row_lo < rows_end) {
        m_out[stat_base + row_lo] = row_max[0];
        s_out[stat_base + row_lo] = row_sum[0];
      }
      if (row_hi < rows_end) {
        m_out[stat_base + row_hi] = row_max[1];
        s_out[stat_base + row_hi] = row_sum[1];
      }
    }
  }
  __syncthreads();
  tc::store_tile<THREADS>(o + q_base, sQ, q0, rows_end - q0);
}

template <int GROUPS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_len,
                   const void* m_len, void* o, void* m, void* s, int B, int H, int Tq, int Tk,
                   float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;  // above 48 KB needs an explicit opt-in
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(masked_attention_fwd_tc_kernel<GROUPS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem_bytes<GROUPS>());
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  masked_attention_fwd_tc_kernel<GROUPS>
      <<<grid, GROUPS * GROUP_THREADS, smem_bytes<GROUPS>(), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const int*>(q_len), static_cast<const int*>(m_len), static_cast<bf16*>(o),
          static_cast<float*>(m), static_cast<float*>(s), H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: contiguous bf16 [B, H, T, 64]; q_len, m_len: int32 [B] or null;
// o like q; m, s: fp32 [B, H, Tq]. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int masked_attention_fwd_tc(const void* q, const void* k, const void* v,
                                       const void* q_len, const void* m_len, void* o, void* m,
                                       void* s, int B, int H, int Tq, int Tk, int D,
                                       float scale, int causal, void* stream) {
  if (D != HD || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || (Tq + BQ - 1) / BQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(Tk > TWO_GROUPS_MIN_TK
                   ? launch<2>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, scale, causal, st)
                   : launch<1>(q, k, v, q_len, m_len, o, m, s, B, H, Tq, Tk, scale, causal, st));
}

// Dynamic shared memory a block of two warp groups asks for, in bytes (a
// block of one group asks for 46,080).
extern "C" int masked_attention_fwd_tc_shared_bytes(void) { return (int)smem_bytes<2>(); }
