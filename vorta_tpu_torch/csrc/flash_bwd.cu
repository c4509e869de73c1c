// Block-sparse flash attention backward for Hopper (sm_90a): dq and dk/dv.
//
// Replaces vorta_tpu/ops/flash_bwd.py:_dq_kernel and :_dkv_kernel (reached
// through flash_backward).  Same function, over head-shared block tables:
// with s2 = (q.k) * scale * log2(e) in f32 (masked entries -1e30, the
// kv_valid_len tail rule of the forward), p = exp2(s2 - lse2) from the
// forward's base-2 row log-sum-exp (the 1e30 sentinel of an empty row gives
// p = 0), dp = dO.V^T, ds = p (dp - delta) with delta = rowsum(dO * O):
//   dq = scale * sum_kv ds K          (ds rounded to bf16 first)
//   dk = scale * sum_q  ds^T Q        (ds rounded to bf16 first)
//   dv =         sum_q  p^T dO        (p rounded to bf16 first)
// all accumulated in f32 and stored bf16.
//
// Bound on this card: 3 products in dq and 4 in dk/dv, each 2 * d FLOP per
// visible (q, kv) pair: at Wan-1.3B FULL (31,200 tokens, 12 heads x 128) that
// is 2.1e13 FLOP against ~0.5 GB of operands, so the tensor cores bound both
// kernels (~21 ms at 989 TFLOP/s bf16), provided that the products run on
// wgmma (mma.sync cannot reach that rate) and that no copy stalls them.  Each
// output row has exactly one writer, in both designs: no atomics, and the
// result does not depend on the order CTAs run in (the CUDA form of the TPU
// kernel's sequential "arbitrary" grid axis).  Two designs, chosen per call
// by the wrapper's shape rule (ops/flash_bwd.py:bwd_wgmma_path, the same rule
// on both sides):
//
// - The Hopper path (D = 128, block_q and block_kv multiples of 128: the
//   trainer's FULL, LOWRES and cross-attention), after FlashAttention-3's
//   backward, from csrc/attn_sm90.cuh's pieces (TMA maps, mbarriers, wgmma,
//   setmaxnreg).  Both kernels: one producer warpgroup whose first thread
//   issues every copy, two consumer warpgroups of 64 rows each.
//   dq (flash_dq_sm90_kernel): a CTA owns 128 q rows of one (b, h).  Q and
//     dO come once by TMA, each row's lse and delta once into registers; a
//     two-slot ring of 128-key K / V tiles walks the q block's kv list
//     (TileWalk: the sub-tiles the tail rule masks completely are skipped).
//     S = Q K^T and dP = dO V^T run on wgmma from shared memory (K-major
//     both); p and ds stay in registers; dQ += bf16(ds) K runs on the
//     register-A wgmma with K as an MN-major B (as the forward reads V).
//     The exponentials of a tile run while its dP product is in flight.
//   dk/dv (flash_dkv_sm90_kernel): a CTA owns 128 kv rows of one (b, h), its
//     K and V resident in shared memory (TMA, once).  A three-slot ring of
//     64-row q tiles walks the transposed list (q_index, q_count): Q and dO
//     by TMA, the tile's lse and delta by bulk copies riding the same
//     barrier.  S^T = K Q^T and dP^T = V dO^T (wgmma m64n64, K-major both)
//     leave p^T and ds^T in the accumulator layout, which is the A-fragment
//     layout of dV += bf16(p^T) dO and dK += bf16(ds^T) Q (register-A wgmma,
//     dO and Q MN-major).  Registers: dK and dV 64 each, S^T and dP^T 32
//     each a thread; q tiles of 128 rows would need 64 each, past the
//     consumers' 232.  A CTA whose rows all lie past the tail, or whose kv
//     block no q block visits, writes zeros before touching a barrier; kv
//     rows past the tail inside a CTA are masked (p = 0), so padded rows get
//     exactly zero dk and dv.
//   Same instructions as the forward's Hopper path: 2^x is ex2.approx.ftz,
//   the column mask runs only on a slot the tail rule cuts, scale multiplies
//   dq and dk once in the epilogue, and ds and p are rounded to bf16 where
//   the JAX kernels round them (the A fragments of the third product).
// - The mma.sync path (D = 64; blocks 128 does not divide: the 96- and
//   360-token STA tiles, 24-token tiles), below: every product on mma.sync
//   m16n8k16 (bf16 in, f32 accumulate), accumulators in registers.
//   dq: one CUDA block per (b, h, 64 q rows of a q block); each warp keeps
//       its 16 rows' Q and dO fragments, lse and delta in registers for the
//       whole walk over the q block's kv list (the forward's tables), with K
//       and V staged in 32-row shared-memory sub-tiles.
//   dk/dv: one CUDA block per (b, h, 64 kv rows of a kv block) walks the
//       TRANSPOSED list of q blocks that visit its kv block (transpose_tables),
//       with Q, dO, lse and delta staged in 32-row sub-tiles; its K and V rows
//       stay in shared memory, each warp owning 16 kv rows and their dk and
//       dv accumulators.
//   Blocks of 32 rows (2 warps) serve tables whose blocks 64 does not divide
//   (the 96-token STA tiles); 16 rows (1 warp) any other multiple of 16.  A
//   block that is a multiple of 8 but not of 16 (the 360-token STA tiles of
//   720p training) takes ceil(block / rows) CUDA blocks per table block, as
//   in the forward: rows past the table block (the 8-row half of its last
//   busy warp, and any warp past its end) are staged as zeros, masked out of
//   every product, and never stored.  The walked side is staged through
//   registers, synchronously: the C entry's hopper flag 0 keeps this path
//   reachable at the Hopper path's shapes, as the card's yardstick.
//
// The f32 mode (f32 q, k, v, dO: the f32 training path) has kernels of its
// own over the same tables, entered as vorta_flash_bwd_dq_f32 /
// vorta_flash_bwd_dkv_f32: csrc/attn_f32_tc_bwd.cuh's tensor-core dq and
// dk/dv (3xTF32 on wgmma, after the split pre-pass
// vorta_flash_bwd_f32_tc_split) where the wrapper's rule
// (ops/flash.py:flash_f32_tc_path: D = 128, blocks multiples of 8) holds
// and it passes the scratch, else csrc/attn_f32_bwd.cuh's FFMA dq and dk/dv
// at any shape the bf16 entries take (the wrapper's choice at D = 64).
#include "attn_f32_bwd.cuh"
#include "attn_f32_tc_bwd.cuh"
#include "attn_sm90.cuh"

namespace {

using namespace vorta;

constexpr int SUB = 32;  // rows per shared-memory sub-tile of the walked side

// Stage rows [base, base + rows) of a (.., D) bf16 tensor into smem rows
// [0, SUB) (row stride LDS), zero-filling rows >= rows.
template <int D, int LDS, int THREADS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int rows, int nrows_tile) {
  constexpr int CHUNKS = D / 8;
  for (int e = threadIdx.x; e < nrows_tile * CHUNKS; e += THREADS) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < rows) x = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = x;
  }
}

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
flash_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, const int* __restrict__ kv_index,
                const int* __restrict__ kv_count, int H, int Sq, int Skv, int width,
                int block_q, int block_kv, int last_block, int valid_in_block, float scale_log2,
                float scale) {
  constexpr int BLOCK_M = 16 * WARPS;
  constexpr int LDS = D + 8;  // padded row: conflict-free ldmatrix
  constexpr int NT_S = SUB / 8;
  constexpr int NT_O = D / 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[SUB * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[SUB * LDS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  // this warp's first row inside table q block qi; rows g / g + 8 past the
  // block's end are read as zeros and not stored
  const int cblocks = (block_q + BLOCK_M - 1) / BLOCK_M;
  const int qi = blockIdx.x / cblocks;
  const int local = (blockIdx.x % cblocks) * BLOCK_M + warp * 16;
  const bool row_ok[2] = {local < block_q, local + 16 <= block_q};
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t r_g = bh * Sq + qi * block_q + local + g;  // this thread's rows r_g, r_g + 8
  const __nv_bfloat16* kp = k + bh * Skv * D;
  const __nv_bfloat16* vp = v + bh * Skv * D;

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_q_frags<D>(qa, row_ok[0] ? q + r_g * D : nullptr,
                  row_ok[1] ? q + (r_g + 8) * D : nullptr, t);
  load_q_frags<D>(da, row_ok[0] ? dout + r_g * D : nullptr,
                  row_ok[1] ? dout + (r_g + 8) * D : nullptr, t);
  // a row past the block: the sentinel makes every p 0
  const float lse_r[2] = {row_ok[0] ? lse[r_g] : 1e30f, row_ok[1] ? lse[r_g + 8] : 1e30f};
  const float dl_r[2] = {row_ok[0] ? delta[r_g] : 0.f, row_ok[1] ? delta[r_g + 8] : 0.f};

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int count = kv_count[qi];
  const int* idx = kv_index + static_cast<size_t>(qi) * width;
  for (int j = 0; j < count; ++j) {
    const int kvb = idx[j];
    const int limit_blk = (kvb == last_block) ? valid_in_block : block_kv;
    for (int n0 = 0; n0 < block_kv; n0 += SUB) {
      const int rows = min(SUB, block_kv - n0);
      const int nvalid = min(rows, limit_blk - n0);
      if (nvalid <= 0) continue;  // every p is 0: no contribution
      const size_t base = static_cast<size_t>(kvb) * block_kv + n0;
      __syncthreads();  // previous sub-tile fully consumed
      stage_rows<D, LDS, WARPS * 32>(Ks, kp + base * D, rows, SUB);
      stage_rows<D, LDS, WARPS * 32>(Vs, vp + base * D, rows, SUB);
      __syncthreads();

      float s[NT_S][4], dp[NT_S][4];
      qk_tile<D, NT_S, LDS>(s, qa, Ks, lane);  // S = Q K^T
      qk_tile<D, NT_S, LDS>(dp, da, Vs, lane);  // dP = dO V^T
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          const float x = (col < nvalid) ? s[n][e] * scale_log2 : NEG_INF;
          const float p = exp2f(x - lse_r[e >> 1]);
          s[n][e] = p * (dp[n][e] - dl_r[e >> 1]);  // ds
        }
      }
      pv_tile<D, NT_S, LDS>(acc, s, Ks, lane);  // dq += ds K, ds rounded to bf16
    }
  }

#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * t;
    if (row_ok[0])
      *reinterpret_cast<uint32_t*>(dq + r_g * D + c) =
          pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    if (row_ok[1])
      *reinterpret_cast<uint32_t*>(dq + (r_g + 8) * D + c) =
          pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int D, int WARPS>
constexpr int dkv_smem_bytes() {
  return (2 * 16 * WARPS + 2 * SUB) * (D + 8) * 2 + 2 * SUB * 4;
}

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
flash_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                 const int* __restrict__ q_index, const int* __restrict__ q_count, int H, int Sq,
                 int Skv, int width_t, int block_q, int block_kv, int last_block,
                 int valid_in_block, float scale_log2, float scale) {
  constexpr int ROWS = 16 * WARPS;  // kv rows of this CUDA block
  constexpr int LDS = D + 8;
  constexpr int NT_S = SUB / 8;
  constexpr int NT_O = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + ROWS * LDS;
  __nv_bfloat16* Qs = Vs + ROWS * LDS;
  __nv_bfloat16* Ds = Qs + SUB * LDS;
  float* lse_s = reinterpret_cast<float*>(Ds + SUB * LDS);
  float* dl_s = lse_s + SUB;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  // this CUDA block's first row inside table kv block kvb, and its rows
  // there (fewer than ROWS in the last CUDA block of a block that ROWS does
  // not divide: the rest are staged as zeros, masked and not stored)
  const int cblocks = (block_kv + ROWS - 1) / ROWS;
  const int kvb = blockIdx.x / cblocks;
  const int local0 = (blockIdx.x % cblocks) * ROWS;
  const int n_rows = min(ROWS, block_kv - local0);
  const int row0 = kvb * block_kv + local0;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const __nv_bfloat16* qp = q + bh * Sq * D;
  const __nv_bfloat16* dop = dout + bh * Sq * D;
  const float* lp = lse + bh * Sq;
  const float* dlp = delta + bh * Sq;

  // this thread's kv rows (g, g + 8 of its warp) inside the kv block, and
  // whether the tail rule leaves them visible (limit_blk <= block_kv, so
  // rows past the block are never visible)
  const int limit_blk = (kvb == last_block) ? valid_in_block : block_kv;
  const int in_blk = local0 + warp * 16 + g;
  const bool row_ok[2] = {in_blk < limit_blk, in_blk + 8 < limit_blk};
  const bool row_in[2] = {in_blk < block_kv, in_blk + 8 < block_kv};

  stage_rows<D, LDS, WARPS * 32>(Ks, k + (bh * Skv + row0) * D, n_rows, ROWS);
  stage_rows<D, LDS, WARPS * 32>(Vs, v + (bh * Skv + row0) * D, n_rows, ROWS);

  float dk_acc[NT_O][4], dv_acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }

  const int count = q_count[kvb];
  const int* idx = q_index + static_cast<size_t>(kvb) * width_t;
  for (int w = 0; w < count; ++w) {
    const int qb = idx[w];
    for (int m0 = 0; m0 < block_q; m0 += SUB) {
      const int rows = min(SUB, block_q - m0);
      const size_t base = static_cast<size_t>(qb) * block_q + m0;
      __syncthreads();  // previous sub-tile fully consumed (and K, V staged)
      stage_rows<D, LDS, WARPS * 32>(Qs, qp + base * D, rows, SUB);
      stage_rows<D, LDS, WARPS * 32>(Ds, dop + base * D, rows, SUB);
      for (int r = threadIdx.x; r < SUB; r += WARPS * 32) {
        // rows past the q block: p = 0 through the sentinel, dO rows are 0
        lse_s[r] = r < rows ? lp[base + r] : 1e30f;
        dl_s[r] = r < rows ? dlp[base + r] : 0.f;
      }
      __syncthreads();

      float s[NT_S][4], dp[NT_S][4];
      abt_tile<D, NT_S, LDS>(s, Ks + warp * 16 * LDS, Qs, lane);   // S^T = K Q^T
      abt_tile<D, NT_S, LDS>(dp, Vs + warp * 16 * LDS, Ds, lane);  // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);  // q row in the sub-tile
          const float x = row_ok[e >> 1] ? s[n][e] * scale_log2 : NEG_INF;
          const float p = exp2f(x - lse_s[col]);
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl_s[col]);  // ds^T
        }
      }
      pv_tile<D, NT_S, LDS>(dv_acc, s, Ds, lane);   // dv += p^T dO, p rounded to bf16
      pv_tile<D, NT_S, LDS>(dk_acc, dp, Qs, lane);  // dk += ds^T Q, ds rounded to bf16
    }
  }

  const size_t r_g = bh * Skv + row0 + warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * t;
    if (row_in[0]) {
      *reinterpret_cast<uint32_t*>(dk + r_g * D + c) =
          pack_bf16(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + r_g * D + c) = pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    }
    if (row_in[1]) {
      *reinterpret_cast<uint32_t*>(dk + (r_g + 8) * D + c) =
          pack_bf16(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + (r_g + 8) * D + c) =
          pack_bf16(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

// ---- the Hopper path: csrc/attn_sm90.cuh's pieces ------------------------------------

namespace hop {

using namespace vorta::sm90;

// dq: Q and dO (128 rows each), then DQ_STAGES slots of K and V (128 keys each)
constexpr int DQ_STAGES = 2;
constexpr int DQ_DO_OFF = Q_BYTES;
constexpr int DQ_RING_OFF = 2 * Q_BYTES;
constexpr int DQ_BAR_OFF = DQ_RING_OFF + DQ_STAGES * STAGE_BYTES;
// q_full, then k_full, k_empty, v_full, v_empty [DQ_STAGES] each; 1,024 B of
// slack to align the base
constexpr int DQ_SMEM_BYTES = DQ_BAR_OFF + (1 + 4 * DQ_STAGES) * 8 + 1024;

// dk/dv: the resident K and V (128 rows each), then DKV_STAGES slots of a
// 64-row q tile (Q, dO), then each slot's lse and delta
constexpr int QT = 64;
constexpr int QT_BYTES = QT * D * 2;
constexpr int DKV_STAGES = 3;
constexpr int DKV_RING_OFF = 2 * KV_BYTES;
constexpr int DKV_LINE = QT * 4;  // one slot's lse (or delta) bytes
constexpr int DKV_ROWS_OFF = DKV_RING_OFF + DKV_STAGES * 2 * QT_BYTES;
constexpr int DKV_BAR_OFF = DKV_ROWS_OFF + DKV_STAGES * 2 * DKV_LINE;
// kv_full, then full, empty [DKV_STAGES] each
constexpr int DKV_SMEM_BYTES = DKV_BAR_OFF + (1 + 2 * DKV_STAGES) * 8 + 1024;
static_assert(DQ_SMEM_BYTES <= 232448 && DKV_SMEM_BYTES <= 232448,
              "shared memory of one H100 block");

struct BwdParams {
  __nv_bfloat16 *dq, *dk, *dv;  // the kernel's outputs (the other kernel's: null)
  const float *lse, *delta;     // (B, H, Sq) f32
  const int *index, *count;     // dq: kv_index / kv_count; dk/dv: q_index / q_count
  int H, Sq, Skv, width, block_q, block_kv;
  int last_block, valid_in_block;  // the tail rule: block kv_valid_len // block_kv
  float scale_log2, scale;
};

// Every consumer warp releases a slot once its last reader is done.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Zeros over `rows` rows of a (.., D) bf16 tensor from o, by every thread.
__device__ __forceinline__ void zero_rows(__nv_bfloat16* o, int rows, int tid) {
  uint4* o4 = reinterpret_cast<uint4*>(o);
  for (int e = tid; e < rows * D / 8; e += THREADS) o4[e] = make_uint4(0, 0, 0, 0);
}

// A 64 x 128 accumulator times scale into this thread's rows (r0: row g of
// its warp, r8: row g + 8), columns 8n + 2t and 8n + 2t + 1.
__device__ __forceinline__ void store_rows(__nv_bfloat16* r0, __nv_bfloat16* r8,
                                           const float (&acc)[64], float scale, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(r0 + 8 * n + 2 * t) =
        pack_bf16(acc[4 * n] * scale, acc[4 * n + 1] * scale);
    *reinterpret_cast<uint32_t*>(r8 + 8 * n + 2 * t) =
        pack_bf16(acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
  }
}

// dq: p = 2^(s * scale_log2 - lse) in place, -1e30 before the exponential
// on the columns past nvalid (MASK: a slot the tail rule cuts), so p = 0.
template <bool MASK>
__device__ __forceinline__ void dq_p(float (&s)[64], int nvalid, int t, float scale_log2,
                                     const float (&lse)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float x = s[i] * scale_log2;
    const bool off = MASK && 8 * (i / 4) + 2 * t + (i & 1) >= nvalid;
    s[i] = ex2((off ? NEG_INF : x) - lse[(i >> 1) & 1]);
  }
}

// dq: ds = p (dp - delta), rounded to bf16 pairs: the A fragments of
// dQ += ds K (step kk takes da[4kk..4kk+3], as pack_p lays out P).
__device__ __forceinline__ void dq_ds(uint32_t (&da)[32], const float (&p)[64],
                                      const float (&dp)[64], const float (&dl)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {  // elements 2i, 2i + 1: row g + 8 (i & 1)
    const float d = dl[i & 1];
    da[i] = pack_bf16(p[2 * i] * (dp[2 * i] - d), p[2 * i + 1] * (dp[2 * i + 1] - d));
  }
}

// dk/dv: p^T = 2^(s^T * scale_log2 - lse[q]) in place, q the column (this
// thread's columns 8n + 2t, + 1: the slot's lse in shared memory at ls);
// -1e30 before the exponential on the kv rows past the tail (CUT: a CTA the
// tail rule cuts), so p = 0 there.
template <bool CUT>
__device__ __forceinline__ void dkv_p(float (&st)[32], int t, float scale_log2, const float* ls,
                                      const bool (&row_ok)[2]) {
#pragma unroll
  for (int n = 0; n < QT / 8; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e;
      const float x = st[i] * scale_log2;
      const bool off = CUT && !row_ok[e >> 1];
      st[i] = ex2((off ? NEG_INF : x) - ((e & 1) ? l.y : l.x));
    }
  }
}

// dk/dv: p^T and ds^T = p^T (dp^T - delta[q]) rounded to bf16 pairs, the A
// fragments of dV += p^T dO (pa) and dK += ds^T Q (da), in one pass so that
// each pair of scores dies as its two fragments are made (the slot's delta
// at dl).
__device__ __forceinline__ void dkv_frags(uint32_t (&pa)[16], uint32_t (&da)[16],
                                          const float (&pt)[32], const float (&dpt)[32],
                                          const float* dl, int t) {
#pragma unroll
  for (int n = 0; n < QT / 8; ++n) {
    const float2 d = *reinterpret_cast<const float2*>(dl + 8 * n + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // registers 4n + 2h, 4n + 2h + 1: row g + 8h
      const int i = 4 * n + 2 * h;
      pa[i / 2] = pack_bf16(pt[i], pt[i + 1]);
      da[i / 2] = pack_bf16(pt[i] * (dpt[i] - d.x), pt[i + 1] * (dpt[i + 1] - d.y));
    }
  }
}

// dq over the q block's kv list.  tq / tdo: 128-row boxes, tk / tv: 128-key
// boxes (64 columns each, 128-byte swizzle).
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_smem = base, do_smem = base + DQ_DO_OFF;
  const uint32_t bar_q = base + DQ_BAR_OFF;
  auto k_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto k_empty = [&](int s) { return bar_q + 8 * (1 + DQ_STAGES + s); };
  auto v_full = [&](int s) { return bar_q + 8 * (1 + 2 * DQ_STAGES + s); };
  auto v_empty = [&](int s) { return bar_q + 8 * (1 + 3 * DQ_STAGES + s); };
  auto k_smem = [&](int s) { return base + DQ_RING_OFF + s * STAGE_BYTES; };
  auto v_smem = [&](int s) { return base + DQ_RING_OFF + s * STAGE_BYTES + KV_BYTES; };

  const int tid = threadIdx.x;
  const size_t bh = static_cast<size_t>(blockIdx.z) * p.H + blockIdx.y;
  const int row0 = blockIdx.x * BM;  // inside one table q block (block_q % BM == 0)
  const int qi = row0 / p.block_q;
  const int count = p.count[qi];
  if (count == 0) {  // a q block that sees nothing: zero dq, no barrier touched
    zero_rows(p.dq + (bh * p.Sq + row0) * D, BM, tid);
    return;
  }
  TileWalk walk{p.index + static_cast<size_t>(qi) * p.width, count, p.block_kv, p.last_block,
                p.valid_in_block};
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), EMPTY_ARRIVALS);
      mbar_init(v_empty(s), EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  int key0, nvalid;
  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every copy ----------------------------------
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      const int qrow = static_cast<int>(bh * p.Sq) + row0;
      mbar_expect_tx(bar_q, 2 * Q_BYTES);
      tma_load(q_smem, &tq, bar_q, 0, qrow);
      tma_load(q_smem + BM * ROW_BYTES, &tq, bar_q, 64, qrow);
      tma_load(do_smem, &tdo, bar_q, 0, qrow);
      tma_load(do_smem + BM * ROW_BYTES, &tdo, bar_q, 64, qrow);
      int stage = 0;
      uint32_t phase = 0;
      while (walk.next(key0, nvalid)) {
        const int row = static_cast<int>(bh * p.Skv) + key0;
        mbar_wait(k_empty(stage), phase ^ 1);
        mbar_expect_tx(k_full(stage), KV_BYTES);
        tma_load(k_smem(stage), &tk, k_full(stage), 0, row);
        tma_load(k_smem(stage) + BN * ROW_BYTES, &tk, k_full(stage), 64, row);
        mbar_wait(v_empty(stage), phase ^ 1);
        mbar_expect_tx(v_full(stage), KV_BYTES);
        tma_load(v_smem(stage), &tv, v_full(stage), 0, row);
        tma_load(v_smem(stage) + BN * ROW_BYTES, &tv, v_full(stage), 64, row);
        if (++stage == DQ_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: 64 q rows per warpgroup ----------------------------------------
  setmaxnreg_inc<232>();
  const int ltid = tid % 128;
  const int warp = ltid / 32, lane = ltid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t r_g = bh * p.Sq + row0 + wg * 64 + warp * 16 + g;  // rows r_g, r_g + 8
  const float lse[2] = {p.lse[r_g], p.lse[r_g + 8]};
  const float dl[2] = {p.delta[r_g], p.delta[r_g + 8]};
  float acc[64], s[64], dp[64];
  uint32_t da[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  while (walk.next(key0, nvalid)) {
    // S = Q K^T, then dP = dO V^T, two groups: p's exponentials run while
    // the dP product is in flight
    mbar_wait(k_full(stage), phase);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(s, kmajor_desc(q_smem, BM, wg * 64, kk), kmajor_desc(k_smem(stage), BN, 0, kk),
                    kk > 0);
    wgmma_commit();
    mbar_wait(v_full(stage), phase);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(dp, kmajor_desc(do_smem, BM, wg * 64, kk),
                    kmajor_desc(v_smem(stage), BN, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S: the older group
    fence_regs(s);
    if (nvalid < BN)
      dq_p<true>(s, nvalid, t, p.scale_log2, lse);
    else
      dq_p<false>(s, nvalid, t, p.scale_log2, lse);
    wgmma_wait<0>();
    fence_regs(dp);
    release(v_empty(stage), lane);  // dP was V's last reader
    dq_ds(da, s, dp, dl);
    // dQ += bf16(ds) K: K as an MN-major B, as the forward reads V
    fence_regs(acc);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_n128(acc, &da[4 * kk], mnmajor_desc(k_smem(stage), BN, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(da);
    release(k_empty(stage), lane);
    if (++stage == DQ_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows(p.dq + r_g * D, p.dq + (r_g + 8) * D, acc, p.scale, t);
}

// dk and dv over the kv block's transposed list.  tq / tdo: 64-row boxes,
// tk / tv: 128-row boxes (64 columns each, 128-byte swizzle).
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);  // generic pointer to the aligned base
  const uint32_t k_smem = base, v_smem = base + KV_BYTES;
  const uint32_t bar_kv = base + DKV_BAR_OFF;
  auto full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8 * (1 + DKV_STAGES + s); };
  auto q_slot = [&](int s) { return base + DKV_RING_OFF + s * 2 * QT_BYTES; };
  auto do_slot = [&](int s) { return base + DKV_RING_OFF + s * 2 * QT_BYTES + QT_BYTES; };
  auto lines = [&](int s) { return DKV_ROWS_OFF + s * 2 * DKV_LINE; };  // lse, then delta

  const int tid = threadIdx.x;
  const size_t bh = static_cast<size_t>(blockIdx.z) * p.H + blockIdx.y;
  const int row0 = blockIdx.x * BN;  // inside one table kv block (block_kv % BN == 0)
  const int kvb = row0 / p.block_kv;
  const int local0 = row0 - kvb * p.block_kv;
  const int limit = (kvb == p.last_block) ? p.valid_in_block : p.block_kv;
  const int count = p.count[kvb];
  if (count == 0 || local0 >= limit) {  // no q block visits, or all rows past the tail
    zero_rows(p.dk + (bh * p.Skv + row0) * D, BN, tid);
    zero_rows(p.dv + (bh * p.Skv + row0) * D, BN, tid);
    return;
  }
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == CONSUMERS) {
    // ---- producer: K and V once, then the q tiles -----------------------------------
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      const int krow = static_cast<int>(bh * p.Skv) + row0;
      mbar_expect_tx(bar_kv, 2 * KV_BYTES);
      tma_load(k_smem, &tk, bar_kv, 0, krow);
      tma_load(k_smem + BN * ROW_BYTES, &tk, bar_kv, 64, krow);
      tma_load(v_smem, &tv, bar_kv, 0, krow);
      tma_load(v_smem + BN * ROW_BYTES, &tv, bar_kv, 64, krow);
      const int* idx = p.index + static_cast<size_t>(kvb) * p.width;
      int stage = 0;
      uint32_t phase = 0;
      for (int w = 0; w < count; ++w) {
        const size_t q0 = bh * p.Sq + static_cast<size_t>(idx[w]) * p.block_q;
        for (int m0 = 0; m0 < p.block_q; m0 += QT) {
          const int qrow = static_cast<int>(q0) + m0;
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), 2 * QT_BYTES + 2 * DKV_LINE);
          tma_load(q_slot(stage), &tq, full(stage), 0, qrow);
          tma_load(q_slot(stage) + QT * ROW_BYTES, &tq, full(stage), 64, qrow);
          tma_load(do_slot(stage), &tdo, full(stage), 0, qrow);
          tma_load(do_slot(stage) + QT * ROW_BYTES, &tdo, full(stage), 64, qrow);
          bulk_load(base + lines(stage), p.lse + q0 + m0, DKV_LINE, full(stage));
          bulk_load(base + lines(stage) + DKV_LINE, p.delta + q0 + m0, DKV_LINE, full(stage));
          if (++stage == DKV_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 kv rows per warpgroup ----------------------------------------
  setmaxnreg_inc<232>();
  const int ltid = tid % 128;
  const int warp = ltid / 32, lane = ltid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = wg * 64 + warp * 16 + g;  // this thread's CTA rows: row, row + 8
  const bool cut = local0 + BN > limit;   // the tail rule cuts this CTA's rows
  const bool row_ok[2] = {local0 + row < limit, local0 + row + 8 < limit};
  float dk[64], dv[64], st[32], dpt[32];
  uint32_t pa[16], da[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  const int tiles = count * (p.block_q / QT);
  mbar_wait(bar_kv, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    mbar_wait(full(stage), phase);
    const float* ls = reinterpret_cast<const float*>(gbase + lines(stage));
    // S^T = K Q^T, then dP^T = V dO^T, two groups
    fence_regs(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st, kmajor_desc(k_smem, BN, wg * 64, kk), kmajor_desc(q_slot(stage), QT, 0, kk),
                   kk > 0);
    wgmma_commit();
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpt, kmajor_desc(v_smem, BN, wg * 64, kk),
                   kmajor_desc(do_slot(stage), QT, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S^T: its exponentials run while dP^T is in flight
    fence_regs(st);
    if (cut)
      dkv_p<true>(st, t, p.scale_log2, ls, row_ok);
    else
      dkv_p<false>(st, t, p.scale_log2, ls, row_ok);
    wgmma_wait<0>();
    fence_regs(dpt);
    dkv_frags(pa, da, st, dpt, ls + QT, t);
    // dV += bf16(p^T) dO and dK += bf16(ds^T) Q, dO and Q MN-major
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      wgmma_rs_n128(dv, &pa[4 * kk], mnmajor_desc(do_slot(stage), QT, kk), 1);
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      wgmma_rs_n128(dk, &da[4 * kk], mnmajor_desc(q_slot(stage), QT, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    release(empty(stage), lane);  // the slot's last readers: the two products, ls
    if (++stage == DKV_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  const size_t r_g = bh * p.Skv + row0 + row;
  store_rows(p.dk + r_g * D, p.dk + (r_g + 8) * D, dk, p.scale, t);
  store_rows(p.dv + r_g * D, p.dv + (r_g + 8) * D, dv, 1.f, t);
}

}  // namespace hop

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, Sq, Skv, block_q, block_kv, last_block, valid_in_block;
  float scale_log2, scale;
  cudaStream_t stream;
};

template <int D, int WARPS>
cudaError_t launch_dq(const Args& a, __nv_bfloat16* dq, const int* kv_index, const int* kv_count,
                      int width) {
  const int nq = a.Sq / a.block_q;
  dim3 grid(nq * ((a.block_q + 16 * WARPS - 1) / (16 * WARPS)), a.H, a.B);
  flash_dq_kernel<D, WARPS><<<grid, WARPS * 32, 0, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dq, kv_index, kv_count, a.H, a.Sq, a.Skv, width,
      a.block_q, a.block_kv, a.last_block, a.valid_in_block, a.scale_log2, a.scale);
  return cudaGetLastError();
}

template <int D, int WARPS>
cudaError_t launch_dkv(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv, const int* q_index,
                       const int* q_count, int width_t) {
  constexpr int smem = dkv_smem_bytes<D, WARPS>();
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<D, WARPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nkv = a.Skv / a.block_kv;
  dim3 grid(nkv * ((a.block_kv + 16 * WARPS - 1) / (16 * WARPS)), a.H, a.B);
  flash_dkv_kernel<D, WARPS><<<grid, WARPS * 32, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dk, dv, q_index, q_count, a.H, a.Sq, a.Skv, width_t,
      a.block_q, a.block_kv, a.last_block, a.valid_in_block, a.scale_log2, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dq(const Args& a, __nv_bfloat16* dq, const int* ki, const int* kc, int w) {
  switch (warps_for(a.block_q)) {
    case 4: return launch_dq<D, 4>(a, dq, ki, kc, w);
    case 2: return launch_dq<D, 2>(a, dq, ki, kc, w);
    default: return launch_dq<D, 1>(a, dq, ki, kc, w);
  }
}

template <int D>
cudaError_t dispatch_dkv(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv, const int* qi,
                         const int* qc, int w) {
  switch (warps_for(a.block_kv)) {
    case 4: return launch_dkv<D, 4>(a, dk, dv, qi, qc, w);
    case 2: return launch_dkv<D, 2>(a, dk, dv, qi, qc, w);
    default: return launch_dkv<D, 1>(a, dk, dv, qi, qc, w);
  }
}

bool make_args(Args& a, const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int B, int H, int Sq, int Skv, int D,
               int block_q, int block_kv, int kv_valid_len, float scale, void* stream) {
  if (Sq % block_q || Skv % block_kv || block_q % 8 || block_kv % 8 || (D != 64 && D != 128))
    return false;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.B = B, a.H = H, a.Sq = Sq, a.Skv = Skv, a.block_q = block_q, a.block_kv = block_kv;
  // the tail rule of the forward: only block kv_valid_len // block_kv is cut
  a.last_block = kv_valid_len % block_kv ? kv_valid_len / block_kv : -1;
  a.valid_in_block = kv_valid_len % block_kv;
  a.scale = scale;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.stream = static_cast<cudaStream_t>(stream);
  return true;
}

// The Hopper path's shapes (ops/flash_bwd.py:bwd_wgmma_path): D = 128 and
// blocks that 128 tiles, so every CTA lies in one table block and every ring
// slot is whole.
bool hopper_shapes(const Args& a, int D) {
  using namespace vorta::sm90;
  return D == sm90::D && a.block_q % BM == 0 && a.block_kv % BN == 0;
}

// The four TMA maps of a Hopper launch: q and dout in boxes of q_box rows,
// k and v in boxes of 128 keys.
bool hopper_maps(const Args& a, uint32_t q_box, CUtensorMap* maps) {
  using namespace vorta::sm90;
  const uint64_t bh = static_cast<uint64_t>(a.B) * a.H;
  return make_map(&maps[0], a.q, bh * a.Sq, q_box) && make_map(&maps[1], a.k, bh * a.Skv, BN) &&
         make_map(&maps[2], a.v, bh * a.Skv, BN) && make_map(&maps[3], a.dout, bh * a.Sq, q_box);
}

hop::BwdParams hopper_params(const Args& a, const int* index, const int* count, int width) {
  return hop::BwdParams{nullptr, nullptr, nullptr, a.lse, a.delta, index, count, a.H, a.Sq,
                        a.Skv, width, a.block_q, a.block_kv, a.last_block, a.valid_in_block,
                        a.scale_log2, a.scale};
}

cudaError_t launch_dq_sm90(const Args& a, __nv_bfloat16* dq, const int* ki, const int* kc,
                           int width) {
  CUtensorMap m[4];
  if (!hopper_maps(a, vorta::sm90::BM, m)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(hop::flash_dq_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         hop::DQ_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  hop::BwdParams p = hopper_params(a, ki, kc, width);
  p.dq = dq;
  hop::flash_dq_sm90_kernel<<<dim3(a.Sq / vorta::sm90::BM, a.H, a.B), vorta::sm90::THREADS,
                              hop::DQ_SMEM_BYTES, a.stream>>>(m[0], m[1], m[2], m[3], p);
  return cudaGetLastError();
}

cudaError_t launch_dkv_sm90(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv, const int* qi,
                            const int* qc, int width_t) {
  CUtensorMap m[4];
  if (!hopper_maps(a, hop::QT, m)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(hop::flash_dkv_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         hop::DKV_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  hop::BwdParams p = hopper_params(a, qi, qc, width_t);
  p.dk = dk;
  p.dv = dv;
  hop::flash_dkv_sm90_kernel<<<dim3(a.Skv / vorta::sm90::BN, a.H, a.B), vorta::sm90::THREADS,
                               hop::DKV_SMEM_BYTES, a.stream>>>(m[0], m[1], m[2], m[3], p);
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq: contiguous (B, H, Sq, D) bf16; k, v: (B, H, Skv, D) bf16; lse,
// delta: (B, H, Sq) f32 (all 16-byte aligned on the Hopper path).  kv_index
// (1, Sq / block_q, width), kv_count (1, Sq / block_q): the forward's
// head-shared tables, int32 on the device.  hopper: the wrapper's shape rule
// chose the Hopper path (the C side refuses it for other shapes); 0 runs the
// mma.sync kernel at any shape it takes.
extern "C" int vorta_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, const void* kv_index, const void* kv_count,
                                       int B, int H, int Sq, int Skv, int D, int width,
                                       int block_q, int block_kv, int kv_valid_len, float scale,
                                       int hopper, void* stream) {
  Args a;
  if (!make_args(a, q, k, v, dout, lse, delta, B, H, Sq, Skv, D, block_q, block_kv,
                 kv_valid_len, scale, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* o = static_cast<__nv_bfloat16*>(dq);
  auto* ki = static_cast<const int*>(kv_index);
  auto* kc = static_cast<const int*>(kv_count);
  if (hopper)  // the wrapper's rule picked the Hopper path: its shapes or an error
    return static_cast<int>(hopper_shapes(a, D) ? launch_dq_sm90(a, o, ki, kc, width)
                                                : cudaErrorInvalidValue);
  return static_cast<int>(D == 128 ? dispatch_dq<128>(a, o, ki, kc, width)
                                   : dispatch_dq<64>(a, o, ki, kc, width));
}

// dk, dv: (B, H, Skv, D) bf16.  q_index (1, Skv / block_kv, width_t), q_count
// (1, Skv / block_kv): the transposed tables (which q blocks visit each kv
// block), int32 on the device.
extern "C" int vorta_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dk, void* dv, const void* q_index,
                                        const void* q_count, int B, int H, int Sq, int Skv,
                                        int D, int width_t, int block_q, int block_kv,
                                        int kv_valid_len, float scale, int hopper,
                                        void* stream) {
  Args a;
  if (!make_args(a, q, k, v, dout, lse, delta, B, H, Sq, Skv, D, block_q, block_kv,
                 kv_valid_len, scale, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* ok = static_cast<__nv_bfloat16*>(dk);
  auto* ov = static_cast<__nv_bfloat16*>(dv);
  auto* qi = static_cast<const int*>(q_index);
  auto* qc = static_cast<const int*>(q_count);
  if (hopper)
    return static_cast<int>(hopper_shapes(a, D) ? launch_dkv_sm90(a, ok, ov, qi, qc, width_t)
                                                : cudaErrorInvalidValue);
  return static_cast<int>(D == 128 ? dispatch_dkv<128>(a, ok, ov, qi, qc, width_t)
                                   : dispatch_dkv<64>(a, ok, ov, qi, qc, width_t));
}

// The Hopper kernels' dynamic shared memory per CTA, in bytes (for reports):
// dq's (dkv 0) or dk/dv's (dkv 1).
extern "C" int vorta_flash_bwd_sm90_smem_bytes(int dkv) {
  return dkv ? hop::DKV_SMEM_BYTES : hop::DQ_SMEM_BYTES;
}

// ---- the f32 mode: csrc/attn_f32_tc_bwd.cuh's tensor-core kernels where the
// wrapper's rule holds, csrc/attn_f32_bwd.cuh's FFMA kernels elsewhere -----------------

namespace {

// BwdParams of an f32 call, or false where the shapes are not the kernels'
// (work: the tensor-core kernels' scratch, given only where their rule holds).
bool f32_params(vorta::f32::BwdParams& p, const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta, const void* index,
                const void* count, int H, int Sq, int Skv, int D, int width, int block_q,
                int block_kv, int kv_valid_len, float scale, const void* work) {
  if (Sq % block_q || Skv % block_kv || block_q % 8 || block_kv % 8 || (D != 64 && D != 128))
    return false;
  if (work != nullptr && !vorta::f32tc::flash_path_holds(D, block_q, block_kv)) return false;
  p = vorta::f32::BwdParams{
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), nullptr, nullptr, nullptr,
      static_cast<const int*>(index), static_cast<const int*>(count), H, Sq, Skv, width,
      block_q, block_kv, kv_valid_len % block_kv ? kv_valid_len / block_kv : -1,
      kv_valid_len % block_kv, scale * 1.4426950408889634f, scale};
  return true;
}

}  // namespace

// The tensor-core kernels' split pre-pass, once a call before either kernel:
// q, k, v, dout contiguous (B, H, S, 128) f32 on 16-byte boundaries into
// work (ops/flash_bwd.py:f32_tc_bwd_work: 2 B H (4 Sq + 3 Skv) 128 f32,
// 16-byte aligned), the transposed halves each kernel needs (need_dq: K^T;
// need_dkv: Q^T, dO^T).  Refused (an error) outside the rule
// (ops/flash.py:flash_f32_tc_path).  Returns the CUDA error code.
extern "C" int vorta_flash_bwd_f32_tc_split(const void* q, const void* k, const void* v,
                                            const void* dout, void* work, int B, int H, int Sq,
                                            int Skv, int D, int block_q, int block_kv,
                                            int kv_valid_len, int need_dq, int need_dkv,
                                            void* stream) {
  using namespace vorta::f32tc;
  if (work == nullptr || Sq % block_q || Skv % block_kv || !flash_path_holds(D, block_q, block_kv))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(split_bwd(
      q, k, v, dout, bwd_work(work, B, H, Sq, Skv), B, H, Sq, Skv, block_q, block_kv,
      kv_valid_len % block_kv ? kv_valid_len / block_kv : -1, kv_valid_len % block_kv, need_dq,
      need_dkv, static_cast<cudaStream_t>(stream)));
}

// The f32 mode of vorta_flash_bwd_dq_bf16: q, k, v, dout, dq contiguous
// (B, H, S, D) f32 on 16-byte boundaries; lse, delta, the tables and the
// shapes as there.  work: null (the FFMA kernel, any shape), or where the
// wrapper's rule chose the tensor-core kernel (D = 128, blocks multiples of
// 8; anything else there is an error, never a fallback) the scratch that
// vorta_flash_bwd_f32_tc_split has filled.  Returns the CUDA error code.
extern "C" int vorta_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, const void* kv_index, const void* kv_count, int B,
                                      int H, int Sq, int Skv, int D, int width, int block_q,
                                      int block_kv, int kv_valid_len, float scale, void* work,
                                      void* stream) {
  using namespace vorta::f32;
  BwdParams p;
  if (!f32_params(p, q, k, v, dout, lse, delta, kv_index, kv_count, H, Sq, Skv, D, width,
                  block_q, block_kv, kv_valid_len, scale, work))
    return static_cast<int>(cudaErrorInvalidValue);
  p.dq = static_cast<float*>(dq);
  auto st = static_cast<cudaStream_t>(stream);
  if (work != nullptr)
    return static_cast<int>(
        vorta::f32tc::launch_dq(vorta::f32tc::bwd_work(work, B, H, Sq, Skv), B, p, st));
  const dim3 grid(Sq / block_q * ((block_q + BQ - 1) / BQ), H, B);
  return static_cast<int>(
      D == 128 ? launch_bwd(flash_dq_f32_kernel<128>, grid, BwdLayout<128>::DQ_BYTES, st, p)
               : launch_bwd(flash_dq_f32_kernel<64>, grid, BwdLayout<64>::DQ_BYTES, st, p));
}

// The f32 mode of vorta_flash_bwd_dkv_bf16: dk, dv (B, H, Skv, D) f32; the
// transposed tables as there; work as for vorta_flash_bwd_dq_f32.  Returns
// the CUDA error code.
extern "C" int vorta_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, const void* q_index,
                                       const void* q_count, int B, int H, int Sq, int Skv, int D,
                                       int width_t, int block_q, int block_kv, int kv_valid_len,
                                       float scale, void* work, void* stream) {
  using namespace vorta::f32;
  BwdParams p;
  if (!f32_params(p, q, k, v, dout, lse, delta, q_index, q_count, H, Sq, Skv, D, width_t,
                  block_q, block_kv, kv_valid_len, scale, work))
    return static_cast<int>(cudaErrorInvalidValue);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  if (work != nullptr)
    return static_cast<int>(
        vorta::f32tc::launch_dkv(vorta::f32tc::bwd_work(work, B, H, Sq, Skv), B, p, st));
  const dim3 grid(Skv / block_kv * ((block_kv + BK - 1) / BK), H, B);
  return static_cast<int>(
      D == 128 ? launch_bwd(flash_dkv_f32_kernel<128>, grid, BwdLayout<128>::DKV_BYTES, st, p)
               : launch_bwd(flash_dkv_f32_kernel<64>, grid, BwdLayout<64>::DKV_BYTES, st, p));
}
