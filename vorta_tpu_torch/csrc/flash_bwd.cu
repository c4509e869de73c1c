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
// kernels (~21 ms at 989 TFLOP/s bf16).  Design: every product runs on the
// tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate), and the
// accumulators never leave registers until the final store.
//   dq: one CUDA block per (b, h, 64 q rows of a q block); each warp keeps
//       its 16 rows' Q and dO fragments, lse and delta in registers for the
//       whole walk over the q block's kv list (the forward's tables), with K
//       and V staged in 32-row shared-memory sub-tiles.
//   dk/dv: one CUDA block per (b, h, 64 kv rows of a kv block) walks the
//       TRANSPOSED list of q blocks that visit its kv block (transpose_tables),
//       with Q, dO, lse and delta staged in 32-row sub-tiles; its K and V rows
//       stay in shared memory, each warp owning 16 kv rows and their dk and
//       dv accumulators.  Each output row has exactly one writer: no atomics,
//       and the result does not depend on the order blocks run in.  This is
//       the CUDA form of the TPU kernel's sequential "arbitrary" grid axis.
// Blocks of 32 rows (2 warps) serve tables whose blocks 64 does not divide
// (the 96-token STA tiles); 16 rows (1 warp) any other multiple of 16.  A
// block that is a multiple of 8 but not of 16 (the 360-token STA tiles of
// 720p training) takes ceil(block / rows) CUDA blocks per table block, as in
// the forward: rows past the table block (the 8-row half of its last busy
// warp, and any warp past its end) are staged as zeros, masked out of every
// product, and never stored.  Simple first: no wgmma, TMA or cp.async
// pipelining yet.
#include "mma_bf16.cuh"

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

}  // namespace

// q, dout, dq: contiguous (B, H, Sq, D) bf16; k, v: (B, H, Skv, D) bf16; lse,
// delta: (B, H, Sq) f32.  kv_index (1, Sq / block_q, width), kv_count
// (1, Sq / block_q): the forward's head-shared tables, int32 on the device.
extern "C" int vorta_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, const void* kv_index, const void* kv_count,
                                       int B, int H, int Sq, int Skv, int D, int width,
                                       int block_q, int block_kv, int kv_valid_len, float scale,
                                       void* stream) {
  Args a;
  if (!make_args(a, q, k, v, dout, lse, delta, B, H, Sq, Skv, D, block_q, block_kv,
                 kv_valid_len, scale, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* o = static_cast<__nv_bfloat16*>(dq);
  auto* ki = static_cast<const int*>(kv_index);
  auto* kc = static_cast<const int*>(kv_count);
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
                                        int kv_valid_len, float scale, void* stream) {
  Args a;
  if (!make_args(a, q, k, v, dout, lse, delta, B, H, Sq, Skv, D, block_q, block_kv,
                 kv_valid_len, scale, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* ok = static_cast<__nv_bfloat16*>(dk);
  auto* ov = static_cast<__nv_bfloat16*>(dv);
  auto* qi = static_cast<const int*>(q_index);
  auto* qc = static_cast<const int*>(q_count);
  return static_cast<int>(D == 128 ? dispatch_dkv<128>(a, ok, ov, qi, qc, width_t)
                                   : dispatch_dkv<64>(a, ok, ov, qi, qc, width_t));
}
