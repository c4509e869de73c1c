// The f32 flash backward of the port's f32 training path, for Hopper
// (sm_90a): dq and dk/dv with true f32 products on the CUDA cores (FFMA),
// beside the f32 forward core (csrc/attn_f32.cuh) whose thread grid, padded
// shared-memory rows and 64-row chunks it shares.  Included by
// csrc/flash_bwd.cu, whose C entries vorta_flash_bwd_dq_f32 and
// vorta_flash_bwd_dkv_f32 launch it.
//
// Replaces the f32 modes of vorta_tpu/ops/flash_bwd.py:_dq_kernel and
// :_dkv_kernel (the TPU kernels take their input dtype; the JAX trainer's
// --dtype fp32 runs them in f32).  Same function, over head-shared block
// tables: s2 = (q.k) * scale * log2(e) in f32 with the forward's tail rule
// (only block kv_valid_len // block_kv is cut, and only when block_kv does
// not divide kv_valid_len; flash_bwd.py:60-72), p = exp2(s2 - lse2) from the
// forward's base-2 row log-sum-exp (the sentinel 1e30 of a row that saw no
// key gives p = 0), dp = dO.V^T, ds = p (dp - delta):
//   dq = scale * sum_kv ds K,  dk = scale * sum_q ds^T Q,  dv = sum_q p^T dO
// In f32 the JAX kernels' casts of ds and p to the inputs' dtype change
// nothing (flash_bwd.py:106, :141, :150), so both stay f32 here.  A masked
// key (past the tail, past its block) gets p = 0 directly, which is what
// exp2(-1e30 - lse2) gives; kv rows past the tail therefore get exactly zero
// dk and dv, and a q block with no kv block (count 0) exactly zero dq.  Each
// output row has one writer: no atomics, no dependence on CTA order.
//
// Bound on this card: operations.  Per visible (q, kv) pair dq does 3
// products (S, dP, dS.K) and dk/dv 4 (S^T, dP^T, P^T.dO, dS^T.Q), 2 D FLOP
// each; a 64 x 64 tile pair reads 64 D floats of each operand per 2 x 64 x
// 64 x D FLOP, far above the f32 ridge of 20 FLOP a byte, so the FFMA rate
// (67 TFLOP/s) bounds both.  The design, per kernel:
//
// - dq (flash_dq_f32_kernel): a CTA of 256 threads owns 64 q rows of one
//   table q block (ceil(block_q / 64) CTAs a block; rows past the block are
//   staged as zeros with lse 1e30 and never stored).  Q, dO, lse and delta
//   are staged once in shared memory.  It walks its q block's kv list in
//   64-key chunks (ceil(block_kv / 64) a kv block; a chunk the tail rule
//   masks whole is skipped).  Per chunk, K and V come into shared memory by
//   16-byte loads; thread (ty, tx) of the 16 x 16 grid computes S and dP for
//   rows ty + 16 i and keys tx + 16 j (float4 reads along D, rows padded by
//   4 floats), then p and ds in registers; ds goes to shared memory over V
//   (consumed), and the thread's 4 rows x D / 16 columns take dQ += ds K
//   from float4 reads of ds and K.  4 tiles of 64 x (D + 4) floats: 135 KB
//   at D = 128 (one CTA an SM), 70 KB at D = 64.
// - dk/dv (flash_dkv_f32_kernel): a CTA owns 64 kv rows of one table kv
//   block, K and V staged once, the dK and dV sums in registers (4 rows x D
//   / 16 columns a thread each).  It walks the transposed list (q_index,
//   q_count) in 64-row q chunks, staging Q, dO, lse and delta; S^T and dP^T
//   for kv rows ty + 16 i and q rows tx + 16 j, p^T and ds^T into two 64 x
//   68 tiles, then dV += p^T dO and dK += ds^T Q.  170 KB at D = 128 (one
//   CTA an SM), 105 KB at D = 64.
//
// At head dim 128 (every call of the 1.3B trainer: FULL, LOWRES, cross and
// the STA tiles) the wrapper's rule (ops/flash.py:flash_f32_tc_path) runs
// csrc/attn_f32_tc_bwd.cuh's tensor-core kernels (3xTF32 on wgmma) instead;
// these FFMA kernels keep head dim 64 (the tiny models) and the yardstick.
#pragma once

#include "attn_f32.cuh"

namespace vorta {
namespace f32 {

struct BwdParams {
  const float *q, *k, *v, *dout, *lse, *delta;  // (B, H, S, D) / (B, H, Sq)
  float *dq, *dk, *dv;                          // the kernel's outputs (the other's: null)
  const int *index, *count;  // dq: kv_index / kv_count; dk/dv: q_index / q_count
  int H, Sq, Skv, width, block_q, block_kv;
  int last_block, valid_in_block;  // the tail rule (last_block -1: nothing is cut)
  float scale_log2, scale;
};

template <int D>
struct BwdLayout {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int LDQ = D + 4;   // Q, dO, K, V tile rows (floats)
  static constexpr int LDP = BK + 4;  // p / ds tile rows
  static constexpr int TILE = 64 * LDQ;
  static constexpr int PTILE = 64 * LDP;
  // dq: Q, dO, K, V (ds over V), then lse and delta of the 64 q rows
  static constexpr int DQ_BYTES = (4 * TILE + 2 * BQ) * 4;
  // dk/dv: K, V, Q, dO, p^T, ds^T, then lse and delta of the q chunk
  static constexpr int DKV_BYTES = (4 * TILE + 2 * PTILE + 2 * BQ) * 4;
  static_assert(BQ == 64 && BK == 64, "64-row tiles");
  static_assert(PTILE <= TILE, "ds fits over V");
  static_assert(DKV_BYTES <= 232448, "shared memory of one H100 block");
};

// Rows [0, rows) of a (.., D) f32 tensor from src into a 64-row tile (row
// stride LDQ), zeros past them; 16-byte loads, every thread.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int rows) {
  constexpr int LDQ = BwdLayout<D>::LDQ;
  for (int e = threadIdx.x; e < 64 * D / 4; e += THREADS) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const float4 x = r < rows ? ld4(src + static_cast<long long>(r) * D + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * LDQ + c) = x;
  }
}

// a[i][j] = A[ty + 16 i] . B[tx + 16 j] over D, for two pairs of tiles at
// once (rows of LDQ floats): the score products of both kernels.
template <int D>
__device__ __forceinline__ void dots2(float (&a)[4][4], float (&b)[4][4], const float* A1,
                                      const float* B1, const float* A2, const float* B2,
                                      int ty, int tx) {
  constexpr int LDQ = BwdLayout<D>::LDQ;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = b[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x1[4], x2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x1[i] = *reinterpret_cast<const float4*>(A1 + (ty + 16 * i) * LDQ + d);
      x2[i] = *reinterpret_cast<const float4*>(A2 + (ty + 16 * i) * LDQ + d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 y1 = *reinterpret_cast<const float4*>(B1 + (tx + 16 * j) * LDQ + d);
      const float4 y2 = *reinterpret_cast<const float4*>(B2 + (tx + 16 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = a[i][j], t = b[i][j];
        s = fmaf(x1[i].x, y1.x, s);
        s = fmaf(x1[i].y, y1.y, s);
        s = fmaf(x1[i].z, y1.z, s);
        s = fmaf(x1[i].w, y1.w, s);
        t = fmaf(x2[i].x, y2.x, t);
        t = fmaf(x2[i].y, y2.y, t);
        t = fmaf(x2[i].z, y2.z, t);
        t = fmaf(x2[i].w, y2.w, t);
        a[i][j] = s;
        b[i][j] = t;
      }
    }
  }
}

// acc[i][4 g + c] += sum_k P[ty + 16 i][k] * X[k][64 g + 4 tx + c] over the
// 64 rows k of X (P rows of LDP floats, X rows of LDQ): this thread's 4 rows
// x D / 16 columns of a (64 x 64) x (64 x D) product.
template <int D>
__device__ __forceinline__ void pv(float (&acc)[4][D / 16], const float* P, const float* X,
                                   int ty, int tx) {
  constexpr int NG = D / 64, LDQ = BwdLayout<D>::LDQ, LDP = BwdLayout<D>::LDP;
#pragma unroll 2
  for (int kk = 0; kk < 64; kk += 4) {
    float4 pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pr[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * LDP + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 xv[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g)
        xv[g] = *reinterpret_cast<const float4*>(X + (kk + u) * LDQ + g * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = u == 0 ? pr[i].x : u == 1 ? pr[i].y : u == 2 ? pr[i].z : pr[i].w;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          acc[i][4 * g + 0] = fmaf(p, xv[g].x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(p, xv[g].y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p, xv[g].z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p, xv[g].w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// Rows ty + 16 i < rows of acc * mul into dst (row stride D), columns 64 g + 4 tx.
template <int D>
__device__ __forceinline__ void store(float* __restrict__ dst, const float (&acc)[4][D / 16],
                                      float mul, int rows, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      *reinterpret_cast<float4*>(dst + static_cast<long long>(r) * D + g * 64 + tx * 4) =
          make_float4(acc[i][4 * g] * mul, acc[i][4 * g + 1] * mul, acc[i][4 * g + 2] * mul,
                      acc[i][4 * g + 3] * mul);
  }
}

// Valid keys of a 64-key chunk starting at column col0 of kv block kvb under
// the tail rule (<= 0: the chunk is masked whole).
__device__ __forceinline__ int chunk_keys(const BwdParams& p, int kvb, int col0) {
  const int limit = kvb == p.last_block ? p.valid_in_block : p.block_kv;
  return min(BK, limit - col0);
}

// Grid (nq * ceil(block_q / 64), H, B).
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
flash_dq_f32_kernel(const __grid_constant__ BwdParams p) {
  using L = BwdLayout<D>;
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* Os = Qs + L::TILE;
  float* Ks = Os + L::TILE;
  float* Vs = Ks + L::TILE;
  float* Ds = Vs;  // ds over V, once dP is computed
  float* lse_s = Vs + L::TILE;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int parts = (p.block_q + BQ - 1) / BQ;
  const int qi = blockIdx.x / parts, part = blockIdx.x % parts;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const long long row0 = bh * p.Sq + static_cast<long long>(qi) * p.block_q + part * BQ;
  const int nrows = min(BQ, p.block_q - part * BQ);
  const long long kv0 = bh * p.Skv;

  stage<D>(Qs, p.q + row0 * D, nrows);
  stage<D>(Os, p.dout + row0 * D, nrows);
  for (int r = tid; r < BQ; r += THREADS) {
    // rows past the block: p = 0 through the sentinel, never stored
    lse_s[r] = r < nrows ? p.lse[row0 + r] : 1e30f;
    dl_s[r] = r < nrows ? p.delta[row0 + r] : 0.f;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  const int spb = (p.block_kv + BK - 1) / BK;
  const int count = p.count[qi];
  const int* idx = p.index + static_cast<long long>(qi) * p.width;
  for (int c = 0; c < count * spb; ++c) {
    const int kvb = idx[c / spb], col0 = (c % spb) * BK;
    const int nkeys = chunk_keys(p, kvb, col0);
    if (nkeys <= 0) continue;  // masked whole: adds nothing (uniform over the CTA)
    const long long krow = kv0 + static_cast<long long>(kvb) * p.block_kv + col0;
    __syncthreads();  // the previous chunk's K and ds are consumed (and Q, dO staged)
    stage<D>(Ks, p.k + krow * D, nkeys);
    stage<D>(Vs, p.v + krow * D, nkeys);
    __syncthreads();

    float s[4][4], dp[4][4];
    dots2<D>(s, dp, Qs, Ks, Os, Vs, ty, tx);  // S = Q K^T, dP = dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = tx + 16 * j < nkeys ? exp2f(s[i][j] * p.scale_log2 - lse_s[r]) : 0.f;
        s[i][j] = pr * (dp[i][j] - dl_s[r]);  // ds
      }
    }
    __syncthreads();  // every thread is done with V: ds goes over it
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ds[(ty + 16 * i) * L::LDP + tx + 16 * j] = s[i][j];
    __syncthreads();
    pv<D>(acc, Ds, Ks, ty, tx);  // dQ += ds K
  }
  store<D>(p.dq + row0 * D, acc, p.scale, nrows, ty, tx);
}

// Grid (nkv * ceil(block_kv / 64), H, B).
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
flash_dkv_f32_kernel(const __grid_constant__ BwdParams p) {
  using L = BwdLayout<D>;
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;
  float* Vs = Ks + L::TILE;
  float* Qs = Vs + L::TILE;
  float* Os = Qs + L::TILE;
  float* Ps = Os + L::TILE;  // p^T (kv rows x q rows)
  float* Ss = Ps + L::PTILE;  // ds^T
  float* lse_s = Ss + L::PTILE;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int parts = (p.block_kv + BK - 1) / BK;
  const int kvb = blockIdx.x / parts, part = blockIdx.x % parts;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const long long row0 = bh * p.Skv + static_cast<long long>(kvb) * p.block_kv + part * BK;
  const int nrows = min(BK, p.block_kv - part * BK);
  // kv rows the tail rule leaves visible (the rest get p = 0: zero dk, dv)
  const int nvis = max(0, chunk_keys(p, kvb, part * BK));
  const long long q0 = bh * p.Sq;

  stage<D>(Ks, p.k + row0 * D, nrows);
  stage<D>(Vs, p.v + row0 * D, nrows);

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int spb = (p.block_q + BQ - 1) / BQ;
  const int count = nvis > 0 ? p.count[kvb] : 0;
  const int* idx = p.index + static_cast<long long>(kvb) * p.width;
  for (int c = 0; c < count * spb; ++c) {
    const int m0 = (c % spb) * BQ, rows = min(BQ, p.block_q - m0);
    const long long qrow = q0 + static_cast<long long>(idx[c / spb]) * p.block_q + m0;
    __syncthreads();  // the previous chunk's Q, dO, p^T and ds^T are consumed
    stage<D>(Qs, p.q + qrow * D, rows);
    stage<D>(Os, p.dout + qrow * D, rows);
    for (int r = tid; r < BQ; r += THREADS) {
      lse_s[r] = r < rows ? p.lse[qrow + r] : 1e30f;
      dl_s[r] = r < rows ? p.delta[qrow + r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    dots2<D>(s, dp, Ks, Qs, Vs, Os, ty, tx);  // S^T = K Q^T, dP^T = V dO^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool vis = ty + 16 * i < nvis;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;  // q row of the chunk
        const float pr = vis ? exp2f(s[i][j] * p.scale_log2 - lse_s[col]) : 0.f;
        Ps[(ty + 16 * i) * L::LDP + col] = pr;
        Ss[(ty + 16 * i) * L::LDP + col] = pr * (dp[i][j] - dl_s[col]);
      }
    }
    __syncthreads();
    pv<D>(dv, Ps, Os, ty, tx);  // dV += p^T dO
    pv<D>(dk, Ss, Qs, ty, tx);  // dK += ds^T Q
  }
  store<D>(p.dk + row0 * D, dk, p.scale, nrows, ty, tx);
  store<D>(p.dv + row0 * D, dv, 1.f, nrows, ty, tx);
}

// Launch kern<<<grid, THREADS, bytes>>>(p), raising the kernel's dynamic
// shared memory limit first; the CUDA error code.
template <class Kern>
cudaError_t launch_bwd(Kern kern, dim3 grid, int bytes, cudaStream_t st, const BwdParams& p) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace f32
}  // namespace vorta
