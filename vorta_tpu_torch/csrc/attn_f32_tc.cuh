// The f32 attention core on the tensor cores (sm_90a): the block-table walk
// of flash and flash_manual at f32 q / k / v with every product split into
// three TF32 products (3xTF32) on wgmma, in place of csrc/attn_f32.cuh's
// FFMA core at head dim 128: flash's f32 mode with q and kv blocks that are
// multiples of 8 (ops/flash.py:flash_f32_tc_path, the rule of the backward
// too: FULL, LOWRES, cross and the STA training tiles of 96, 360 and 24
// tokens), flash_manual's f32 mode with blocks that are multiples of 128
// (ops/flash.py:f32_tc_path).  The same rules on both sides.
//
// Users: csrc/flash.cu (flash_f32_tc_kernel: the stable online softmax, the
// lse of the f32 training forward), csrc/flash_manual.cu
// (flash_manual_f32_tc_kernel: the stable or the fast softmax, kv_bias) and
// csrc/window_walk_f32_tc.cuh (the window walks of sta_pipe's and
// sta_window's f32 modes: this file's products, barriers and consumer step,
// consume_chunk, over its own walk and layout).  The first two replace the
// f32 modes of vorta_tpu/ops/flash.py:_flash_kernel and
// flash_manual.py:_kernel.  Semantics are csrc/attn_f32.cuh's (its header,
// "Semantics"): the tail rule cuts block last_block at valid_in_block; s =
// q.k * mul + bias (mul = scale * log2(e), or 1 where the wrapper pre-scaled
// q in f32 for the fast softmax), a masked key -1e30; the stable softmax
// with m_safe, the fast one exp2(s); a row with l = 0 (a count-0 q block, a
// routed-away head) writes 0 and, with an lse pointer, the sentinel 1e30,
// else m + log2(l).
//
// 3xTF32.  Each f32 operand x is split into big = tf32(x) (round to nearest,
// away from zero on ties: cvt.rna) and small = tf32(x - big); x - big is
// exact in f32, so big + small holds x to ~22 bits.  S = Qs Kb + Qb Ks + Qb
// Kb and O += Ps Vb + Pb Vs + Pb Vb, small products first into the f32
// accumulator (CUTLASS's order for 3xTF32), on wgmma m64nNk8 .tf32.  Both
// halves are staged explicitly, with their low 13 bits zero: nothing rests
// on what the tensor core does with an f32 word's low bits.  A single TF32
// product is not an f32 mode: it fails the 1e-4 gate (chip_smoke.py holds
// the gate against q, k, v rounded once to TF32).
//
// Bound on this card: operations.  A 64-row q tile against a 64-key chunk is
// 2 * 64 * 64 * 128 FLOP for S and as many for PV, 3 TF32 products each; at
// 495 TFLOP/s TF32 that is 165 TFLOP/s of f32-exact products (against 67 on
// the CUDA cores).  The design:
//
// - A split pre-pass (f32_tc_split_rows_kernel, f32_tc_split_t_kernel)
//   writes each element's halves once per call into the caller's scratch:
//   q's and k's rows (big rows, then small rows) and V^T's (V transposed,
//   its keys permuted as below; the tail rule's cut keys stored as 0, so
//   that no masked key's value meets a P of 0 as a NaN).  Inside the
//   attention kernel the split would be redone for every q tile that reads a
//   chunk, hundreds of times an element at FULL.
// - CTA: 64 q rows of one (batch, head), 160 threads.  Warpgroup 0 consumes:
//   it issues the products and runs the softmax with S and O in registers.
//   One producer warp's first thread issues every copy: TMA boxes of 32 f32
//   (one 128-byte swizzled line) from maps over the halves.
// - Shared memory: six 32 KB tiles, Qb Qs Kb Ks (64 rows x 128 f32, K-major:
//   four 128-byte swizzled boxes of 32 columns) and Vb^T Vs^T (128 rows of
//   V's columns x 64 keys: two boxes of 32 keys), 193 KB: one CTA an SM.
//   For tf32 both wgmma operands must be K-major, so V, which the PV product
//   reduces over its keys, is read transposed.
// - P stays in registers.  The A fragment of a tf32 k step pairs keys t and
//   t + 4 of 8 where the S accumulator holds keys 2t and 2t + 1, so V^T's
//   keys are stored permuted within each group of 8 (key 2c at column c, key
//   2c + 1 at column c + 4): S's registers are P's fragments unmoved.
// - Hand-off: mbarriers, one stage each of K and V with full / empty
//   barriers (TMA's complete_tx, one arrival per consumer warp): K(c + 1)
//   lands while the consumer runs chunk c's softmax and PV product, V(c + 1)
//   while it runs chunk c + 1's QK product.
// - Accumulation: S is fresh per chunk (small products first); each chunk's
//   PV product lands in a fresh accumulator and joins O by an FMA on the
//   CUDA cores, because the tensor core's accumulation truncates: over a
//   row's hundreds of chunks its one-sided errors would add up, growing with
//   the row's length, past the 1e-4 gate at FULL's 31,200 keys.
// - Masked keys: a chunk past the tail rule's limit is skipped, a cut
//   chunk's columns past nvalid are -1e30 in S (p = 0, by select).  A CTA
//   with nothing to attend writes zeros (and the lse sentinel) before any
//   barrier.
// - Blocks that 64 does not divide (flash's rule only; the STA tiles: 96 =
//   64 + 32, 360 = 5 x 64 + 40, 24), as in the backward: a q block takes
//   ceil(block_q / 64) CTAs, the last one's 64-row tile running past its
//   block into the next block's rows (or past the tensor: TMA's zeros).
//   Rows do not mix, so those rows are computed and never stored, neither
//   out nor lse, the count-0 exit included: each row has the one CTA of its
//   own block as its writer.  A kv block is walked in 64-key chunks, the
//   last one partial (nvalid, as the tail rule's cut chunk); its columns
//   past the block hold the next block's keys or TMA's zeros, masked.  The
//   row guards run once a CTA, outside the chunk loop, so every shape takes
//   the one kernel.  A partial tile or chunk costs a whole one's products.
//
// The window walks of sta_pipe's and sta_window's f32 modes at head dim 128
// run these pieces over q, k and V^T gathered into tile-major order
// (csrc/window_walk_f32_tc.cuh).  What stays on csrc/attn_f32.cuh's FFMA
// core (the wrappers' rules): head dim 64 (the tiny models), flash_manual's
// f32 mode at blocks that 128 does not divide (no full-width caller: the
// tiny models' blocks of 8 / 16), sta_batched's pair-bit walk, sta_row's
// f32 window walk and sta_pipe's int8 QK mode with an f32 v.
// flash_manual's int8 QK mode at its rule's shapes runs
// csrc/attn_int8_tc.cuh (wgmma s8 scores, this file's 3xTF32 PV).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "attn_f32.cuh"
#include "attn_sm90.cuh"

namespace vorta {
namespace f32tc {

constexpr int D = 128;           // head dim
constexpr int BQ = 64;           // q rows per CTA
constexpr int BK = 64;           // keys per chunk
constexpr int THREADS = 160;     // a consumer warpgroup and a producer warp
constexpr int TILE = BQ * D * 4; // bytes of each of the six tiles
constexpr int QB = 0, QS = TILE, KB = 2 * TILE, KS = 3 * TILE, VB = 4 * TILE, VS = 5 * TILE;
constexpr int BAR = 6 * TILE;    // q_full, k_full, k_empty, v_full, v_empty
constexpr int SMEM_BYTES = BAR + 5 * 8 + 1024;  // + slack to align the base to 1,024 B
constexpr float NEG = -1e30f;
static_assert(SMEM_BYTES <= 232448, "shared memory of one H100 block");
static_assert(BK * D * 4 == TILE, "V^T's tile is a Q / K tile's size");

// tf32(x): round to nearest (ties away), low 13 bits zero
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// Byte offset of 16-byte chunk c (0..31: columns 4c..4c+3) of row r in a
// K-major tile of `rows` rows x 128 f32: four boxes of 32 columns, 128-byte
// lines, the chunk index XORed with r % 8 (the 128-byte swizzle).
__device__ __forceinline__ uint32_t kmajor_off(int rows, int r, int c) {
  return (c / 8) * rows * 128 + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// Shared-memory descriptor of k step kk (8 tf32 columns: 32 bytes) of a
// K-major tile of `rows` rows at base (1,024-byte aligned).
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int rows, int kk) {
  return sm90::desc_sw128(base + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}

// D (+)= A B^T, m64n64k8 tf32, A and B from shared memory (K-major both)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (+)= A B^T, m64n128k8 tf32, A (four tf32 words) from registers, B from
// shared memory (K-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// S = Qs Kb + Qb Ks + Qb Kb for the warpgroup's 64 rows against a 64-key
// chunk (issued and waited).  base: the aligned shared-memory base.
__device__ __forceinline__ void qk_product(float (&s)[32], uint32_t base) {
  sm90::fence_regs(s);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_ss_n64(s, kdesc(base + QS, BQ, kk), kdesc(base + KB, BK, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_ss_n64(s, kdesc(base + QB, BQ, kk), kdesc(base + KS, BK, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_ss_n64(s, kdesc(base + QB, BQ, kk), kdesc(base + KB, BK, kk), 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
}

// P's halves from the S accumulator (pb, ps: tf32 words in S's order).
__device__ __forceinline__ void split_p(const float (&p)[32], uint32_t (&pb)[32],
                                        uint32_t (&ps)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) split(p[i], pb[i], ps[i]);
}

// O = Ps Vb + Pb Vs + Pb Vb, one chunk's product in a fresh accumulator
// (issued and waited), Vb^T and Vs^T at vb and vs (128 rows x 64 keys each,
// K-major).  K step kk is the S accumulator's columns 8kk..8kk+7: registers
// 4kk + {0, 2, 1, 3} are the A fragment (rows g, g + 8 at keys 2t, then at
// 2t + 1), which V^T's permuted key columns match.
__device__ __forceinline__ void pv_product(float (&o)[64], uint32_t (&pb)[32], uint32_t (&ps)[32],
                                           uint32_t vb, uint32_t vs) {
  sm90::fence_regs(o);
  sm90::fence_regs(pb);
  sm90::fence_regs(ps);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    wgmma_rs_n128(o, ps[4 * kk], ps[4 * kk + 2], ps[4 * kk + 1], ps[4 * kk + 3],
                  kdesc(vb, D, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    wgmma_rs_n128(o, pb[4 * kk], pb[4 * kk + 2], pb[4 * kk + 1], pb[4 * kk + 3],
                  kdesc(vs, D, kk), 1);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    wgmma_rs_n128(o, pb[4 * kk], pb[4 * kk + 2], pb[4 * kk + 1], pb[4 * kk + 3],
                  kdesc(vb, D, kk), 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  sm90::fence_regs(pb);
  sm90::fence_regs(ps);
}

// The chunks of a CTA: for j < count, kv block idx[j] in C-key chunks up to
// the tail rule's limit (a chunk the rule masks completely is skipped): 64
// keys in the forward, 32 in the backward's dq (csrc/attn_f32_tc_bwd.cuh).
template <int C = BK>
struct ChunkWalk {
  const int* idx;
  int count, block_kv, last_block, valid_in_block;
  int j = 0, n0 = 0, kvb = 0, limit = 0;

  __device__ __forceinline__ bool next(int& key0, int& nvalid) {
    while (j < count) {
      if (n0 == 0) {
        kvb = idx[j];
        limit = (kvb == last_block) ? valid_in_block : block_kv;
      }
      if (n0 < limit) {
        key0 = kvb * block_kv + n0;
        nvalid = min(C, limit - n0);
        n0 += C;
        return true;
      }
      ++j;
      n0 = 0;
    }
    return false;
  }
};

// ---- the split pre-pass --------------------------------------------------------

// Rows of x (n4 float4s) split into their big and small halves: out[0:n4]
// big, out[n4:2 n4] small, tf32 words in f32 rows (the rows of a Q or K map).
__global__ void __launch_bounds__(256) f32_tc_split_rows_kernel(const float4* __restrict__ x,
                                                                uint4* __restrict__ out,
                                                                long long n4) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4; i += gridDim.x * 256LL) {
    const float4 v = __ldg(x + i);
    uint4 b, sm;
    split(v.x, b.x, sm.x);
    split(v.y, b.y, sm.y);
    split(v.z, b.z, sm.z);
    split(v.w, b.w, sm.w);
    out[i] = b;
    out[n4 + i] = sm;
  }
}

// The second half of a transposing split: 64 rows (keys key0..) of one (b,
// h) staged in tile[row][d] (a CTA of 256 threads, after a barrier) stored
// split and transposed, out[half][bh][d][p] with half 0 at out and half 1
// at out + half, p = 8 (j / 8) + (j % 2 ? 4 : 0) + (j % 8) / 2 for row j
// (the order below); rows at or past S are not stored.
__device__ __forceinline__ void split_t_store(const float (&tile)[BK][D + 1],
                                              uint32_t* __restrict__ out, long long half, int bh,
                                              int S, int key0) {
  for (int e = threadIdx.x; e < D * BK; e += 256) {
    const int d = e / BK, col = e % BK, c = col % 8;
    if (key0 + col >= S) continue;
    const int j = 8 * (col / 8) + (c < 4 ? 2 * c : 2 * (c - 4) + 1);
    uint32_t b, sm;
    split(tile[j][d], b, sm);
    const long long o = (static_cast<long long>(bh) * D + d) * S + key0 + col;
    out[o] = b;
    out[half + o] = sm;
  }
}

// Rows of x (B*H, S, D) split and transposed: out[half][bh][d][p], half 0
// big, 1 small, where row j of each group of 8 sits at column p = 8 (j / 8)
// + (j % 2 ? 4 : 0) + (j % 8) / 2 (an accumulator's fragment order, above).
// Rows of block last_block at or past valid_in_block (the tail rule's cut
// keys; last_block -1: none) are stored as 0.  The forward's V^T; the
// backward's K^T (keys cut as V^T's), Q^T and dO^T (nothing cut).  A CTA
// transposes 64 rows of one (b, h) through shared memory; S is a multiple of
// 8, the last CTA's rows past S are neither read nor written.
__global__ void __launch_bounds__(256) f32_tc_split_t_kernel(const float* __restrict__ x,
                                                             uint32_t* __restrict__ out, int BH,
                                                             int S, int block, int last_block,
                                                             int valid_in_block) {
  __shared__ float tile[BK][D + 1];
  const int key0 = blockIdx.x * BK, bh = blockIdx.y, tid = threadIdx.x;
  const float* rows = x + (static_cast<long long>(bh) * S + key0) * D;
  for (int e = tid; e < BK * D / 4; e += 256) {
    const int j = e / (D / 4), c = (e % (D / 4)) * 4;
    const int key = key0 + j;
    const bool cut = key >= S || (key / block == last_block && key % block >= valid_in_block);
    const float4 x = cut ? make_float4(0.f, 0.f, 0.f, 0.f)
                         : __ldg(reinterpret_cast<const float4*>(rows + j * D + c));
    tile[j][c] = x.x;
    tile[j][c + 1] = x.y;
    tile[j][c + 2] = x.z;
    tile[j][c + 3] = x.w;
  }
  __syncthreads();
  split_t_store(tile, out, static_cast<long long>(BH) * D * S, bh, S, key0);
}

// ---- the attention kernel --------------------------------------------------------

// The CTA's barriers at base + BAR: q_full, k_full, k_empty, v_full, v_empty
// (one stage each of K and V; an empty barrier takes one arrival per
// consumer warp).  Thread 0 initialises them; every thread syncs.
__device__ __forceinline__ void init_barriers(uint32_t base) {
  if (threadIdx.x == 0) {
    sm90::mbar_init(base + BAR, 1);
    sm90::mbar_init(base + BAR + 8, 1);
    sm90::mbar_init(base + BAR + 16, 4);
    sm90::mbar_init(base + BAR + 24, 1);
    sm90::mbar_init(base + BAR + 32, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The consumer's step over one 64-key chunk, the walks' common body: waits
// for K(c), S = Q K^T (small products first), releases K; masks the columns
// where on(col) is false (-1e30), else s * mul + bias (bias[i]: column 8 (i
// / 2) + 2t + i % 2); the stable online softmax (running max m, sum l) or
// the fast exp2(s); P's halves; waits for V(c), the chunk's PV product in a
// fresh accumulator, releases V, and joins it to O by FMA.
template <class On>
__device__ __forceinline__ void consume_chunk(float (&o)[64], float (&m)[2], float (&l)[2],
                                              const float (&bias)[16], On on, uint32_t base,
                                              uint32_t phase, float mul, bool stable) {
  using namespace sm90;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const uint32_t k_full = base + BAR + 8, k_empty = base + BAR + 16, v_full = base + BAR + 24,
                 v_empty = base + BAR + 32;
  auto release = [&](uint32_t bar) {  // every warp, once its last reader is done
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float s[32];
  uint32_t pb[32], ps[32];
  mbar_wait(k_full, phase);
  qk_product(s, base);
  release(k_empty);
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * (i / 4) + 2 * t + (i & 1);
    const float x = on(col) ? fmaf(s[i], mul, bias[2 * (i / 4) + (i & 1)]) : NEG;
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float ms[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
  if (stable) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = m[hr] <= NEG ? 0.f : exp2f(m[hr] - m_new);  // l and o are 0 until then
      m[hr] = m_new;
      ms[hr] = m_new <= NEG ? 0.f : m_new;
    }
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = exp2f(s[i] - ms[(i >> 1) & 1]);  // exp2(-1e30 - ms) = 0
    psum[(i >> 1) & 1] += s[i];
  }
  l[0] = l[0] * alpha[0] + psum[0];
  l[1] = l[1] * alpha[1] + psum[1];
  split_p(s, pb, ps);
  mbar_wait(v_full, phase);
  float oc[64];
  pv_product(oc, pb, ps, base + VB, base + VS);
  release(v_empty);
  // the chunk's product joins O in the CUDA cores' rounding to nearest (see
  // "Accumulation" above)
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], oc[i]);
}

// The kernel body: CTA (blockIdx.x = q block * parts + part, h, b), parts =
// ceil(block_q / 64), over TableParams p (the tables, kv_bias (Skv,) or
// null, the tail rule; p.k and p.v unused: the halves come by TMA) with tq /
// tk over the q / k halves (2 B H S, 128) f32 (big rows, then small rows) in
// boxes of 32 columns x 64 rows and tv over V^T's halves (2 B H 128, Skv) in
// boxes of 32 keys x 128 rows, all with the 128-byte swizzle.  out: (B, H,
// Sq, 128) f32; lse: (B, H, Sq) f32 or null (stable only).  mul: the
// scores' factor; stable: the online softmax, else exp2(s).  Where 64 does
// not divide block_q, the last CTA of a block owns fewer than 64 rows (the
// rest never stored).
__device__ __forceinline__ void attend(const CUtensorMap& tq, const CUtensorMap& tk,
                                       const CUtensorMap& tv, const f32::TableParams& p,
                                       float* __restrict__ out, float* __restrict__ lse,
                                       float mul, bool stable) {
  using namespace sm90;
  const int parts = (p.block_q + BQ - 1) / BQ;
  const int qi = blockIdx.x / parts, h = blockIdx.y, local0 = (blockIdx.x % parts) * BQ;
  const int rows = min(BQ, p.block_q - local0);  // its rows of the q block
  const long long bh = static_cast<long long>(blockIdx.z) * p.H + h;
  const long long row0 = bh * p.Sq + static_cast<long long>(qi) * p.block_q +
                         local0;  // the CTA's first row of (B*H*Sq)
  const int count = p.kv_count[(p.cnt_shared ? 0 : h) * p.nq + qi];
  const int tid = threadIdx.x;
  if (count == 0) {  // routed away or past the table: zeros, no barrier touched
    float4* o4 = reinterpret_cast<float4*>(out + row0 * D);
    for (int e = tid; e < rows * D / 4; e += THREADS) o4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lse != nullptr && tid < rows) lse[row0 + tid] = 1e30f;
    return;
  }
  ChunkWalk<> walk{p.kv_index + static_cast<long long>((p.idx_shared ? 0 : h) * p.nq + qi) * p.width,
                 count, p.block_kv, p.last_block, p.valid_in_block};

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_full = base + BAR, k_full = q_full + 8, k_empty = q_full + 16,
                 v_full = q_full + 24, v_empty = q_full + 32;
  init_barriers(base);
  int key0, nvalid;

  if (tid >= 128) {
    // ---- producer: one thread issues every copy ------------------------------------
    if (tid != 128) return;
    const int qrows = gridDim.z * p.H * p.Sq, krows = gridDim.z * p.H * p.Skv;
    const int vrows = gridDim.z * p.H * D, vrow = static_cast<int>(bh) * D;
    mbar_expect_tx(q_full, 2 * TILE);
    for (int half = 0; half < 2; ++half)
      for (int b = 0; b < 4; ++b)
        tma_load(base + (half ? QS : QB) + b * BQ * 128, &tq, q_full, 32 * b,
                 half * qrows + static_cast<int>(row0));
    for (uint32_t phase = 1; walk.next(key0, nvalid); phase ^= 1) {
      const int krow = static_cast<int>(bh * p.Skv) + key0;
      mbar_wait(k_empty, phase);  // a fresh barrier passes parity 1
      mbar_expect_tx(k_full, 2 * TILE);
      for (int half = 0; half < 2; ++half)
        for (int b = 0; b < 4; ++b)
          tma_load(base + (half ? KS : KB) + b * BK * 128, &tk, k_full, 32 * b,
                   half * krows + krow);
      mbar_wait(v_empty, phase);
      mbar_expect_tx(v_full, 2 * TILE);
      for (int half = 0; half < 2; ++half)
        for (int b = 0; b < 2; ++b)
          tma_load(base + (half ? VS : VB) + b * D * 128, &tv, v_full, key0 + 32 * b,
                   half * vrows + vrow);
    }
    return;
  }

  // ---- consumer: 64 rows, S and O in registers ------------------------------------
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);
  for (uint32_t phase = 0; walk.next(key0, nvalid); phase ^= 1) {
    float bias[16];  // columns 8n + 2t + e of this chunk (n = i / 2, e = i % 2)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      bias[i] = p.kv_bias != nullptr ? __ldg(p.kv_bias + key0 + 8 * (i / 2) + 2 * t + i % 2) : 0.f;
    consume_chunk(o, m, l, bias, [&](int col) { return col < nvalid; }, base, phase, mul,
                  stable);
  }

  // ---- epilogue: rows 16w + g (+ 8), those of the CTA's block ----------------------
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float x = quad_sum(l[hr]);
    if (16 * w + g + 8 * hr >= rows) continue;
    const float inv = x == 0.f ? 0.f : 1.f / x;
    const long long r = row0 + 16 * w + g + 8 * hr;
    if (lse != nullptr && t == 0) lse[r] = x == 0.f ? 1e30f : m[hr] + log2f(x);
    float* orow = out + r * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[4 * n + 2 * hr] * inv, o[4 * n + 2 * hr + 1] * inv);
  }
}

// ---- host side ---------------------------------------------------------------------

// flash_manual's shape rule (ops/flash.py:f32_tc_path; its int8 QK mode's
// too): head dim 128, blocks multiples of 128.
inline bool path_holds(int D_, int block_q, int block_kv) {
  return D_ == D && block_q % 128 == 0 && block_kv % 128 == 0;
}

// flash's shape rule, forward and backward (ops/flash.py:flash_f32_tc_path):
// head dim 128, blocks multiples of 8.
inline bool flash_path_holds(int D_, int block_q, int block_kv) {
  return D_ == D && block_q % 8 == 0 && block_kv % 8 == 0;
}

// A map over `rows` rows of `cols` f32 (row stride cols) in boxes of 32
// columns x box_rows rows, 128-byte swizzle.
inline bool make_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
                     uint32_t box_rows) {
  auto fn = sm90::encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {cols, rows};
  cuuint64_t strides[1] = {cols * 4};
  cuuint32_t box[2] = {32u, box_rows};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Split q, k, v into work (2 B H (Sq + 2 Skv) 128 f32, 16-byte aligned: q's
// halves, k's, V^T's), then launch kern<<<(nq * ceil(block_q / 64), H, B),
// THREADS, SMEM_BYTES>>>(tq, tk, tv, args...).  q, k, v: contiguous (B, H,
// S, 128) f32, 16-byte aligned.  holds: the caller's rule (flash_path_holds
// or path_holds).  The CUDA error code.
template <class Kern, class... Args>
cudaError_t launch(bool (*holds)(int, int, int), Kern kern, const void* q, const void* k,
                   const void* v, void* work, int B, const f32::TableParams& p, cudaStream_t st,
                   Args... args) {
  if (!holds(p.D, p.block_q, p.block_kv) || p.kb != 4 || work == nullptr)
    return cudaErrorInvalidValue;
  const long long qn = static_cast<long long>(B) * p.H * p.Sq * D;
  const long long kn = static_cast<long long>(B) * p.H * p.Skv * D;
  float* wq = static_cast<float*>(work);
  float* wk = wq + 2 * qn;
  float* wv = wk + 2 * kn;
  auto blocks = [](long long n4) { return static_cast<int>(std::min(n4 / 256 + 1, 8192LL)); };
  f32_tc_split_rows_kernel<<<blocks(qn / 4), 256, 0, st>>>(
      static_cast<const float4*>(q), reinterpret_cast<uint4*>(wq), qn / 4);
  f32_tc_split_rows_kernel<<<blocks(kn / 4), 256, 0, st>>>(
      static_cast<const float4*>(k), reinterpret_cast<uint4*>(wk), kn / 4);
  f32_tc_split_t_kernel<<<dim3((p.Skv + BK - 1) / BK, B * p.H), 256, 0, st>>>(
      static_cast<const float*>(v), reinterpret_cast<uint32_t*>(wv), B * p.H, p.Skv, p.block_kv,
      p.last_block, p.valid_in_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  const uint64_t bh = static_cast<uint64_t>(B) * p.H;
  if (!make_map(&tq, wq, 2 * bh * p.Sq, D, BQ) || !make_map(&tk, wk, 2 * bh * p.Skv, D, BK) ||
      !make_map(&tv, wv, 2 * bh * D, p.Skv, D))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.nq * ((p.block_q + BQ - 1) / BQ), p.H, B), THREADS, SMEM_BYTES, st>>>(tq, tk, tv,
                                                                                   args...);
  return cudaGetLastError();
}

}  // namespace f32tc
}  // namespace vorta
