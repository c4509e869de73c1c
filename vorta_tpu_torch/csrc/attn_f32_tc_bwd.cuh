// The f32 flash backward on the tensor cores (sm_90a): dq and dk/dv with
// every product split into three TF32 products (3xTF32) on wgmma, in place
// of csrc/attn_f32_bwd.cuh's FFMA kernels at head dim 128 with q and kv
// blocks that are multiples of 8 (ops/flash.py:flash_f32_tc_path, the
// forward's rule, flash_path_holds in csrc/attn_f32_tc.cuh: FULL, LOWRES and
// cross at blocks of 128 and more, the STA training tiles at 96, 360 and 24
// tokens).  Forward and backward take one design at every call and share
// the lse, m + log2(l) with the sentinel 1e30.  Included by
// csrc/flash_bwd.cu, whose C entries vorta_flash_bwd_f32_tc_split,
// vorta_flash_bwd_dq_f32 and vorta_flash_bwd_dkv_f32 (the last two given
// the scratch) launch it.
//
// Replaces the f32 modes of vorta_tpu/ops/flash_bwd.py:_dq_kernel and
// :_dkv_kernel, with csrc/attn_f32_bwd.cuh's semantics (its header): s2 =
// q.k * scale * log2(e) with the tail rule on block kv_valid_len // block_kv
// only, p = exp2(s2 - lse2) (the sentinel 1e30 gives p = 0), dp = dO V^T, ds
// = p (dp - delta), p and ds kept in f32; dq = scale * sum ds K, dk = scale *
// sum ds^T Q, dv = sum p^T dO, scale applied at the end.  A masked p or ds
// is 0 by select (0 x NaN is not 0); kv rows past the tail get exactly zero
// dk and dv, a count-0 q block exactly zero dq.  Each output row has one
// writer: no atomics, no dependence on CTA order.
//
// 3xTF32, as in the forward (csrc/attn_f32_tc.cuh): x = big + small, both
// TF32 with their low 13 bits zero, every product As Bb + Ab Bs + Ab Bb with
// the small products first.  The products are S (S^T), dP (dP^T), dQ, dV
// and dK.  Each chunk's dQ, dV and dK product lands in a fresh accumulator
// and joins the running sum by an add on the CUDA cores: the tensor core's
// accumulation truncates, and dq sums over as many keys (31,200 at FULL)
// as the forward's O, dk and dv over as many q rows.
//
// Bound on this card: operations.  dq does 3 products and dk/dv 4 per
// visible (q, kv) pair, 2 * 128 FLOP each, three TF32 products apiece: 495
// TFLOP/s TF32 is 165 TFLOP/s f32-exact (against 67 on the CUDA cores).
//
// tf32 wgmma reads both operands K-major, so the operands that a product
// reduces over their rows come transposed from the pre-pass:
//   dq:    S = Q K^T, dP = dO V^T   A: Q, dO rows (resident)  B: K, V rows
//          dQ += dS K               A: dS (S's registers)     B: K^T
//   dk/dv: S^T = K Q^T, dP^T = V dO^T  A: K, V rows (resident) B: Q, dO rows
//          dV += P^T dO, dK += dS^T Q  A: P^T, dS^T (registers) B: dO^T, Q^T
// The transposed tensors (f32_tc_split_t_kernel, the forward's V^T pre-pass)
// hold their rows permuted within groups of 8 to the accumulator's fragment
// order, so that S's registers are the A fragments unmoved; K^T's keys cut
// by the tail rule are stored as 0.  The split runs once a call, never per
// tile (a per-tile split was 1.6x slower in the forward), into scratch the
// wrapper allocates (ops/flash_bwd.py:f32_tc_bwd_work): the big and small
// halves of Q, dO, Q^T, dO^T, K, V and K^T, 14 half-tensors; one pre-pass
// serves both kernels.
//
// The design, per kernel: a CTA of 160 threads, one consumer warpgroup (64
// rows of one (b, h), its running sum in registers) and a producer warp
// whose first thread issues every TMA copy (boxes of 32 f32, the 128-byte
// swizzle).  Shared memory is the constraint: halves double f32's bytes, and
// a 64-row half at D = 128 is 32 KB.  The four resident halves (dq: Q, dO;
// dk/dv: K, V) take 128 KB; the walked side comes in chunks of 32 rows (dq:
// keys; dk/dv: q rows) through a ring of three 32 KB slots, one operand's
// two halves a slot, in the order the products read them (dq: K, V, K^T;
// dk/dv: Q, dO, dO^T, Q^T), each slot released once its product retires:
// 224 KB in all, one CTA an SM.  An operand lands while the two before it
// are read.  64-key chunks would need 320 KB (dq) and 384 KB (dk/dv).
// Registers: dq holds dQ (64 a thread) and the chunk's n128 accumulator
// (64); dk/dv holds dK and dV (64 each) and takes each chunk's dV and dK
// product in two n64 halves through one 32-register accumulator (an n128
// one with P^T's halves and dS^T live would pass 255): 198 / 200 registers
// (dq without / with the ragged tile) and 239-243 (dk/dv's four), no
// spills.  Timed against this design on an H100 and not kept (PERF.md,
// section 6): two CTAs of a cluster sharing the walked operands by
// TMA multicast (2.2x slower: L2 does not bound this kernel; the score
// products at n32 read 3 KB of shared memory for 16 cycles of products,
// and the consumer's serial steps do), and a chunk's score products issued
// behind the previous chunk's last product (dk/dv spills; dq, written
// either way, made ptxas serialize every wgmma).
//
// Blocks that 64 does not divide (the STA tiles: 96 = 64 + 32, 360 = 5 x 64
// + 40, 24).  The resident side takes ceil(block / 64) CTAs a block; the
// last one's 64-row tile runs past its block into the next block's rows
// (or past the tensor, where TMA fills zeros).  Those rows are computed
// and never stored: each output row has the one CTA of its own block as
// its writer.  In dk/dv they are masked by select like the tail rule's cut
// rows (p = 0, ds = 0); in dq, where rows do not mix, their lse reads as the
// sentinel and their delta as 0, so nothing is read past the tensor.  The
// walked side takes a block in 32-row chunks, the last one partial (360 =
// 11 x 32 + 8, 24 < 32): its columns past the block are masked by select
// (dq: keys past nvalid, as the tail rule's; dk/dv: q rows past the block,
// whose lse and delta are not read) and its rows past the block come from
// the next block or TMA's zero fill, met only by those zero columns.  The
// transposed halves' groups of 8 never straddle a block (blocks are
// multiples of 8).  A partial chunk costs a full chunk's products.
//
// What stays on csrc/attn_f32_bwd.cuh's FFMA kernels (the wrapper's rule):
// head dim 64 (the tiny models).
#pragma once

#include "attn_f32_bwd.cuh"
#include "attn_f32_tc.cuh"

namespace vorta {
namespace f32tc {

constexpr int BC = 32;            // keys of a dq chunk, q rows of a dk/dv chunk
constexpr int RES = BQ * D * 4;   // a resident half: 64 rows x 128 f32
constexpr int CT = BC * D * 4;    // a chunk half: 32 rows x 128 f32, or 128 x 32
constexpr int SLOTS = 3;          // ring slots of one operand (two halves) each
constexpr int RING = 4 * RES;     // resident halves: big A1, small A1, big A2, small A2
constexpr int BWD_BAR = RING + SLOTS * 2 * CT;  // res_full, full[SLOTS], empty[SLOTS]
constexpr int BWD_SMEM_BYTES = BWD_BAR + (1 + 2 * SLOTS) * 8 + 1024;
static_assert(BWD_SMEM_BYTES <= 232448, "shared memory of one H100 block");
static_assert(CT % 1024 == 0 && RES % 1024 == 0, "swizzle atoms stay aligned");

// D (+)= A B^T, m64n32k8 tf32, A and B from shared memory (K-major both)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (+)= A B^T, m64n64k8 tf32, A (four tf32 words) from registers, B from
// shared memory (K-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// d = As Bb + Ab Bs + Ab Bb: a resident 64-row operand (halves ab, as)
// against a 32-row chunk in a ring slot (halves bb, bs), over 128 columns
// (issued and committed, not waited).
__device__ __forceinline__ void issue_scores(float (&d)[16], uint32_t ab, uint32_t as,
                                             uint32_t bb, uint32_t bs) {
  sm90::fence_regs(d);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_ss_n32(d, kdesc(as, BQ, kk), kdesc(bb, BC, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_ss_n32(d, kdesc(ab, BQ, kk), kdesc(bs, BC, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_ss_n32(d, kdesc(ab, BQ, kk), kdesc(bb, BC, kk), 1);
  sm90::wgmma_commit();
}

// A (64 x 32, the n32 accumulator's order) split into its halves: xb, xs
// tf32 words; k step kk is registers 4kk + {0, 2, 1, 3} (see attn_f32_tc.cuh,
// pv_product).
__device__ __forceinline__ void split16(const float (&x)[16], uint32_t (&xb)[16],
                                        uint32_t (&xs)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) split(x[i], xb[i], xs[i]);
}

// acc = As Bb + Ab Bs + Ab Bb, A (64 x 32) from registers, B a transposed
// tile of 128 rows x 32 columns (halves bb, bs), n128 (issued and waited).
__device__ __forceinline__ void product_n128(float (&acc)[64], uint32_t (&ab)[16],
                                             uint32_t (&as)[16], uint32_t bb, uint32_t bs) {
  using namespace sm90;
  fence_regs(acc);
  fence_regs(ab);
  fence_regs(as);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BC / 8; ++kk)
    wgmma_rs_n128(acc, as[4 * kk], as[4 * kk + 2], as[4 * kk + 1], as[4 * kk + 3],
                  kdesc(bb, D, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < BC / 8; ++kk)
    wgmma_rs_n128(acc, ab[4 * kk], ab[4 * kk + 2], ab[4 * kk + 1], ab[4 * kk + 3],
                  kdesc(bs, D, kk), 1);
#pragma unroll
  for (int kk = 0; kk < BC / 8; ++kk)
    wgmma_rs_n128(acc, ab[4 * kk], ab[4 * kk + 2], ab[4 * kk + 1], ab[4 * kk + 3],
                  kdesc(bb, D, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(ab);
  fence_regs(as);
}

// sum[i] += the product of A (registers) and B (a transposed tile), taken in
// two n64 halves of B's rows (columns 64 hh.. of the result) through one
// 32-register accumulator, each half joined on the CUDA cores.
__device__ __forceinline__ void product_n64x2(float (&sum)[64], uint32_t (&ab)[16],
                                              uint32_t (&as)[16], uint32_t bb, uint32_t bs) {
  using namespace sm90;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const uint32_t b = bb + hh * 64 * 128, s = bs + hh * 64 * 128;
    float acc[32];
    fence_regs(acc);
    fence_regs(ab);
    fence_regs(as);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 8; ++kk)
      wgmma_rs_n64(acc, as[4 * kk], as[4 * kk + 2], as[4 * kk + 1], as[4 * kk + 3],
                   kdesc(b, D, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < BC / 8; ++kk)
      wgmma_rs_n64(acc, ab[4 * kk], ab[4 * kk + 2], ab[4 * kk + 1], ab[4 * kk + 3],
                   kdesc(s, D, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BC / 8; ++kk)
      wgmma_rs_n64(acc, ab[4 * kk], ab[4 * kk + 2], ab[4 * kk + 1], ab[4 * kk + 3],
                   kdesc(b, D, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ab);
    fence_regs(as);
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[32 * hh + i] += acc[i];
  }
}

// The ring: operand n of the CTA's walk sits in slot n % SLOTS (two halves,
// big then small, CT bytes apart), its full / empty barriers of that slot
// at parity (n / SLOTS) & 1.
struct Ring {
  uint32_t base;  // the aligned shared-memory base
  __device__ __forceinline__ uint32_t slot(int n) const { return base + RING + (n % SLOTS) * 2 * CT; }
  __device__ __forceinline__ uint32_t full(int n) const { return base + BWD_BAR + 8 * (1 + n % SLOTS); }
  __device__ __forceinline__ uint32_t empty(int n) const {
    return base + BWD_BAR + 8 * (1 + SLOTS + n % SLOTS);
  }
  __device__ __forceinline__ uint32_t parity(int n) const { return (n / SLOTS) & 1; }

  __device__ __forceinline__ void init() const {
    sm90::mbar_init(base + BWD_BAR, 1);
    for (int s = 0; s < SLOTS; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // producer: the resident operands, two maps' halves of 64 rows (big rows
  // at row, small at row + half_rows), onto the resident barrier
  __device__ __forceinline__ void load_resident(const CUtensorMap* a1, const CUtensorMap* a2,
                                                int row, int half_rows) const {
    const uint32_t bar = base + BWD_BAR;
    sm90::mbar_expect_tx(bar, 4 * RES);
    for (int i = 0; i < 4; ++i)
      for (int b = 0; b < 4; ++b)
        sm90::tma_load(base + i * RES + b * BQ * 128, i < 2 ? a1 : a2, bar, 32 * b,
                       row + (i % 2) * half_rows);
  }

  // producer: operand n, 32 rows of a row map (four boxes of 32 columns a
  // half) or, transposed, 32 columns at col of a 128-row map (one box a half)
  __device__ __forceinline__ void load(int n, const CUtensorMap* map, bool transposed, int col,
                                       int row, int half_rows) const {
    sm90::mbar_wait(empty(n), parity(n) ^ 1);  // a fresh barrier passes parity 1
    sm90::mbar_expect_tx(full(n), 2 * CT);
    for (int half = 0; half < 2; ++half) {
      const int r = row + half * half_rows;
      if (transposed)
        sm90::tma_load(slot(n) + half * CT, map, full(n), col, r);
      else
        for (int b = 0; b < 4; ++b)
          sm90::tma_load(slot(n) + half * CT + b * BC * 128, map, full(n), 32 * b, r);
    }
  }

  // consumer: wait for operand n; its big half's address
  __device__ __forceinline__ uint32_t acquire(int n) const {
    sm90::mbar_wait(full(n), parity(n));
    return slot(n);
  }

  // consumer: every warp, once its last reader of operand n is done
  __device__ __forceinline__ void release(int n, int lane) const {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty(n));
  }
};

// Zeros over `rows` rows of a (.., 128) f32 tensor from o, by every thread.
__device__ __forceinline__ void zero_rows(float* o, int rows, int tid) {
  float4* o4 = reinterpret_cast<float4*>(o);
  for (int e = tid; e < rows * D / 4; e += THREADS) o4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// A 64 x 128 sum times mul into the warpgroup's rows (row0 + 16 w + g + 8 hr),
// with `partial` those that lie below `rows`, the CTA's rows of its block.
template <bool partial>
__device__ __forceinline__ void store_sum(float* __restrict__ out, long long row0, int rows,
                                          const float (&sum)[64], float mul, int w, int g,
                                          int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (partial && 16 * w + g + 8 * hr >= rows) continue;
    float* orow = out + (row0 + 16 * w + g + 8 * hr) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(sum[4 * n + 2 * hr] * mul, sum[4 * n + 2 * hr + 1] * mul);
  }
}

// dq.  Grid (Sq / block_q * parts, H, B), parts = ceil(block_q / 64): CTA x
// is rows 64 (x % parts) .. of table q block x / parts.  tq, tdo: the Q / dO
// halves (2 B H Sq rows of 128, boxes of 64 rows); tk, tv: K / V halves
// (boxes of 32 rows); tkt: K^T's halves (2 B H 128 rows of Skv, boxes of 32
// keys x 128 rows).  p: the tables (kv_index / kv_count), lse, delta, dq,
// the shapes and the tail rule.  PartialTile: block_q % 64 != 0 (96, 360, 24),
// the last CTA of a block owning fewer than 64 rows; without it the row
// guards are compiled out (always on, they slowed FULL by 2% on an H100:
// PERF.md, section 6).
template <bool PartialTile>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_f32_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tkt,
                       const __grid_constant__ f32::BwdParams p) {
  using namespace sm90;
  const int parts = (p.block_q + BQ - 1) / BQ;
  const int qi = blockIdx.x / parts, local0 = (blockIdx.x % parts) * BQ;
  const int rows = PartialTile ? min(BQ, p.block_q - local0) : BQ;  // its rows of the q block
  const long long bh = static_cast<long long>(blockIdx.z) * p.H + blockIdx.y;
  const long long row0 = bh * p.Sq + static_cast<long long>(qi) * p.block_q + local0;
  const int count = p.count[qi];
  const int tid = threadIdx.x;
  if (count == 0) {  // a q block that sees nothing: zero dq, no barrier touched
    zero_rows(p.dq + row0 * D, rows, tid);
    return;
  }
  ChunkWalk<BC> walk{p.index + static_cast<long long>(qi) * p.width, count, p.block_kv,
                     p.last_block, p.valid_in_block};
  extern __shared__ uint8_t smem_raw[];
  const Ring ring{(smem_u32(smem_raw) + 1023) & ~1023u};
  const uint32_t base = ring.base;
  if (tid == 0) ring.init();
  __syncthreads();
  int key0, nvalid;

  if (tid >= 128) {
    // ---- producer: Q and dO once, then K, V, K^T of each 32-key chunk --------------
    if (tid != 128) return;
    const int qrows = gridDim.z * p.H * p.Sq, krows = gridDim.z * p.H * p.Skv;
    const int trows = gridDim.z * p.H * D, trow = static_cast<int>(bh) * D;
    ring.load_resident(&tq, &tdo, static_cast<int>(row0), qrows);
    for (int n = 0; walk.next(key0, nvalid); n += 3) {
      const int krow = static_cast<int>(bh * p.Skv) + key0;
      ring.load(n, &tk, false, 0, krow, krows);
      ring.load(n + 1, &tv, false, 0, krow, krows);
      ring.load(n + 2, &tkt, true, key0, trow, trows);
    }
    return;
  }

  // ---- consumer: 64 q rows, dQ in registers -------------------------------------------
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long r0 = row0 + 16 * w + g;  // this thread's rows r0, r0 + 8
  // rows past the block: never stored; the sentinel lse gives them p = 0
  const bool row_ok[2] = {!PartialTile || 16 * w + g < rows,
                          !PartialTile || 16 * w + g + 8 < rows};
  const float lse[2] = {row_ok[0] ? p.lse[r0] : 1e30f, row_ok[1] ? p.lse[r0 + 8] : 1e30f};
  const float dl[2] = {row_ok[0] ? p.delta[r0] : 0.f, row_ok[1] ? p.delta[r0 + 8] : 0.f};
  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  mbar_wait(base + BWD_BAR, 0);
  for (int n = 0; walk.next(key0, nvalid); n += 3) {
    // S = Q K^T, then dP = dO V^T: p's exponentials run while dP is in flight
    float s[16], dp[16];
    const uint32_t k = ring.acquire(n);
    issue_scores(s, base, base + RES, k, k + CT);
    const uint32_t v = ring.acquire(n + 1);
    issue_scores(dp, base + 2 * RES, base + 3 * RES, v, v + CT);
    wgmma_wait<1>();
    fence_regs(s);
    ring.release(n, lane);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = 8 * (i / 4) + 2 * t + (i & 1);
      s[i] = col < nvalid ? exp2f(s[i] * p.scale_log2 - lse[(i >> 1) & 1]) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    ring.release(n + 1, lane);
    uint32_t db[16], ds[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = 8 * (i / 4) + 2 * t + (i & 1);
      split(col < nvalid ? s[i] * (dp[i] - dl[(i >> 1) & 1]) : 0.f, db[i], ds[i]);
    }
    // dQ += dS K: a fresh accumulator, joined on the CUDA cores
    float acc[64];
    const uint32_t kt = ring.acquire(n + 2);
    product_n128(acc, db, ds, kt, kt + CT);
    ring.release(n + 2, lane);
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] += acc[i];
  }
  store_sum<PartialTile>(p.dq, row0, rows, dq, p.scale, w, g, t);
}

// dk and dv.  Grid (Skv / block_kv * parts, H, B), parts = ceil(block_kv /
// 64): CTA x is rows 64 (x % parts) .. of table kv block x / parts.  tk, tv:
// K / V halves (boxes of 64 rows); tq, tdo: Q / dO halves (boxes of 32
// rows); tqt, tdot: Q^T / dO^T halves (2 B H 128 rows of Sq, boxes of 32 q
// rows x 128 rows).  p: the transposed tables (q_index / q_count), lse,
// delta, dk, dv, the shapes and the tail rule.  PartialTile: block_kv % 64 !=
// 0, as in dq.  PartialChunk: block_q % 32 != 0 (360, 24), a q block's last
// chunk masked past the block; without it (FULL, LOWRES, cross, 96) the walk
// has no column mask: the masks and guarded loads, always on, slowed the
// loop at FULL on an H100 (PERF.md, section 6).
template <bool PartialTile, bool PartialChunk>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_f32_tc_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tqt,
                        const __grid_constant__ CUtensorMap tdot,
                        const __grid_constant__ f32::BwdParams p) {
  using namespace sm90;
  const int parts = (p.block_kv + BQ - 1) / BQ;
  const int kvb = blockIdx.x / parts, local0 = (blockIdx.x % parts) * BQ;
  const int rows = PartialTile ? min(BQ, p.block_kv - local0) : BQ;  // its rows of the kv block
  const long long bh = static_cast<long long>(blockIdx.z) * p.H + blockIdx.y;
  const long long row0 = bh * p.Skv + static_cast<long long>(kvb) * p.block_kv + local0;
  const int limit = kvb == p.last_block ? p.valid_in_block : p.block_kv;
  const int count = p.count[kvb];
  const int tid = threadIdx.x;
  if (count == 0 || local0 >= limit) {  // no q block visits, or all rows past the tail
    zero_rows(p.dk + row0 * D, rows, tid);
    zero_rows(p.dv + row0 * D, rows, tid);
    return;
  }
  const int* idx = p.index + static_cast<long long>(kvb) * p.width;
  const int per_block = (p.block_q + BC - 1) / BC;  // chunks of a q block, the last partial
  const int chunks = count * per_block;
  extern __shared__ uint8_t smem_raw[];
  const Ring ring{(smem_u32(smem_raw) + 1023) & ~1023u};
  const uint32_t base = ring.base;
  if (tid == 0) ring.init();
  __syncthreads();

  if (tid >= 128) {
    // ---- producer: K and V once, then Q, dO, dO^T, Q^T of each 32-row q chunk -----
    if (tid != 128) return;
    const int qrows = gridDim.z * p.H * p.Sq, krows = gridDim.z * p.H * p.Skv;
    const int trows = gridDim.z * p.H * D, trow = static_cast<int>(bh) * D;
    ring.load_resident(&tk, &tv, static_cast<int>(row0), krows);
    for (int c = 0; c < chunks; ++c) {
      const int m = idx[c / per_block] * p.block_q + (c % per_block) * BC;
      const int qrow = static_cast<int>(bh * p.Sq) + m;
      ring.load(4 * c, &tq, false, 0, qrow, qrows);
      ring.load(4 * c + 1, &tdo, false, 0, qrow, qrows);
      ring.load(4 * c + 2, &tdot, true, m, trow, trows);
      ring.load(4 * c + 3, &tqt, true, m, trow, trows);
    }
    return;
  }

  // ---- consumer: 64 kv rows, dK and dV in registers ---------------------------------
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // kv rows the tail rule leaves visible (the rest get p = 0: zero dk, dv; rows
  // past the block too, never stored)
  const bool row_ok[2] = {local0 + 16 * w + g < limit, local0 + 16 * w + g + 8 < limit};
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(base + BWD_BAR, 0);
  for (int c = 0; c < chunks; ++c) {
    const int n = 4 * c, m0 = (c % per_block) * BC;
    const long long qrow = bh * p.Sq + idx[c / per_block] * static_cast<long long>(p.block_q) + m0;
    // the chunk's q rows of its block, a multiple of 8
    const int nq = PartialChunk ? min(BC, p.block_q - m0) : BC;
    float2 ls[4], dl[4];  // lse and delta of this thread's columns 8j + 2t, + 1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = 8 * j < nq;  // columns past the block: masked below, never read
      ls[j] = in ? __ldg(reinterpret_cast<const float2*>(p.lse + qrow + 8 * j + 2 * t))
                 : make_float2(0.f, 0.f);
      dl[j] = in ? __ldg(reinterpret_cast<const float2*>(p.delta + qrow + 8 * j + 2 * t))
                 : make_float2(0.f, 0.f);
    }
    // S^T = K Q^T, then dP^T = V dO^T
    float st[16], dpt[16];
    const uint32_t q = ring.acquire(n);
    issue_scores(st, base, base + RES, q, q + CT);
    const uint32_t o = ring.acquire(n + 1);
    issue_scores(dpt, base + 2 * RES, base + 3 * RES, o, o + CT);
    wgmma_wait<1>();
    fence_regs(st);
    ring.release(n, lane);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float l = (i & 1) ? ls[i / 4].y : ls[i / 4].x;
      st[i] = row_ok[(i >> 1) & 1] && 8 * (i / 4) < nq ? exp2f(st[i] * p.scale_log2 - l) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dpt);
    ring.release(n + 1, lane);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float d = (i & 1) ? dl[i / 4].y : dl[i / 4].x;
      dpt[i] = row_ok[(i >> 1) & 1] && 8 * (i / 4) < nq ? st[i] * (dpt[i] - d) : 0.f;  // ds^T
    }
    // dV += P^T dO, then dK += dS^T Q: fresh accumulators, joined on the CUDA cores
    uint32_t ab[16], as[16];
    split16(st, ab, as);
    const uint32_t ot = ring.acquire(n + 2);
    product_n64x2(dv, ab, as, ot, ot + CT);
    ring.release(n + 2, lane);
    split16(dpt, ab, as);
    const uint32_t qt = ring.acquire(n + 3);
    product_n64x2(dk, ab, as, qt, qt + CT);
    ring.release(n + 3, lane);
  }
  store_sum<PartialTile>(p.dk, row0, rows, dk, p.scale, w, g, t);
  store_sum<PartialTile>(p.dv, row0, rows, dv, 1.f, w, g, t);
}

// ---- host side ---------------------------------------------------------------------

// The scratch of one call (ops/flash_bwd.py:f32_tc_bwd_work), each tensor
// its big half then its small half: Q, dO (B H Sq rows of 128), Q^T, dO^T (B
// H 128 rows of Sq), K, V (B H Skv rows), K^T (B H 128 rows of Skv).
struct BwdWork {
  float *q, *dout, *qt, *dot, *k, *v, *kt;
};

inline BwdWork bwd_work(void* work, int B, int H, int Sq, int Skv) {
  const long long nq = static_cast<long long>(B) * H * Sq * D;
  const long long nk = static_cast<long long>(B) * H * Skv * D;
  float* w = static_cast<float*>(work);
  return {w, w + 2 * nq, w + 4 * nq, w + 6 * nq, w + 8 * nq, w + 8 * nq + 2 * nk,
          w + 8 * nq + 4 * nk};
}

// The pre-pass: the halves of Q, dO, K and V rows (both kernels read them)
// and of K^T (dq) and Q^T, dO^T (dk/dv) into the scratch.  All tensors
// contiguous (B, H, S, 128) f32, 16-byte aligned; S multiples of 8.
inline cudaError_t split_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const BwdWork& w, int B, int H, int Sq, int Skv, int block_q,
                             int block_kv, int last_block, int valid_in_block, bool need_dq,
                             bool need_dkv, cudaStream_t st) {
  const long long nq = static_cast<long long>(B) * H * Sq * D;
  const long long nk = static_cast<long long>(B) * H * Skv * D;
  auto rows = [&](const void* x, float* out, long long n) {
    f32_tc_split_rows_kernel<<<static_cast<int>(std::min(n / 4 / 256 + 1, 8192LL)), 256, 0, st>>>(
        static_cast<const float4*>(x), reinterpret_cast<uint4*>(out), n / 4);
  };
  auto cols = [&](const void* x, float* out, int S, int block, int last, int valid) {
    f32_tc_split_t_kernel<<<dim3((S + BK - 1) / BK, B * H), 256, 0, st>>>(
        static_cast<const float*>(x), reinterpret_cast<uint32_t*>(out), B * H, S, block, last,
        valid);
  };
  rows(q, w.q, nq);
  rows(dout, w.dout, nq);
  rows(k, w.k, nk);
  rows(v, w.v, nk);
  if (need_dq) cols(k, w.kt, Skv, block_kv, last_block, valid_in_block);
  if (need_dkv) {
    cols(q, w.qt, Sq, block_q, -1, 0);
    cols(dout, w.dot, Sq, block_q, -1, 0);
  }
  return cudaGetLastError();
}

// Launch the dq kernel over the split scratch; the CUDA error code.
inline cudaError_t launch_dq(const BwdWork& w, int B, const f32::BwdParams& p,
                             cudaStream_t st) {
  const uint64_t bh = static_cast<uint64_t>(B) * p.H;
  CUtensorMap tq, tdo, tk, tv, tkt;
  if (!make_map(&tq, w.q, 2 * bh * p.Sq, D, BQ) || !make_map(&tdo, w.dout, 2 * bh * p.Sq, D, BQ) ||
      !make_map(&tk, w.k, 2 * bh * p.Skv, D, BC) || !make_map(&tv, w.v, 2 * bh * p.Skv, D, BC) ||
      !make_map(&tkt, w.kt, 2 * bh * D, p.Skv, D))
    return cudaErrorInvalidValue;
  auto kern = p.block_q % BQ ? flash_dq_f32_tc_kernel<true> : flash_dq_f32_tc_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int parts = (p.block_q + BQ - 1) / BQ;
  kern<<<dim3(p.Sq / p.block_q * parts, p.H, B), THREADS, BWD_SMEM_BYTES, st>>>(tq, tdo, tk, tv,
                                                                                 tkt, p);
  return cudaGetLastError();
}

// Launch the dk/dv kernel over the split scratch; the CUDA error code.
inline cudaError_t launch_dkv(const BwdWork& w, int B, const f32::BwdParams& p,
                              cudaStream_t st) {
  const uint64_t bh = static_cast<uint64_t>(B) * p.H;
  CUtensorMap tk, tv, tq, tdo, tqt, tdot;
  if (!make_map(&tk, w.k, 2 * bh * p.Skv, D, BQ) || !make_map(&tv, w.v, 2 * bh * p.Skv, D, BQ) ||
      !make_map(&tq, w.q, 2 * bh * p.Sq, D, BC) || !make_map(&tdo, w.dout, 2 * bh * p.Sq, D, BC) ||
      !make_map(&tqt, w.qt, 2 * bh * D, p.Sq, D) || !make_map(&tdot, w.dot, 2 * bh * D, p.Sq, D))
    return cudaErrorInvalidValue;
  const bool tile = p.block_kv % BQ, chunk = p.block_q % BC;
  auto kern = tile ? (chunk ? flash_dkv_f32_tc_kernel<true, true>
                            : flash_dkv_f32_tc_kernel<true, false>)
                   : (chunk ? flash_dkv_f32_tc_kernel<false, true>
                            : flash_dkv_f32_tc_kernel<false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int parts = (p.block_kv + BQ - 1) / BQ;
  kern<<<dim3(p.Skv / p.block_kv * parts, p.H, B), THREADS, BWD_SMEM_BYTES, st>>>(
      tk, tv, tq, tdo, tqt, tdot, p);
  return cudaGetLastError();
}

}  // namespace f32tc
}  // namespace vorta
