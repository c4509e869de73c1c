// The Hopper mainloop of the forward attention kernels (sm_90a), shared by
// csrc/flash.cu (online softmax, optional lse), csrc/flash_manual.cu (the
// fast exp2(s + bias) softmax), csrc/sta_pipe.cu (the same fast softmax
// over each q tile's sliding window), csrc/sta_window.cu (the online
// softmax over the window, padded runs masked; csrc/sta_row.cu the same),
// csrc/sta_batched.cu (the fast softmax over pair-bit tables) and
// csrc/sta_diag.cu (the bisection variants over a chunk walk of the window,
// with loops of their own, Loop below): one kernel template, two softmax
// policies and three key walks ("sources": BlockSource here, WindowSource
// in csrc/sta_window_src.cuh, PairBitSource in csrc/sta_batched.cu).
// csrc/flash_bwd.cu builds the backward's two Hopper kernels (dq, dk/dv)
// from the same pieces: TMA maps, mbarriers, the wgmma wrappers and their
// descriptors, TileWalk.
//
// What bounds these kernels on the H100: at the served shapes (head dim
// 128, kv blocks of 512-1024 keys, STA windows of 2,592-9,720 keys) each q
// row does 4 * 128 FLOP per key against a K/V tile that 128 q rows share,
// so the tensor cores bound them (989 TFLOP/s bf16), provided that the
// products run on wgmma (mma.sync cannot reach that rate) and that no K/V
// copy stalls a product.  Design, after FlashAttention-3:
//
// - CTA layout.  A CTA owns 128 q rows of one (batch, head): two consumer
//   warpgroups of 64 rows each, and one producer warpgroup whose first
//   thread issues every copy.  The producer drops its registers to 40 with
//   setmaxnreg, the consumers raise theirs to 232 (__launch_bounds__(384, 1),
//   128 * 40 + 256 * 232 <= 65,536).  The grid runs q tiles fastest, then
//   heads, then batch rows, so the CTAs resident together share one head's
//   K/V in the 50 MB L2.
// - Q.  128-byte swizzle, as two boxes of 64 columns (a 128-byte swizzle row
//   holds 64 bf16); 32 KB.  BlockSource loads it by TMA; WindowSource
//   (sta_pipe.cu), whose rows are runs scattered over the raster, by plain
//   16-byte loads of every thread into the same swizzled layout;
//   PairBitSource by TMA, as BlockSource.  In the
//   int8 QK mode a row of 128 int8 is one box, and S = Q K^T runs on wgmma
//   s8 m64n128k32 (exact int32 sums, then one multiply by qk_factor[h]).
// - The K/V ring.  STAGES slots of BN = 128 keys (K 32 KB + V 32 KB each)
//   in dynamic shared memory.  K and V have barriers of their own: a
//   "full" mbarrier (the producer's arrive.expect_tx, then TMA's
//   complete_tx) and an "empty" one (one arrival per consumer warp once its
//   last reader is done: the softmax for K, whose slot also holds the
//   slot's 512 B of bias, the PV product for V).  The producer walks the
//   consumers' sequence of slots (the source's next()): BlockSource walks
//   kv_index's blocks in 128-key sub-tiles (TileWalk), skipping the
//   sub-tiles that the tail rule masks completely; the tiles are whole
//   (block_kv % 128 == 0, and kv blocks never cross a head), so each
//   barrier's byte count is fixed.  WindowSource fills each slot with the
//   boxes of a host table, each box landing on a multiple of 8 rows;
//   PairBitSource walks the slot list its CTA built in shared memory before
//   the ring started (prepare()).
// - S = Q K^T: wgmma.m64n128k16, Q and K both K-major from shared memory
//   (descriptors with the 128-byte swizzle, stride 1,024 B per 8 rows; a
//   k step of 16 advances the start address by 32 B inside the swizzle
//   row, the second half of D starts at the second box).
// - O += P V: P from registers (the S accumulator of each 16-key step packed
//   to bf16 pairs is the A fragment, as in mma.sync's layouts: this is
//   where P is rounded to bf16), V from shared memory as an MN-major B
//   operand (the transpose bit, bf16 only): leading offset 16 KB between
//   the two 64-column boxes, stride 1,024 B per 8 keys.
// - Overlap inside a warpgroup, after FA3: tile j's QK product is issued
//   before tile j-1's PV product, tile j's softmax runs while that product
//   is in flight, and O is rescaled once it has landed.  With separate K
//   and V barriers the producer refills K two tiles ahead and V one ahead.
// - Softmax, tail rule and epilogue stay in registers on the accumulators,
//   as the mma.sync kernels compute them, with two changes of instruction
//   and none of function: 2^x is ex2.approx.ftz (one instruction; results
//   below 2^-126 flush to 0, which no row sum can see), and the column mask
//   runs only on a slot that is cut (per column for the tail rule, per
//   8-column block where a source's cuts are multiples of 8; a source with
//   masks of its own, OWN_SOFTMAX, applies them as selects whose pattern
//   is known at compile time or held in one word a row).  The fast
//   softmax loads its bias outside any condition: a guarded load per score
//   compiles to a branch per score and halves the kernel's speed.  A CTA
//   with nothing to do (count 0, an inactive head) writes zeros (and the
//   lse sentinel) and exits before any barrier.
//
// Where the tables give other shapes (D = 64, blocks that 128 does not
// divide), the mma.sync kernels of the same .cu files run; the wrappers
// choose by one pure-Python rule (ops/flash.py:wgmma_path,
// ops/sta_pipe.py:sta_wgmma_path, ops/sta_window.py:window_wgmma_path,
// ops/sta_batched.py:batched_wgmma_path).
#pragma once
#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace vorta {
namespace sm90 {

constexpr int D = 128;          // head dim of the Hopper path
constexpr int BM = 128;         // q rows per CTA
constexpr int BN = 128;         // keys per ring slot
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;    // warpgroups of 64 q rows
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int ROW_BYTES = 128;  // one swizzled line: 64 bf16
constexpr int Q_BYTES = BM * D * 2;
constexpr int KV_BYTES = BN * D * 2;
constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K then V
constexpr int BIAS_BYTES = BN * 4;
constexpr int BIAS_OFF = Q_BYTES + STAGES * STAGE_BYTES;
constexpr int BAR_OFF = BIAS_OFF + STAGES * BIAS_BYTES;
// q_full, then k_full, k_empty, v_full, v_empty [STAGES] each; 1,024 B of
// slack to align the base
constexpr int SMEM_BYTES = BAR_OFF + (1 + 4 * STAGES) * 8 + 1024;
// a source's own region past the barriers (WindowSource: its walk table); a
// kernel that has one asks for SRC_OFF + its bytes + 1,024 B
constexpr int SRC_OFF = BAR_OFF + 128;
constexpr int EMPTY_ARRIVALS = CONSUMERS * 4;  // one per consumer warp
static_assert(SMEM_BYTES <= 232448, "shared memory of one H100 block");

enum class Softmax { Online, Fast };

// The consumers' loop.  Served: the kernels' own.  A source that defines
// LOOP picks another (csrc/sta_diag.cu's bisection variants):
// - Chains: two online-softmax chains, chain-major (every slot of chain 0,
//   then every slot of chain 1; a slot's chain is Slot::info), each with
//   its own max and sum, summed without a common max at the end: chain 0's
//   finished O goes to the source's stash in shared memory as bf16 pairs,
//   its sums stay in registers;
// - ChainsUnrolled: the same, the loop unrolled by the ring's stages, so
//   that every stage index and barrier address is a compile-time constant;
// - DmaOnly: the copies alone: each consumer warp waits for every slot and
//   releases it, no product (O stays 0);
// - NoDma: the compute of Chains with no wait for a copy in the consumers'
//   loop (the products read whatever the ring holds).  The producer then
//   waits for a slot's previous copy to land before it arms the slot's
//   barrier again, and for every copy it issued before it exits, so that no
//   phase is armed twice and no bulk copy outlives the CTA.
enum class Loop { Served, Chains, ChainsUnrolled, DmaOnly, NoDma };

template <class Src, class = void>
struct loop_of {
  static constexpr Loop value = Loop::Served;
};
template <class Src>
struct loop_of<Src, std::void_t<decltype(Src::LOOP)>> {
  static constexpr Loop value = Src::LOOP;
};

struct Params {
  __nv_bfloat16* out;     // (B, H, Sq, D)
  float* lse;             // (B, H, Sq) or null (Online only)
  const int* kv_index;    // (idx_heads, nq, width)
  const int* kv_count;    // (cnt_heads, nq)
  const float* kv_bias;   // (Skv,) or null (Fast only)
  int H, Sq, Skv, nq, width, idx_shared, cnt_shared, block_q, block_kv;
  int last_block, valid_in_block;  // the tail rule: block kv_valid_len // block_kv
  float scale_log2;                // Online: scale * log2(e); Fast: unused (q pre-scaled)
  const float* qk_factor;          // int8 QK: (H,) qk_scale * scale * log2(e); else null
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of the given parity to complete.  A wait that lasts
// 2^34 cycles (~9 s) traps: a fault in the ring's protocol then ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 34))
      __trap();
  }
}

// One box of a 2D tensor map (columns c0.., rows c1..) into shared memory,
// completing on an mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One box of a 4D tensor map (c0 innermost) into shared memory, completing
// on an mbarrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Order this thread's generic-proxy writes to shared memory before the
// async proxy's accesses (wgmma operand reads, TMA writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A contiguous copy (bytes % 16 == 0, 16-byte aligned) completing on an mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The named barrier id (1..15) of `threads` threads (a multiple of 32).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of accumulator registers across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (bits 62-63).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D (+)= A B^T, m64n128k16, A and B from shared memory (K-major both)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += A B, m64n128k16, A (bf16 pairs) from registers, B from shared memory
// MN-major (the transpose bit: B's rows are k, its 128-byte lines run along n)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (+)= A B^T, m64n64k16, A and B from shared memory (K-major both): the
// backward's S^T = K Q^T and dP^T = V dO^T over 64-row q tiles
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (+)= A B^T in s32, m64n128k32, int8 A and B from shared memory (K-major both)
__device__ __forceinline__ void wgmma_ss_s8_n128(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// K-major operand (Q or K) of `rows` rows, both 64-column boxes at base:
// the descriptor of k step kk (32 bytes: 16 bf16 or 32 int8 columns) for
// rows starting at row0 (an int8 row of 128 is one 128-byte box).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int rows, int row0, int kk) {
  return desc_sw128(base + (kk / 4) * rows * ROW_BYTES + row0 * ROW_BYTES + (kk % 4) * 32, 16,
                    8 * ROW_BYTES);
}

// MN-major B operand V (BN keys x D), both boxes at base: the descriptor of
// the 16 keys of step kk, n over all D columns.
__device__ __forceinline__ uint64_t vmajor_desc(uint32_t base, int kk) {
  return desc_sw128(base + kk * 16 * ROW_BYTES, BN * ROW_BYTES, 8 * ROW_BYTES);
}

// The same for a tile of `rows` rows (the backward's K of 128 keys, its Q
// and dO tiles of 64 rows): the second 64-column box starts rows lines on.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int rows, int kk) {
  return desc_sw128(base + kk * 16 * ROW_BYTES, rows * ROW_BYTES, 8 * ROW_BYTES);
}

// S accumulator (64 keys' worth per 8 registers) -> A fragments of the PV
// product: step kk (keys 16kk..16kk+15) takes registers 8kk..8kk+7.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// One ring slot as the producer and the consumers both see it.
struct Slot {
  int key0;    // the source's handle: the first key (BlockSource), a walk-table row (WindowSource)
  int nvalid;  // keys of the slot that count; the columns past them are masked
  bool bias;   // the slot carries BN f32 of bias, added to its scores
  uint32_t info = 0;  // a source's own mask word (PairBitSource)
};

// The walk over a CTA's kv sub-tiles that the producer and the consumers
// share: for j < count, block kv_index[j], its 128-key sub-tiles up to the
// tail rule's limit (a sub-tile the rule masks completely is skipped, as
// the mma.sync kernels skip theirs).
struct TileWalk {
  const int* idx;
  int count, block_kv, last_block, valid_in_block;
  int j = 0, n0 = 0, kvb = 0, limit = 0;

  // The next sub-tile's first key and its number of valid keys.
  __device__ __forceinline__ bool next(int& key0, int& nvalid) {
    while (j < count) {
      if (n0 == 0) {
        kvb = idx[j];
        limit = (kvb == last_block) ? valid_in_block : block_kv;
      }
      if (n0 < limit) {
        key0 = kvb * block_kv + n0;
        nvalid = min(BN, limit - n0);
        n0 += BN;
        return true;
      }
      ++j;
      n0 = 0;
    }
    return false;
  }
};

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S = Q K^T for this warpgroup's 64 rows against a K tile (issued, not waited).
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_smem, uint32_t k_tile,
                                         int wg) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128(s, kmajor_desc(q_smem, BM, wg * 64, kk), kmajor_desc(k_tile, BN, 0, kk), kk > 0);
  wgmma_commit();
}

// The int8 QK mode: S = Q K^T in exact int32 sums (issued, not waited).
__device__ __forceinline__ void issue_qk_s8(uint32_t (&si)[64], uint32_t q_smem, uint32_t k_tile,
                                            int wg) {
  fence_regs(si);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk)
    wgmma_ss_s8_n128(si, kmajor_desc(q_smem, BM, wg * 64, kk), kmajor_desc(k_tile, BN, 0, kk),
                     kk > 0);
  wgmma_commit();
}

// O += P V for a V tile (issued, not waited).
__device__ __forceinline__ void issue_pv(float (&o)[64], uint32_t (&pa)[32], uint32_t v_tile) {
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_n128(o, &pa[4 * kk], vmajor_desc(v_tile, kk), 1);
  wgmma_commit();
}

// 2^x on the special-function unit, denormal results flushed to 0 (one
// instruction; exp2f adds three to keep denormals, which no row sum sees).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online: the scores scaled to the log2 domain, -1e30 past nvalid (MASK: the
// tile the tail rule cuts; whole tiles skip the compares).
template <bool MASK>
__device__ __forceinline__ void scale_scores(float (&s)[64], int nvalid, int t,
                                             float scale_log2) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float x = s[i] * scale_log2;
    s[i] = (MASK && 8 * (i / 4) + 2 * t + (i & 1) >= nvalid) ? NEG_INF : x;
  }
}

// Fast: p = exp2(s + bias) (bs: the tile's bias in shared memory, or
// null), 0 past nvalid (MASK; BY8: nvalid is a multiple of 8, so the test
// is one per 8-column block), added to the row sums.
template <bool MASK, bool BIAS, bool BY8>
__device__ __forceinline__ void fast_p(float (&s)[64], int nvalid, int t, const float* bs,
                                       float (&l_part)[2]) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {  // columns 8n + 2t and 8n + 2t + 1
    const float2 b = BIAS ? *reinterpret_cast<const float2*>(bs + 8 * n + 2 * t)
                          : make_float2(0.f, 0.f);
    const bool off8 = BY8 && 8 * n >= nvalid;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e;
      const float x = ex2(BIAS ? s[i] + ((e & 1) ? b.y : b.x) : s[i]);
      const bool off = BY8 ? off8 : 8 * n + 2 * t + (e & 1) >= nvalid;
      s[i] = (MASK && off) ? 0.f : x;
      l_part[e >> 1] += s[i];
    }
  }
}

// The online step on scores already in the log2 domain (masked columns
// -1e30), in place (s becomes p): the running max m_run with m_safe, alpha =
// exp2(m_old - m_safe) for the caller to rescale O by, l_part rescaled and
// summed.
__device__ __forceinline__ void online_update(float (&s)[64], float (&m_run)[2],
                                              float (&l_part)[2], float (&alpha)[2]) {
  {
    float m_cur[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 64; ++i) m_cur[(i >> 1) & 1] = fmaxf(m_cur[(i >> 1) & 1], s[i]);
    float m_safe[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m_cur[hr] = fmaxf(m_cur[hr], __shfl_xor_sync(0xffffffffu, m_cur[hr], 1));
      m_cur[hr] = fmaxf(m_cur[hr], __shfl_xor_sync(0xffffffffu, m_cur[hr], 2));
      const float m_new = fmaxf(m_run[hr], m_cur[hr]);
      m_safe[hr] = (m_new <= NEG_INF) ? 0.f : m_new;
      alpha[hr] = ex2(m_run[hr] - m_safe[hr]);
      m_run[hr] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      s[i] = ex2(s[i] - m_safe[(i >> 1) & 1]);
      psum[(i >> 1) & 1] += s[i];
    }
    l_part[0] = l_part[0] * alpha[0] + psum[0];
    l_part[1] = l_part[1] * alpha[1] + psum[1];
  }
}

// The softmax step on one tile's scores, in place (s becomes p), as the
// mma.sync kernels compute it.  Online: scores scaled, masked columns -1e30,
// then online_update.  Fast: p = exp2(s + bias), 0 on masked columns, no
// max and no rescale.  BY8: the source cuts its slots only at multiples of
// 8 keys.
template <Softmax SM, bool BY8>
__device__ __forceinline__ void softmax_tile(float (&s)[64], int nvalid, int t, float scale_log2,
                                             const float* bs, float (&m_run)[2],
                                             float (&l_part)[2], float (&alpha)[2]) {
  const bool mask = nvalid < BN;
  if constexpr (SM == Softmax::Online) {
    if (mask)
      scale_scores<true>(s, nvalid, t, scale_log2);
    else
      scale_scores<false>(s, nvalid, t, scale_log2);
    online_update(s, m_run, l_part, alpha);
  } else if (bs != nullptr) {
    if (mask)
      fast_p<true, true, BY8>(s, nvalid, t, bs, l_part);
    else
      fast_p<false, true, BY8>(s, nvalid, t, bs, l_part);
  } else {
    if (mask)
      fast_p<true, false, BY8>(s, nvalid, t, bs, l_part);
    else
      fast_p<false, false, BY8>(s, nvalid, t, bs, l_part);
  }
}

// The window sources' online scores (sta_window): s * scale_log2, plus the
// slot's bias where BIAS (a text slot), -1e30 past nvalid where CUT (a cut
// slot: the sources cut at multiples of 8 keys, so one test per 8-column
// block) and, where RB > 0, on the padded columns of the slot's runs: runs
// of RB 8-column blocks whose last block holds padding, this thread's
// columns 2t + e of it where bit e of pad is set.  Which blocks end a run
// is known at compile time, so the padding costs one select on 8 of the 64
// scores at RB = 4.
template <bool CUT, bool BIAS, int RB>
__device__ __forceinline__ void window_scores(float (&s)[64], int nvalid, int t, float scale_log2,
                                              const float* bs, uint32_t pad) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {  // columns 8n + 2t and 8n + 2t + 1
    const float2 b = BIAS ? *reinterpret_cast<const float2*>(bs + 8 * n + 2 * t)
                          : make_float2(0.f, 0.f);
    const bool cut = CUT && 8 * n >= nvalid;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e;
      const float x = BIAS ? fmaf(s[i], scale_log2, (e & 1) ? b.y : b.x) : s[i] * scale_log2;
      bool off = cut;
      if constexpr (RB > 0)
        if (n % RB == RB - 1) off = off || ((pad >> (e & 1)) & 1u);
      s[i] = off ? NEG_INF : x;
    }
  }
}

// Fast with a visibility word per row (PairBitSource): p = exp2(s + bias),
// 0 where bit n of vis[hr] is clear (columns 8n..8n+7 of this thread's row
// hr hidden: the source's cuts fall on multiples of 8 keys), added to the
// row sums.  exp2 runs on every score and a select masks it: no branch.
template <bool BIAS>
__device__ __forceinline__ void fast_p_vis(float (&s)[64], int t, const float* bs,
                                           const uint32_t (&vis)[2], float (&l_part)[2]) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const float2 b = BIAS ? *reinterpret_cast<const float2*>(bs + 8 * n + 2 * t)
                          : make_float2(0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e;
      const float x = ex2(BIAS ? s[i] + ((e & 1) ? b.y : b.x) : s[i]);
      s[i] = ((vis[e >> 1] >> n) & 1u) ? x : 0.f;
      l_part[e >> 1] += s[i];
    }
  }
}

// flash / flash_manual's source: a CTA's 128 q rows are rows row0.. of one
// (batch, head) of (B, H, Sq, D), loaded by TMA; its keys the 128-key
// sub-tiles of the kv blocks kv_index lists (TileWalk), loaded by TMA with
// their kv_bias; the output (and the lse) rows are contiguous.  I8: q and k
// are int8 rows of 128 bytes, one box each.
template <bool I8>
struct BlockSource {
  static constexpr bool Q_BY_TMA = true;
  static constexpr bool BY8 = false;  // the tail rule cuts anywhere
  static constexpr bool OWN_SOFTMAX = false;  // softmax_tile on nvalid
  static constexpr uint32_t QK_BYTES = I8 ? KV_BYTES / 2 : KV_BYTES;  // a Q or K tile
  const CUtensorMap *tq, *tk, *tv;
  const Params& p;
  size_t bh;  // b * H + h
  int h, row0, count;
  TileWalk walk;

  __device__ __forceinline__ BlockSource(const CUtensorMap& tq_, const CUtensorMap& tk_,
                                         const CUtensorMap& tv_, const Params& p_)
      : tq(&tq_), tk(&tk_), tv(&tv_), p(p_) {
    h = blockIdx.y;
    bh = static_cast<size_t>(blockIdx.z) * p.H + h;
    row0 = blockIdx.x * BM;  // inside one table q block (block_q % BM == 0)
    const int qi = row0 / p.block_q;
    count = p.kv_count[(p.cnt_shared ? 0 : h) * p.nq + qi];
    const int* idx =
        p.kv_index + static_cast<size_t>((p.idx_shared ? 0 : h) * p.nq + qi) * p.width;
    walk = TileWalk{idx, count, p.block_kv, p.last_block, p.valid_in_block};
  }
  __device__ __forceinline__ void prepare(uint8_t*, int) {}
  // routed away or past valid_len: zeros (and the lse sentinel), no barrier touched
  __device__ __forceinline__ bool idle() const { return count == 0; }
  __device__ __forceinline__ void write_zeros(int tid) const {
    uint4* o4 = reinterpret_cast<uint4*>(p.out + (bh * p.Sq + row0) * D);
    for (int e = tid; e < BM * D / 8; e += THREADS) o4[e] = make_uint4(0, 0, 0, 0);
    if (p.lse != nullptr)
      for (int r = tid; r < BM; r += THREADS) p.lse[bh * p.Sq + row0 + r] = 1e30f;
  }
  __device__ __forceinline__ void issue_q(uint32_t q_smem, uint32_t bar) const {
    mbar_expect_tx(bar, QK_BYTES);
    const int qrow = static_cast<int>(bh * p.Sq) + row0;
    tma_load(q_smem, tq, bar, 0, qrow);
    if (!I8) tma_load(q_smem + BM * ROW_BYTES, tq, bar, 64, qrow);
  }
  __device__ __forceinline__ bool next(Slot& s) {
    if (!walk.next(s.key0, s.nvalid)) return false;
    s.bias = p.kv_bias != nullptr;
    return true;
  }
  __device__ __forceinline__ void issue_k(const Slot& s, uint32_t dst, uint32_t bias_dst,
                                          uint32_t bar) const {
    const int row = static_cast<int>(bh * p.Skv) + s.key0;
    mbar_expect_tx(bar, QK_BYTES + (s.bias ? BIAS_BYTES : 0));
    tma_load(dst, tk, bar, 0, row);
    if (!I8) tma_load(dst + BN * ROW_BYTES, tk, bar, 64, row);
    if (s.bias) bulk_load(bias_dst, p.kv_bias + s.key0, BIAS_BYTES, bar);
  }
  __device__ __forceinline__ void issue_v(const Slot& s, uint32_t dst, uint32_t bar) const {
    const int row = static_cast<int>(bh * p.Skv) + s.key0;
    mbar_expect_tx(bar, KV_BYTES);
    tma_load(dst, tv, bar, 0, row);
    tma_load(dst + BN * ROW_BYTES, tv, bar, 64, row);
  }
  __device__ __forceinline__ float scale_log2() const { return p.scale_log2; }
  __device__ __forceinline__ float qk_factor() const { return I8 ? p.qk_factor[h] : 1.f; }
  // the output and lse rows of CTA row r (0..BM-1)
  __device__ __forceinline__ __nv_bfloat16* out_row(int r) const {
    return p.out + (bh * p.Sq + row0 + r) * D;
  }
  __device__ __forceinline__ float* lse_row(int r) const {
    return p.lse == nullptr ? nullptr : p.lse + bh * p.Sq + row0 + r;
  }
};

// The whole kernel, for a __global__ of its own in each .cu file (so that
// profiles and ptxas reports name flash_sm90_kernel, flash_manual_sm90_kernel,
// sta_pipe_sm90_kernel, sta_window_sm90_kernel and sta_batched_sm90_kernel);
// the maps are the kernel's __grid_constant__ parameters, whose addresses
// TMA reads, held by the source.
// I8: the int8 QK mode (Fast only): q and k are int8 rows of 128 bytes, one
// box each, S the exact int32 sums of wgmma s8 times qk_factor[h].
// Src: the key walk, BlockSource<I8>, WindowSource<RB> or PairBitSource; it
// tells the CTA's q rows (Q by TMA, or by stage_q's plain loads: each
// consumer warpgroup its own 64 rows while the first K/V copies fly), its
// ring slots (next(), issue_k(), issue_v(); prepare() sets up what idle()
// reads, with every thread of the CTA; stage_shared() fills its own shared
// region before the producer starts), its softmax where OWN_SOFTMAX and
// where each output row goes.
template <Softmax SM, bool I8, class Src>
__device__ __forceinline__ void attn_mainloop(Src& src) {
  static_assert(!I8 || SM == Softmax::Fast, "the int8 QK mode is fast-only");
  constexpr Loop L = loop_of<Src>::value;
  constexpr bool CHAINS = L == Loop::Chains || L == Loop::ChainsUnrolled || L == Loop::NoDma;
  constexpr bool WAITS = L != Loop::NoDma;  // the consumers wait for each copy
  static_assert(!CHAINS || SM == Softmax::Online, "the chains are online softmaxes");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // generic pointer to the aligned base
  const uint32_t q_smem = base;
  const uint32_t bar_q = base + BAR_OFF;
  auto k_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto k_empty = [&](int s) { return bar_q + 8 * (1 + STAGES + s); };
  auto v_full = [&](int s) { return bar_q + 8 * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bar_q + 8 * (1 + 3 * STAGES + s); };
  auto k_smem = [&](int s) { return base + Q_BYTES + s * STAGE_BYTES; };
  auto v_smem = [&](int s) { return base + Q_BYTES + s * STAGE_BYTES + KV_BYTES; };

  const int tid = threadIdx.x;
  src.prepare(gbase, tid);  // a source's own set-up that idle() may read (all threads)
  if (src.idle()) {  // nothing to attend: zeros, no barrier touched
    src.write_zeros(tid);
    return;
  }

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), EMPTY_ARRIVALS);
      mbar_init(v_empty(s), EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!Src::Q_BY_TMA) src.stage_shared(gbase, tid);
  __syncthreads();

  Slot slot;
  const int wg = tid / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every copy --------------------------------
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      if constexpr (Src::Q_BY_TMA) src.issue_q(q_smem, bar_q);
      int stage = 0;
      uint32_t phase = 0;
      while (src.next(slot)) {
        // NoDma: the slot's previous copy has landed (its parity phase ^ 1;
        // a fresh barrier passes it), so arming the barrier again is safe
        mbar_wait(L == Loop::NoDma ? k_full(stage) : k_empty(stage), phase ^ 1);
        src.issue_k(slot, k_smem(stage), base + BIAS_OFF + stage * BIAS_BYTES, k_full(stage));
        mbar_wait(L == Loop::NoDma ? v_full(stage) : v_empty(stage), phase ^ 1);
        src.issue_v(slot, v_smem(stage), v_full(stage));
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if constexpr (L == Loop::NoDma) {  // every copy issued has landed before the CTA ends
        for (int s = 0; s < STAGES; ++s) {
          mbar_wait(k_full(s), s < stage ? phase : phase ^ 1);
          mbar_wait(v_full(s), s < stage ? phase : phase ^ 1);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 q rows per warpgroup --------------------------------------
  setmaxnreg_inc<232>();
  const int ltid = tid % 128;
  const int warp = ltid / 32, lane = ltid % 32;
  const int g = lane / 4, t = lane % 4;
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};  // Online: running row max (rows g, g + 8)
  float l_part[2] = {0.f, 0.f};         // this thread's share of the row sums
  float alpha[2] = {1.f, 1.f};
  float s[64];
  uint32_t si[64];  // I8: the int32 scores
  uint32_t pa[32];
  const float qf = src.qk_factor();
  const float scale_log2 = src.scale_log2();
  // S = Q K^T issued on a K slot, and turned into f32 scores once landed
  auto qk = [&](int st) {
    if constexpr (I8)
      issue_qk_s8(si, q_smem, k_smem(st), wg);
    else
      issue_qk(s, q_smem, k_smem(st), wg);
  };
  auto scores = [&]() {
    if constexpr (I8) {
      fence_regs(si);
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = static_cast<float>(static_cast<int>(si[i])) * qf;
    } else {
      fence_regs(s);
    }
  };
  auto bias_of = [&](int st) {
    return slot.bias ? reinterpret_cast<const float*>(gbase + BIAS_OFF + st * BIAS_BYTES)
                     : nullptr;
  };
  // the softmax step on the current slot's scores: softmax_tile on its
  // nvalid, or the source's own (column masks of its own)
  const int row = wg * 64 + warp * 16 + g;  // this thread's CTA rows: row, row + 8
  auto softmax = [&](int st) {
    if constexpr (Src::OWN_SOFTMAX)
      src.template softmax<SM>(s, slot, row, t, scale_log2, bias_of(st), m_run, l_part, alpha);
    else
      softmax_tile<SM, Src::BY8>(s, slot.nvalid, t, scale_log2, bias_of(st), m_run, l_part,
                                 alpha);
  };
  // every warp releases a slot once its last reader (the softmax's bias reads
  // for K, the PV product for V) is done
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto rescale = [&]() {
    if constexpr (SM == Softmax::Online) {
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
  };

  // the chains (CHAINS): the running chain, chain 0's sums once it ended
  uint32_t chain = 0;
  float l_stash[2] = {0.f, 0.f};
  bool stashed = false;

  // Intra-warpgroup overlap: tile j's QK product is issued before tile j-1's
  // PV product, and tile j's softmax runs while that product is in flight;
  // O is rescaled by tile j's alpha once the product has landed.  One step
  // of the loop: the current slot's QK on stage st (phase ph), the previous
  // slot's PV on stage pst (phase pph).
  auto step = [&](int st, uint32_t ph, int pst, uint32_t pph) {
    bool sw = false;  // CHAINS: the first slot of chain 1
    if constexpr (CHAINS) {
      sw = slot.info != chain;
      chain = slot.info;
      if (sw) {  // chain 0's sums stay; chain 1 starts from no max (alpha = 0)
        l_stash[0] = l_part[0];
        l_stash[1] = l_part[1];
        m_run[0] = m_run[1] = NEG_INF;
      }
    }
    if constexpr (WAITS) mbar_wait(k_full(st), ph);
    qk(st);
    if constexpr (WAITS) mbar_wait(v_full(pst), pph);
    issue_pv(o, pa, v_smem(pst));
    wgmma_wait<1>();  // the QK product: the older group
    scores();
    softmax(st);
    if constexpr (WAITS) release(k_empty(st));
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if constexpr (WAITS) release(v_empty(pst));
    if constexpr (CHAINS) {
      if (sw) {  // chain 0's last PV product has landed: its O to the stash
        uint32_t* w = src.stash(gbase) + wg * 128 + ltid;
#pragma unroll
        for (int i = 0; i < 32; ++i) w[i * CONSUMERS * 128] = pack_bf16(o[2 * i], o[2 * i + 1]);
        stashed = true;
      }
    }
    rescale();
    pack_p(pa, s);
  };

  if constexpr (Src::Q_BY_TMA) {
    mbar_wait(bar_q, 0);
  } else {  // this warpgroup's rows by plain loads, visible to wgmma
    src.stage_q(gbase, wg, ltid);
    fence_proxy_async();
    bar_sync(1 + wg, 128);
  }
  if constexpr (L == Loop::DmaOnly) {
    // the copies alone: wait for each slot and release it; O stays 0
    int st = 0;
    uint32_t ph = 0;
    while (src.next(slot)) {
      mbar_wait(k_full(st), ph);
      release(k_empty(st));
      mbar_wait(v_full(st), ph);
      release(v_empty(st));
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
  } else {
    src.next(slot);  // not idle: there is a first slot (chain 0's)
    if constexpr (WAITS) mbar_wait(k_full(0), 0);
    qk(0);
    wgmma_wait<0>();
    scores();
    softmax(0);
    if constexpr (WAITS) release(k_empty(0));
    pack_p(pa, s);
    int pv_stage = 0;
    uint32_t pv_phase = 0;
    if constexpr (L == Loop::ChainsUnrolled) {
      // slot 2m + 1 on stage 1, slot 2m + 2 on stage 0; ph: the phase of slot 2m + 1
      static_assert(STAGES == 2, "the loop is unrolled by the ring's two stages");
      for (uint32_t ph = 0;; ph ^= 1) {
        if (!src.next(slot)) {
          pv_stage = 0;
          pv_phase = ph;
          break;
        }
        step(1, ph, 0, ph);
        if (!src.next(slot)) {
          pv_stage = 1;
          pv_phase = ph;
          break;
        }
        step(0, ph ^ 1, 1, ph);
      }
    } else {
      int stage = 1 % STAGES;
      uint32_t phase = STAGES == 1;
      while (src.next(slot)) {
        step(stage, phase, pv_stage, pv_phase);
        pv_stage = stage;
        pv_phase = phase;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    if constexpr (WAITS) mbar_wait(v_full(pv_stage), pv_phase);
    issue_pv(o, pa, v_smem(pv_stage));
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (CHAINS) {
      if (stashed) {  // chain 0's O and sums join chain 1's
        const uint32_t* w = src.stash(gbase) + wg * 128 + ltid;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const uint32_t x = w[i * CONSUMERS * 128];
          o[2 * i] += __uint_as_float(x << 16);
          o[2 * i + 1] += __uint_as_float(x & 0xFFFF0000u);
        }
        l_part[0] += l_stash[0];
        l_part[1] += l_stash[1];
      }
    }
  }

  // ---- epilogue: normalise, write CTA rows wg*64 + 16*warp + g (+ 8) -------------
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float x = quad_sum(l_part[hr]);
    const float l = (x == 0.f) ? 1.f : x;
    const int r = row + 8 * hr;
    if constexpr (SM == Softmax::Online) {
      float* lp = src.lse_row(r);
      if (lp != nullptr && t == 0) *lp = (x == 0.f) ? 1e30f : m_run[hr] + log2f(x);
    }
    __nv_bfloat16* op = src.out_row(r);  // null: a row past the source's q rows
    if (op == nullptr) continue;
    op += 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(op + 8 * n) =
          pack_bf16(o[4 * n + 2 * hr] / l, o[4 * n + 2 * hr + 1] / l);
  }
}

// flash / flash_manual's kernel body over BlockSource.
template <Softmax SM, bool I8 = false>
__device__ __forceinline__ void attn_mainloop(const CUtensorMap& tq, const CUtensorMap& tk,
                                              const CUtensorMap& tv, const Params& p) {
  BlockSource<I8> src(tq, tk, tv, p);
  attn_mainloop<SM, I8>(src);
}

// ---- host side -----------------------------------------------------------------

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library links no libcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// A (rows, D) matrix (the (B, H, S, D) tensor viewed as (B*H*S, D)) in
// boxes of 128 bytes x box_rows rows, 128-byte swizzle: 64 bf16 columns, or
// (int8) all 128 columns as bytes.
inline bool make_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint32_t box_rows,
                     bool int8 = false) {
  auto fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), rows};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * (int8 ? 1 : 2)};
  cuuint32_t box[2] = {int8 ? 128u : 64u, box_rows};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// kern: a __global__ (CUtensorMap, CUtensorMap, CUtensorMap, Params) that
// runs attn_mainloop.  q, k, v: contiguous (B, H, S, D = 128) bf16 (q and k
// int8 where p.qk_factor is set), 16-byte aligned; Sq % BM == 0, block_q %
// BM == 0, block_kv % BN == 0 (the wrappers' rule).
template <class Kernel>
cudaError_t launch(Kernel kern, const void* q, const void* k, const void* v, int B,
                   const Params& p, cudaStream_t stream) {
  if (p.Sq % BM || p.block_q % BM || p.block_kv % BN) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const uint64_t bh = static_cast<uint64_t>(B) * p.H;
  const bool i8 = p.qk_factor != nullptr;
  if (!make_map(&tq, q, bh * p.Sq, BM, i8) || !make_map(&tk, k, bh * p.Skv, BN, i8) ||
      !make_map(&tv, v, bh * p.Skv, BN))
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.Sq / BM, p.H, B), THREADS, SMEM_BYTES, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace vorta
