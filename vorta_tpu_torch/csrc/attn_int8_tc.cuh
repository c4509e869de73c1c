// flash_manual's int8 QK mode with an f32 v on the tensor cores (sm_90a):
// the block-table walk at int8 q / k and f32 v, head dim 128, q and kv
// blocks that are multiples of 128 (ops/flash.py:f32_tc_path, the same rule
// on both sides), in place of csrc/attn_f32.cuh's FFMA core (dp4a scores,
// FFMA PV) there.
//
// User: csrc/flash_manual.cu (flash_manual_int8_tc_kernel).  It replaces the
// int8 QK mode with an f32 v of vorta_tpu/ops/flash_manual.py:_kernel
// (:125-133: the scores are the int32 sums q.k times qkc_ref[h]; the fast
// softmax's PV at :165-177 in f32, since P takes v's dtype).  Semantics are
// the FFMA core's int8 mode (csrc/attn_f32.cuh, "The int8 QK mode"): s =
// f32(q.k) * qkc[h] with no FMA (the head's qk_scale * scale * log2(e)),
// then + kv_bias; the tail rule cuts block last_block at valid_in_block; p =
// exp2(s), 0 on a cut key; a row with l = 0 (a count-0 q block, a routed-away
// head) writes 0 and reads no v.
//
// Bound on this card: operations.  A 64-row q tile against a 64-key chunk is
// 2 * 64 * 64 * 128 int8 operations for S (exact on the int8 tensor cores,
// 1,979 TOPS) and as many f32 FLOP for PV, three TF32 products (3xTF32,
// csrc/attn_f32_tc.cuh) at 495 TFLOP/s: PV takes twelve times the scores'
// time.  The design:
//
// - S = Q K^T: wgmma m64n64k32 .s32.s8.s8, Q and K int8 rows of 128 bytes
//   (one 128-byte swizzled box a row, K-major both, as the bf16 path's int8
//   mode, csrc/attn_sm90.cuh).  The int32 sums are exact (|q.k| <= 127^2 x
//   128 < 2^24), so their conversion to f32 is too.
// - PV: the 3xTF32 products of csrc/attn_f32_tc.cuh, O += Ps Vb + Pb Vs +
//   Pb Vb, P split in registers (the s32 accumulator has the f32 one's
//   per-thread layout, so S's registers are P's A fragments once V^T's keys
//   are permuted within each group of 8), V^T's halves from the split
//   pre-pass (f32_tc_split_t_kernel: V transposed, cut keys stored as 0, so
//   that a masked P of 0 never meets a NaN).  q and k need no split.  Each
//   chunk's PV product lands in a fresh accumulator and joins O by an add on
//   the CUDA cores (the tensor core's accumulation truncates: over FULL's
//   31,200 keys O would drift past the 1e-4 gate).
// - CTA: 128 q rows of one (batch, head), two consumer warpgroups of 64 rows
//   each and a producer warpgroup whose first thread issues every copy
//   (setmaxnreg: 40 registers for the producer, 232 for the consumers).
//   The int8 tiles are small (Q 16 KB, a 64-key K chunk 8 KB against the f32
//   core's 128 KB of Q and K halves), so the room goes to the PV operand:
//   both warpgroups read each V^T chunk (64 KB of halves), which halves V^T's
//   traffic a q row, and while one warpgroup runs its softmax and splits the
//   other's products keep the tensor cores busy.
// - Shared memory: Q, two stages of K (with their 256 B of kv_bias by bulk
//   copy) and two stages of V^T's halves (each two boxes of 32 keys x 128
//   rows a half), 162 KB: one CTA an SM.  Full / empty mbarriers per stage;
//   the empty ones take one arrival per consumer warp.
// - Masked keys: a chunk past the tail rule's limit is skipped; a cut
//   chunk's columns past nvalid give p = 0 by select.  A CTA with nothing to
//   attend writes zeros before any barrier.
//
// What stays on csrc/attn_f32.cuh's FFMA int8 mode (the wrapper's rule):
// head dim 64 and blocks that 128 does not divide (the tiny models), and the
// yardstick ops/flash_manual.py:sparse_flash_attention_manual_ffma.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_f32.cuh"
#include "attn_f32_tc.cuh"
#include "attn_sm90.cuh"

namespace vorta {
namespace i8tc {

constexpr int D = 128;                     // head dim
constexpr int BK = 64;                     // keys per chunk
constexpr int CONSUMERS = 2;               // warpgroups of 64 q rows
constexpr int BQ = 64 * CONSUMERS;         // q rows per CTA
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int KST = 2, VST = 2;            // stages of K and of V^T
constexpr int Q_BYTES = BQ * D;            // int8
constexpr int K_BYTES = BK * D;            // int8
constexpr int VT_BYTES = D * BK * 4;       // one half of a V^T chunk
constexpr int BIAS_BYTES = BK * 4;
constexpr int K_OFF = Q_BYTES;
constexpr int V_OFF = K_OFF + KST * K_BYTES;
constexpr int BIAS_OFF = V_OFF + VST * 2 * VT_BYTES;
constexpr int BAR_OFF = BIAS_OFF + KST * BIAS_BYTES;  // q_full, k_full/empty, v_full/empty
constexpr int SMEM_BYTES = BAR_OFF + (1 + 2 * KST + 2 * VST) * 8 + 1024;  // + alignment slack
static_assert(SMEM_BYTES <= 232448, "shared memory of one H100 block");
static_assert(K_OFF % 1024 == 0 && V_OFF % 1024 == 0 && K_BYTES % 1024 == 0,
              "128-byte-swizzled tiles on 1,024-byte boundaries");

// D (+)= A B^T in s32, m64n64k32, int8 A and B from shared memory (K-major both)
__device__ __forceinline__ void wgmma_ss_s8_n64(uint32_t (&d)[32], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S = Q K^T in exact int32 sums for warpgroup wg's 64 rows against a 64-key
// chunk (issued and waited).
__device__ __forceinline__ void qk_product(uint32_t (&si)[32], uint32_t q_tile, int wg,
                                           uint32_t k_tile) {
  sm90::fence_regs(si);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk)
    wgmma_ss_s8_n64(si, sm90::kmajor_desc(q_tile, BQ, wg * 64, kk),
                    sm90::kmajor_desc(k_tile, BK, 0, kk), kk > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(si);
}

// The kernel body: CTA (blockIdx.x = Sq / BQ tile, h, b) over TableParams p
// (the tables, kv_bias (Skv,) or null, the tail rule; p.k and p.v unused:
// the tiles come by TMA) with tq / tk over the int8 q / k rows (B H S, 128
// bytes) in boxes of BQ / BK rows and tv over V^T's halves (2 B H 128, Skv)
// f32 in boxes of 32 keys x 128 rows, all with the 128-byte swizzle.  out:
// (B, H, Sq, 128) f32; qkc: (H,) f32 qk_scale * scale * log2(e).
__device__ __forceinline__ void attend(const CUtensorMap& tq, const CUtensorMap& tk,
                                       const CUtensorMap& tv, const f32::TableParams& p,
                                       float* __restrict__ out, const float* __restrict__ qkc) {
  using namespace sm90;
  const int h = blockIdx.y, row0 = blockIdx.x * BQ;  // inside one q block (block_q % BQ == 0)
  const int qi = row0 / p.block_q;
  const long long bh = static_cast<long long>(blockIdx.z) * p.H + h;
  const long long grow0 = bh * p.Sq + row0;  // the CTA's first row of (B*H*Sq)
  const int count = p.kv_count[(p.cnt_shared ? 0 : h) * p.nq + qi];
  const int tid = threadIdx.x;
  if (count == 0) {  // routed away or past the table: zeros, no barrier touched
    float4* o4 = reinterpret_cast<float4*>(out + grow0 * D);
    for (int e = tid; e < BQ * D / 4; e += THREADS) o4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  f32tc::ChunkWalk<BK> walk{
      p.kv_index + static_cast<long long>((p.idx_shared ? 0 : h) * p.nq + qi) * p.width, count,
      p.block_kv, p.last_block, p.valid_in_block};

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // generic pointer to the aligned base
  const uint32_t q_full = base + BAR_OFF;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + KST + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + 2 * KST + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 2 * KST + VST + s); };
  auto k_tile = [&](int s) { return base + K_OFF + s * K_BYTES; };
  auto vt_tile = [&](int s) { return base + V_OFF + s * 2 * VT_BYTES; };  // Vb^T, then Vs^T
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < KST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), CONSUMERS * 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < VST; ++s) {
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.kv_bias == nullptr) {  // no bias: the bias slots hold zeros for the whole walk
    float* bz = reinterpret_cast<float*>(gbase + BIAS_OFF);
    for (int e = tid; e < KST * BK; e += THREADS) bz[e] = 0.f;
  }
  __syncthreads();
  int key0, nvalid;
  const int wg = tid / 128;

  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every copy ------------------------------------
    setmaxnreg_dec<40>();
    if (tid != CONSUMERS * 128) return;
    const int vrows = gridDim.z * p.H * D, vrow = static_cast<int>(bh) * D;
    mbar_expect_tx(q_full, Q_BYTES);
    tma_load(base, &tq, q_full, 0, static_cast<int>(grow0));
    for (int c = 0; walk.next(key0, nvalid); ++c) {
      const int ks = c % KST, vs = c % VST;
      mbar_wait(k_empty(ks), ((c / KST) & 1) ^ 1);  // a fresh barrier passes parity 1
      mbar_expect_tx(k_full(ks), K_BYTES + (p.kv_bias != nullptr ? BIAS_BYTES : 0));
      tma_load(k_tile(ks), &tk, k_full(ks), 0, static_cast<int>(bh * p.Skv) + key0);
      if (p.kv_bias != nullptr)
        bulk_load(base + BIAS_OFF + ks * BIAS_BYTES, p.kv_bias + key0, BIAS_BYTES, k_full(ks));
      mbar_wait(v_empty(vs), ((c / VST) & 1) ^ 1);
      mbar_expect_tx(v_full(vs), 2 * VT_BYTES);
      for (int half = 0; half < 2; ++half)
        for (int b = 0; b < 2; ++b)
          tma_load(vt_tile(vs) + half * VT_BYTES + b * D * 128, &tv, v_full(vs), key0 + 32 * b,
                   half * vrows + vrow);
    }
    return;
  }

  // ---- consumers: 64 rows each, S and O in registers ------------------------------------
  setmaxnreg_inc<232>();
  const int ltid = tid % 128, w = ltid / 32, lane = ltid % 32, g = lane / 4, t = lane % 4;
  const float qf = qkc[h];
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float l[2] = {0.f, 0.f};
  uint32_t si[32], pb[32], ps[32];
  auto release = [&](uint32_t bar) {  // every warp, once its last reader is done
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  mbar_wait(q_full, 0);
  for (int c = 0; walk.next(key0, nvalid); ++c) {
    const int ks = c % KST, vs = c % VST;
    mbar_wait(k_full(ks), (c / KST) & 1);
    qk_product(si, base, wg, k_tile(ks));
    // s = f32(q.k) * qkc[h], unfused (the plain version's f32 product of the exact
    // sum), + bias; p = exp2(s), 0 past nvalid; split into TF32 halves
    const float* bs = reinterpret_cast<const float*>(gbase + BIAS_OFF + ks * BIAS_BYTES);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {  // columns 8n + 2t and 8n + 2t + 1
      const float2 b = *reinterpret_cast<const float2*>(bs + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        const float x =
            __fmul_rn(static_cast<float>(static_cast<int>(si[i])), qf) + ((e & 1) ? b.y : b.x);
        const float pv = 8 * n + 2 * t + (e & 1) < nvalid ? exp2f(x) : 0.f;
        l[e >> 1] += pv;
        f32tc::split(pv, pb[i], ps[i]);
      }
    }
    release(k_empty(ks));
    mbar_wait(v_full(vs), (c / VST) & 1);
    float oc[64];
    f32tc::pv_product(oc, pb, ps, vt_tile(vs), vt_tile(vs) + VT_BYTES);
    release(v_empty(vs));
    // the chunk's product joins O in the CUDA cores' rounding to nearest
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] += oc[i];
  }

  // ---- epilogue: rows 64 wg + 16 w + g (+ 8) ------------------------------------------
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float x = quad_sum(l[hr]);
    const float inv = x == 0.f ? 0.f : 1.f / x;
    float* orow = out + (grow0 + 64 * wg + 16 * w + g + 8 * hr) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[4 * n + 2 * hr] * inv, o[4 * n + 2 * hr + 1] * inv);
  }
}

// ---- host side ---------------------------------------------------------------------

// Split V^T into work (2 B H Skv 128 f32, 16-byte aligned: its big and small
// halves, keys permuted, cut keys 0), then launch kern<<<(Sq / BQ, H, B),
// THREADS, SMEM_BYTES>>>(tq, tk, tv, args...).  q, k: contiguous (B, H, S,
// 128) int8, v (B, H, Skv, 128) f32, all 16-byte aligned; the shapes of
// f32tc::path_holds (ops/flash.py:f32_tc_path).  The CUDA error code.
template <class Kern, class... Args>
cudaError_t launch(Kern kern, const void* q, const void* k, const void* v, void* work, int B,
                   const f32::TableParams& p, cudaStream_t st, Args... args) {
  if (!f32tc::path_holds(p.D, p.block_q, p.block_kv) || p.block_q % BQ || p.kb != 1 ||
      work == nullptr)
    return cudaErrorInvalidValue;
  float* wv = static_cast<float*>(work);
  f32tc::f32_tc_split_t_kernel<<<dim3((p.Skv + f32tc::BK - 1) / f32tc::BK, B * p.H), 256, 0, st>>>(
      static_cast<const float*>(v), reinterpret_cast<uint32_t*>(wv), B * p.H, p.Skv, p.block_kv,
      p.last_block, p.valid_in_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  const uint64_t bh = static_cast<uint64_t>(B) * p.H;
  if (!sm90::make_map(&tq, q, bh * p.Sq, BQ, true) || !sm90::make_map(&tk, k, bh * p.Skv, BK, true) ||
      !f32tc::make_map(&tv, wv, 2 * bh * D, p.Skv, D))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.Sq / BQ, p.H, B), THREADS, SMEM_BYTES, st>>>(tq, tk, tv, args...);
  return cudaGetLastError();
}

}  // namespace i8tc
}  // namespace vorta
