// Block-sparse flash attention forward with an exact per-row kv loop and
// the fast softmax, for Hopper (sm_90a).
//
// Replaces vorta_tpu/ops/flash_manual.py:_kernel (reached through
// sparse_flash_attention_manual) in its routed-expert form: for q block i of
// head h, visit the kv blocks kv_index[th, i, :kv_count[tc, i]] (th / tc = 0
// when the index table / the counts are shared by all heads), so a row
// routed away (count 0) costs one block launch and writes zeros.  q arrives
// pre-scaled by scale * log2(e) (rounded to bf16 by the wrapper, as the JAX
// wrapper rounds it); p = exp2(q.k) with no running max (qk-normed inputs),
// masked entries give p = 0, a kv_valid_len tail mask on block
// kv_valid_len // block_kv only, P rounded to bf16 before the PV product,
// rows normalised by l (l == 0 -> 0).  An optional kv_bias, a (1, Skv) f32
// additive logits bias shared by every batch row and head (the joint
// experts' text-padding mask, -1e30 on padded keys), is added to the
// pre-scaled scores as the TPU kernel adds it (flash_manual.py:144-148):
// p = exp2(q.k + bias), so a masked key gives exactly 0 whatever block it
// lies in, and it combines with the kv_valid_len tail rule.
//
// Bound on this card: the FULL expert at Wan-1.3B 480p x 77f (31,200
// tokens, d = 128) does 4 * 31,200^2 * 128 = 5.0e11 FLOP per routed head
// against 24 MB of operands, so the tensor cores bound it (0.504 ms per head
// at 989 TFLOP/s bf16).
//
// Two designs, chosen per call by the wrapper's shape and mode rule
// (ops/flash_manual.py:manual_wgmma_path, the same rule on both sides):
//
// - The Hopper path (the fast softmax, bf16 or int8 q / k, D = 128, block_q
//   and block_kv multiples of 128: every served geometry, Wan's FULL and
//   LOWRES, Hunyuan's joint FULL / LOWRES with kv_bias and its STA text rows
//   at 256 x 1024): csrc/attn_sm90.cuh's mainloop with the fast policy, p =
//   exp2(q.k + bias) with no running max (flash_manual_sm90_kernel, and
//   flash_manual_sm90_kernel_i8 for the int8 QK mode).  128-row CTAs of two
//   consumer warpgroups and a producer warpgroup; Q and a two-slot ring of
//   128-key K/V tiles (and their 512 B of kv_bias) loaded by TMA with
//   mbarriers; both products on wgmma, each tile's softmax running while
//   the previous tile's PV product is in flight.  A CTA whose count is 0 (a
//   head routed away, q blocks past valid_len) writes zeros and exits.
// - The mma.sync path (D = 64, other blocks, and the stable softmax),
//   below: mma.sync m16n8k16, Q fragments in registers for the whole sweep,
//   64-row K/V sub-tiles staged in shared memory by the block's 4 warps;
//   without the running max there is no rescaling of the accumulator, so
//   each sub-tile costs the two products, one exp2 per score and the row
//   sums.
//
// The int8 QK mode (qk_scale, flash_manual.py:125-133): q and k arrive as
// int8 (symmetric per-head quantization), q not pre-scaled, with an (H,) f32
// qk_scale = q_scale * k_scale; the scores are the exact int32 sums of
// wgmma s8 m64n128k32 on the Hopper path (a row of 128 int8 is one 128-byte
// box; both operands K-major, as s8 requires) or of mma.sync m16n8k32 s8
// (mma_s8.cuh) on the other, turned into f32 by one multiply with
// qk_scale[h] * scale * log2(e), before the bias and the tail rule.  Q's and
// K's tiles halve; V, P and the PV product stay bf16.  The card runs int8
// at twice the bf16 rate (1,979 vs 989 T/s dense), so the QK half of the
// work is bounded at half the time.  With an f32 v (the JAX CLI's
// --qk_int8 --dtype fp32) the f32 mode's kernels take int8 q / k instead:
// flash_manual_int8_tc_kernel (csrc/attn_int8_tc.cuh: wgmma s8 scores,
// 3xTF32 PV on wgmma) where ops/flash.py:f32_tc_path holds (every served
// call), else flash_manual_f32_kernel<D, true> (csrc/attn_f32.cuh's int8 QK:
// exact int32 sums by dp4a, FFMA PV); both multiply the sums by
// qk_scale[h] * scale * log2(e), P and PV in f32.
//
// The stable softmax (STABLE; flash_manual.py:140-169, the JAX wrapper's
// default): q is NOT pre-scaled; the f32 scores are scaled by
// sl = scale * log2(e) after the product, then kv_bias is added and the
// masked columns (the kv_valid_len tail) set to -1e30; a running max per
// row with the TPU kernel's m_safe (0 while the max is still -1e30), the
// sums and the accumulator rescaled by exp2(m_old - m_safe) at every
// sub-tile (stable_update, mma_bf16.cuh).  Counts 0 and rows that see
// nothing still give 0.  bf16 q / k only (the int8 mode is fast-only).
#include <type_traits>

#include "attn_sm90.cuh"
#include "attn_f32.cuh"
#include "attn_f32_tc.cuh"
#include "attn_int8_tc.cuh"
#include "mma_s8.cuh"

namespace {

using namespace vorta;

constexpr int BLOCK_N = 64;  // kv rows per shared-memory sub-tile

// I8: q and k are int8 (qk_scale mode), handled as rows of DK = D / 2 b16
// values; else bf16, DK = D.
template <int D, int WARPS, bool I8, bool STABLE>
__global__ void __launch_bounds__(WARPS * 32)
flash_manual_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    const int* __restrict__ kv_index, const int* __restrict__ kv_count,
                    const float* __restrict__ kv_bias, const float* __restrict__ qkc,
                    int H, int Sq, int Skv, int nq, int width, int shared_idx, int shared_cnt,
                    int block_q, int block_kv, int last_block, int valid_in_block, float sl) {
  static_assert(!(I8 && STABLE), "the int8 mode is fast-only");
  constexpr int BLOCK_M = 16 * WARPS;
  constexpr int DK = I8 ? D / 2 : D;  // a q / k row in b16 units
  constexpr int LDK = DK + 8;  // padded rows: conflict-free ldmatrix
  constexpr int LDS = D + 8;
  constexpr int NT_S = BLOCK_N / 8;
  constexpr int NT_O = D / 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per V row
  __shared__ __align__(16) __nv_bfloat16 Ks[BLOCK_N * LDK];
  __shared__ __align__(16) __nv_bfloat16 Vs[BLOCK_N * LDS];
  __shared__ float Bs[BLOCK_N];  // the sub-tile's slice of kv_bias (0 without one)

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * BLOCK_M;
  const int qi = row0 / block_q;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const __nv_bfloat16* qp = q + (bh * Sq + row0 + warp * 16) * DK;
  const __nv_bfloat16* kp = k + bh * Skv * DK;
  const __nv_bfloat16* vp = v + bh * Skv * D;

  uint32_t qa[DK / 16][4];
  load_q_frags<DK>(qa, qp + g * DK, qp + (g + 8) * DK, t);
  const float qk_factor = I8 ? qkc[h] : 1.f;
  float oacc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float l_part[2] = {0.f, 0.f};  // this thread's share of the row sums
  float m_run[2] = {NEG_INF, NEG_INF};  // STABLE: the running row max

  const int count = kv_count[(shared_cnt ? 0 : h) * nq + qi];
  const int* idx = kv_index + static_cast<size_t>((shared_idx ? 0 : h) * nq + qi) * width;

  for (int j = 0; j < count; ++j) {
    const int kvb = idx[j];
    const int limit_blk = (kvb == last_block) ? valid_in_block : block_kv;
    for (int n0 = 0; n0 < block_kv; n0 += BLOCK_N) {
      const int rows = min(BLOCK_N, block_kv - n0);
      const int nvalid = min(rows, limit_blk - n0);
      if (nvalid <= 0) continue;  // fully masked: adds nothing to acc or l
      const size_t base = static_cast<size_t>(kvb) * block_kv + n0;
      __syncthreads();  // previous sub-tile fully consumed
      if constexpr (I8) {
        // K's rows are half as long as V's: one pass each (a merged pass,
        // as below, ran this mode 1.4x slower on the H100)
        for (int e = tid; e < BLOCK_N * DK / 8; e += WARPS * 32) {
          const int r = e / (DK / 8), c = (e % (DK / 8)) * 8;
          *reinterpret_cast<uint4*>(Ks + r * LDK + c) =
              r < rows ? *reinterpret_cast<const uint4*>(kp + (base + r) * DK + c)
                       : make_uint4(0, 0, 0, 0);
        }
        for (int e = tid; e < BLOCK_N * CHUNKS; e += WARPS * 32) {
          const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
          *reinterpret_cast<uint4*>(Vs + r * LDS + c) =
              r < rows ? *reinterpret_cast<const uint4*>(vp + (base + r) * D + c)
                       : make_uint4(0, 0, 0, 0);
        }
      } else {
        // one pass, both loads issued before the stores
        for (int e = tid; e < BLOCK_N * CHUNKS; e += WARPS * 32) {
          const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
          uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
          if (r < rows) {
            kv4 = *reinterpret_cast<const uint4*>(kp + (base + r) * D + c);
            vv4 = *reinterpret_cast<const uint4*>(vp + (base + r) * D + c);
          }
          *reinterpret_cast<uint4*>(Ks + r * LDK + c) = kv4;
          *reinterpret_cast<uint4*>(Vs + r * LDS + c) = vv4;
        }
      }
      for (int r = tid; r < BLOCK_N; r += WARPS * 32)
        Bs[r] = (kv_bias != nullptr && r < rows) ? kv_bias[base + r] : 0.f;
      __syncthreads();

      float s[NT_S][4];
      if constexpr (I8)
        qk_tile_s8<DK, NT_S, LDK>(s, qa, Ks, qk_factor, lane);
      else
        qk_tile<D, NT_S, LDS>(s, qa, Ks, lane);
      if constexpr (STABLE) {
#pragma unroll
        for (int n = 0; n < NT_S; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n * 8 + 2 * t + (e & 1);
            s[n][e] = (col < nvalid) ? s[n][e] * sl + Bs[col] : NEG_INF;
          }
        stable_update<NT_S, NT_O>(s, m_run, l_part, oacc);
      } else {
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n * 8 + 2 * t + (e & 1);
            const float p = (col < nvalid) ? exp2f(s[n][e] + Bs[col]) : 0.f;
            s[n][e] = p;
            l_part[e >> 1] += p;
          }
        }
      }
      pv_tile<D, NT_S, LDS>(oacc, s, Vs, lane);
    }
  }

  const float l0 = row_sum(l_part[0]), l1 = row_sum(l_part[1]);
  __nv_bfloat16* op = out + (bh * Sq + row0 + warp * 16) * D;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(op + g * D + c) = pack_bf16(oacc[n][0] / l0, oacc[n][1] / l0);
    *reinterpret_cast<uint32_t*>(op + (g + 8) * D + c) =
        pack_bf16(oacc[n][2] / l1, oacc[n][3] / l1);
  }
}

template <int D, int WARPS, bool I8, bool STABLE>
cudaError_t launch(dim3 grid, cudaStream_t st, const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, const int* ki, const int* kc,
                   const float* bias, const float* qkc, int H, int Sq, int Skv, int nq,
                   int width, int shared_idx, int shared_cnt, int block_q, int block_kv,
                   int last_block, int valid_in_block, float sl) {
  flash_manual_kernel<D, WARPS, I8, STABLE><<<grid, WARPS * 32, 0, st>>>(
      q, k, v, out, ki, kc, bias, qkc, H, Sq, Skv, nq, width, shared_idx, shared_cnt, block_q,
      block_kv, last_block, valid_in_block, sl);
  return cudaGetLastError();
}

// The Hopper path (csrc/attn_sm90.cuh) with the fast softmax and kv_bias.
__global__ void __launch_bounds__(sm90::THREADS, 1)
flash_manual_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ sm90::Params p) {
  sm90::attn_mainloop<sm90::Softmax::Fast>(tq, tk, tv, p);
}

// The same with int8 q / k (the qk_scale mode): S from wgmma s8.
__global__ void __launch_bounds__(sm90::THREADS, 1)
flash_manual_sm90_kernel_i8(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ sm90::Params p) {
  sm90::attn_mainloop<sm90::Softmax::Fast, true>(tq, tk, tv, p);
}

}  // namespace

// q (pre-scaled), k, v, out: contiguous (B, H, S, D) bf16.  kv_index
// (idx_heads, nq, width), kv_count (cnt_heads, nq): int32 on the device,
// idx_heads / cnt_heads 1 or H; kv_bias: (Skv,) f32 on the device, or null.
// qk_factor: null, or (H,) f32 qk_scale * scale * log2(e) on the device,
// and then q and k are int8 (q not pre-scaled).  stable: the stable softmax,
// q not pre-scaled, scores scaled by sl = scale * log2(e) (bf16 q / k only).
// hopper: the wrapper's rule chose the Hopper path (the fast softmax, bf16
// or int8 q / k, D = 128, block_q and block_kv multiples of 128; kv_bias
// 16-byte aligned; anything else there is an error, never a fallback).  Returns the CUDA
// error code.
extern "C" int vorta_flash_manual_fwd_bf16(const void* q, const void* k, const void* v,
                                           void* out, const void* kv_index,
                                           const void* kv_count, const void* kv_bias,
                                           const void* qk_factor, int B, int H, int Sq,
                                           int Skv, int D, int idx_heads, int cnt_heads, int nq,
                                           int width, int block_q, int block_kv,
                                           int kv_valid_len, int stable, float sl,
                                           int hopper, void* stream) {
  if (Sq % block_q || Skv % block_kv || block_q % 16 || (D != 64 && D != 128) ||
      (idx_heads != 1 && idx_heads != H) || (cnt_heads != 1 && cnt_heads != H) ||
      nq != Sq / block_q || (stable && qk_factor != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int has_tail = kv_valid_len % block_kv != 0;
  const int last_block = has_tail ? kv_valid_len / block_kv : -1;
  const int valid_in_block = kv_valid_len % block_kv;
  if (hopper) {  // the wrapper's rule picked the Hopper path: its shapes or an error
    if (D != sm90::D || stable) return static_cast<int>(cudaErrorInvalidValue);
    const sm90::Params p{static_cast<__nv_bfloat16*>(out), nullptr,
                         static_cast<const int*>(kv_index), static_cast<const int*>(kv_count),
                         static_cast<const float*>(kv_bias), H, Sq, Skv, nq, width,
                         idx_heads == 1, cnt_heads == 1, block_q, block_kv, last_block,
                         valid_in_block, 0.f, static_cast<const float*>(qk_factor)};
    auto st = static_cast<cudaStream_t>(stream);
    return static_cast<int>(
        qk_factor != nullptr ? sm90::launch(flash_manual_sm90_kernel_i8, q, k, v, B, p, st)
                             : sm90::launch(flash_manual_sm90_kernel, q, k, v, B, p, st));
  }
  const int warps = (block_q % 64 == 0) ? 4 : 1;
  const dim3 grid(Sq / (16 * warps), H, B);
  auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* kk = static_cast<const __nv_bfloat16*>(k);
  auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  auto* ki = static_cast<const int*>(kv_index);
  auto* kc = static_cast<const int*>(kv_count);
  auto* kb = static_cast<const float*>(kv_bias);
  auto* qf = static_cast<const float*>(qk_factor);
  auto st = static_cast<cudaStream_t>(stream);
  const int si = idx_heads == 1, sc = cnt_heads == 1;
  auto run = [&](auto launcher) {
    return launcher(grid, st, qq, kk, vv, oo, ki, kc, kb, qf, H, Sq, Skv, nq, width, si, sc,
                    block_q, block_kv, last_block, valid_in_block, sl);
  };
  cudaError_t err;
  if (qf != nullptr) {
    if (D == 128)
      err = warps == 4 ? run(launch<128, 4, true, false>) : run(launch<128, 1, true, false>);
    else
      err = warps == 4 ? run(launch<64, 4, true, false>) : run(launch<64, 1, true, false>);
  } else if (stable) {
    if (D == 128)
      err = warps == 4 ? run(launch<128, 4, false, true>) : run(launch<128, 1, false, true>);
    else
      err = warps == 4 ? run(launch<64, 4, false, true>) : run(launch<64, 1, false, true>);
  } else if (D == 128) {
    err = warps == 4 ? run(launch<128, 4, false, false>) : run(launch<128, 1, false, false>);
  } else {
    err = warps == 4 ? run(launch<64, 4, false, false>) : run(launch<64, 1, false, false>);
  }
  return static_cast<int>(err);
}

// ---- the f32 mode: csrc/attn_f32.cuh's FFMA core over the block tables, and
// csrc/attn_f32_tc.cuh's tensor-core core where ops/flash.py:f32_tc_path holds

namespace {

// I8: int8 q / k with an f32 v (the int8 QK mode of the f32 path): the
// scores are the exact int32 sums (dp4a) times qkc[h].
template <int D, bool I8>
__global__ void __launch_bounds__(vorta::f32::THREADS, 2)
flash_manual_f32_kernel(const void* __restrict__ q, float* __restrict__ out,
                        const __grid_constant__ vorta::f32::TableParams p, float mul,
                        const float* __restrict__ qkc, int stable) {
  const vorta::f32::TableWalk<false> walk(p);
  vorta::f32::attend<D, vorta::f32::TableWalk<false>, I8>(walk, q, out, I8 ? qkc[walk.h] : mul,
                                                          stable != 0);
}

// The tensor-core f32 core (csrc/attn_f32_tc.cuh: 3xTF32 on wgmma), D = 128,
// f32 q / k (not the int8 mode), either softmax, kv_bias in p.
__global__ void __launch_bounds__(vorta::f32tc::THREADS, 1)
flash_manual_f32_tc_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ vorta::f32::TableParams p,
                           float* __restrict__ out, float mul, int stable) {
  vorta::f32tc::attend(tq, tk, tv, p, out, nullptr, mul, stable != 0);
}

// The int8 QK mode with an f32 v on the tensor cores (csrc/attn_int8_tc.cuh:
// wgmma s8 scores, 3xTF32 PV), D = 128, the fast softmax, kv_bias in p.
__global__ void __launch_bounds__(vorta::i8tc::THREADS, 1)
flash_manual_int8_tc_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ vorta::f32::TableParams p,
                            float* __restrict__ out, const float* __restrict__ qkc) {
  vorta::i8tc::attend(tq, tk, tv, p, out, qkc);
}

}  // namespace

// The f32 mode (flash_manual.py's kernel at f32 inputs): q, k, v, out
// contiguous (B, H, S, D) f32; the tables, kv_bias and the tail rule as for
// vorta_flash_manual_fwd_bf16; block_q and block_kv multiples of 8, D 64 or
// 128.  stable: the stable softmax, q not pre-scaled, the scores times sl =
// scale * log2(e); else the fast one, q pre-scaled in f32 by the wrapper.
// P kept in f32.  qk_factor: null, or (H,) f32 qk_scale * scale * log2(e)
// on the device with q and k int8 (q not pre-scaled; the fast softmax): the
// int8 QK mode with an f32 v.  work: null, or where the wrapper's rule
// (ops/flash.py:f32_tc_path) chose the tensor cores (D = 128, blocks
// multiples of 128; anything else there is an error, never a fallback),
// scratch 16-byte aligned for the split halves of q, k and V^T (f32 q / k:
// 2 B H (Sq + 2 Skv) 128 f32, csrc/attn_f32_tc.cuh) or of V^T alone (the
// int8 mode: 2 B H Skv 128 f32, csrc/attn_int8_tc.cuh); null: the FFMA
// core.  Returns the CUDA error code.
extern "C" int vorta_flash_manual_fwd_f32(const void* q, const void* k, const void* v,
                                          void* out, const void* kv_index, const void* kv_count,
                                          const void* kv_bias, const void* qk_factor, int B,
                                          int H, int Sq, int Skv, int D, int idx_heads,
                                          int cnt_heads, int nq, int width, int block_q,
                                          int block_kv, int kv_valid_len, int stable, float sl,
                                          void* work, void* stream) {
  if (Sq % block_q || Skv % block_kv || block_q % 8 || block_kv % 8 || (D != 64 && D != 128) ||
      (idx_heads != 1 && idx_heads != H) || (cnt_heads != 1 && cnt_heads != H) ||
      nq != Sq / block_q || (qk_factor && stable))
    return static_cast<int>(cudaErrorInvalidValue);
  const int has_tail = kv_valid_len % block_kv != 0;
  const bool i8 = qk_factor != nullptr;
  const vorta::f32::TableParams p{
      k, static_cast<const float*>(v), static_cast<const int*>(kv_index),
      static_cast<const int*>(kv_count), nullptr, nullptr, static_cast<const float*>(kv_bias),
      H, Sq, Skv, D, nq, width, idx_heads == 1, cnt_heads == 1, block_q, block_kv,
      has_tail ? kv_valid_len / block_kv : -1, kv_valid_len % block_kv, 1, 1, i8 ? 1 : 4};
  const float mul = stable ? sl : 1.f;
  auto st = static_cast<cudaStream_t>(stream);
  auto* oo = static_cast<float*>(out);
  auto* qf = static_cast<const float*>(qk_factor);
  if (work != nullptr)
    return static_cast<int>(
        i8 ? vorta::i8tc::launch(flash_manual_int8_tc_kernel, q, k, v, work, B, p, st, p, oo, qf)
           : vorta::f32tc::launch(vorta::f32tc::path_holds, flash_manual_f32_tc_kernel, q, k, v,
                                  work, B, p, st, p, oo, mul, stable));
  const dim3 grid = vorta::f32::table_grid(B, p);
  auto run = [&](auto kern, auto d) {
    return vorta::f32::launch<decltype(d)::value>(kern, grid, st, q, oo, p, mul, qf, stable);
  };
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  cudaError_t err;
  if (D == 128)
    err = i8 ? run(flash_manual_f32_kernel<128, true>, D128{})
             : run(flash_manual_f32_kernel<128, false>, D128{});
  else
    err = i8 ? run(flash_manual_f32_kernel<64, true>, D64{})
             : run(flash_manual_f32_kernel<64, false>, D64{});
  return static_cast<int>(err);
}

// The int8 tensor-core kernel's dynamic shared memory (chip_smoke.py's
// build report).
extern "C" int vorta_flash_manual_int8_tc_smem_bytes() { return vorta::i8tc::SMEM_BYTES; }
