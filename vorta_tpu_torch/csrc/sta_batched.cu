// Tile-major block-sparse sliding-tile attention with sub-tile pair bits and
// the fast softmax, for Hopper (sm_90a).
//
// Replaces vorta_tpu/ops/sta_batched.py:_kernel (reached through
// sta_flash_headbatched), the JAX package's STA kernel for tiles too small
// for its window-dense kernels and for the joint layouts whose text length
// is not a multiple of 8.  Same function: q, k, v in tile-major layout;
// q block i (block_q rows) visits the kv blocks kv_index[0, i, :kv_count[0,
// i]] (tables shared by all heads); within a visited block, query row r
// sees key column c where bit (r / tpt) * k_sub + c / tpt of that entry's
// pair-bit word is set (a uint32 word stored as int32; a bit index of 32 or
// more sees nothing, as XLA's logical shift gives); an optional kv_bias,
// (Skv,) f32 shared by every batch row and head, is added to the scores.
// Fast softmax: q arrives pre-scaled by scale * log2(e) (rounded to bf16
// by the wrapper, as the JAX wrapper rounds it), p = exp2(q.k + bias) with
// no running max, masked entries give exactly 0, P rounded to bf16 before
// the PV product, rows normalised by l (l == 0 -> 0: rows that see
// nothing, q blocks with count 0).  Heads whose active entry is 0 write
// zeros.  Block sizes need not be powers of two (HunyuanVideo's (2, 9, 8)
// tile gives 432 / 1008): any multiple of 8.
//
// Bound on this card: at HunyuanVideo-13B 720p x 45f with tile (2, 9, 8)
// (the joint layout, 48,384 rows) the visible pairs are ~3.3e8 per head
// (video rows see 27 tiles of 144 keys and the text; text rows, padding
// included, see everything), 4 * 128 FLOP each: 1.7e11 FLOP per head
// against 50 MB of operands, so the tensor cores bound it.  Design: one
// CUDA block of 4 warps per (64-row chunk of a q block, head, batch); each
// visited kv block is walked in 64-key sub-tiles staged in shared memory,
// and a sub-tile is skipped whole (no load, no mma) where no pair bit links
// the chunk's rows to it or where the bias masks all its keys (exp2 of
// -1e30 is exactly 0, so the skip changes no bit); products on mma.sync
// m16n8k16 (mma_bf16.cuh).  Simple first: no wgmma, TMA or cp.async
// pipelining yet.
//
// The stable softmax (STABLE; sta_batched.py:126-171, the JAX wrapper's
// default): q is not pre-scaled; the f32 scores are scaled by sl = scale *
// log2(e), kv_bias added, the pairs the bits hide set to -1e30; a running
// max per row with the TPU kernel's m_safe, the sums and the accumulator
// rescaled at every sub-tile (stable_update, mma_bf16.cuh).  The skipped
// sub-tiles (no pair bit, or every key masked by the bias) change nothing
// here either: they could only offer -1e30 to the max.
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace vorta;

constexpr int BLOCK_N = 64;  // kv rows per shared-memory sub-tile
constexpr int WARPS = 4;
constexpr int BLOCK_M = 16 * WARPS;
constexpr float LIVE_BIAS = -1e20f;  // a bias at or below it masks its key exactly

__device__ __forceinline__ bool bit_at(uint32_t word, int idx) {
  return idx < 32 && ((word >> idx) & 1u);
}

template <int D, bool STABLE>
__global__ void __launch_bounds__(WARPS * 32)
sta_batched_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                   const int* __restrict__ kv_index, const int* __restrict__ kv_count,
                   const int* __restrict__ pair_bits, const float* __restrict__ kv_bias,
                   const int* __restrict__ active, int H, int Sq, int Skv, int width,
                   int block_q, int block_kv, int tpt, int k_sub, int chunks, float sl) {
  constexpr int LDS = D + 8;  // padded rows: conflict-free ldmatrix
  constexpr int NT_S = BLOCK_N / 8;
  constexpr int NT_O = D / 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 Ks[BLOCK_N * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BLOCK_N * LDS];
  __shared__ float Bs[BLOCK_N];  // the sub-tile's bias (-inf past the block)
  __shared__ int Ct[BLOCK_N];  // the sub-tile's column tiles, col / tpt

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qi = blockIdx.x / chunks;
  const int r0 = (blockIdx.x % chunks) * BLOCK_M;  // first row of the chunk in its q block
  const int rows = min(BLOCK_M, block_q - r0);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const __nv_bfloat16* kp = k + bh * Skv * D;
  const __nv_bfloat16* vp = v + bh * Skv * D;

  const int rg = r0 + warp * 16 + g, rg8 = rg + 8;  // rows in the q block
  const size_t qrow = bh * Sq + static_cast<size_t>(qi) * block_q;
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, rg < block_q ? q + (qrow + rg) * D : nullptr,
                  rg8 < block_q ? q + (qrow + rg8) * D : nullptr, t);
  float oacc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float l_part[2] = {0.f, 0.f};
  float m_run[2] = {NEG_INF, NEG_INF};  // STABLE: the running row max
  const bool has_bits = pair_bits != nullptr;
  const int rt0 = rg / tpt * k_sub, rt1 = rg8 / tpt * k_sub;  // bit offsets of the two rows
  const int mt_lo = r0 / tpt, mt_hi = (r0 + rows - 1) / tpt;  // the chunk's row tiles

  const int count = active[h] ? kv_count[qi] : 0;
  for (int j = 0; j < count; ++j) {
    const size_t entry = static_cast<size_t>(qi) * width + j;
    const int kvb = kv_index[entry];
    const uint32_t bits = has_bits ? static_cast<uint32_t>(pair_bits[entry]) : 0u;
    for (int n0 = 0; n0 < block_kv; n0 += BLOCK_N) {
      const int nvalid = min(BLOCK_N, block_kv - n0);
      if (has_bits) {  // block-uniform: does any row tile of the chunk see this sub-tile?
        bool any = false;
        for (int mt = mt_lo; mt <= mt_hi && !any; ++mt)
          for (int kt = n0 / tpt; kt <= (n0 + nvalid - 1) / tpt && !any; ++kt)
            any = bit_at(bits, mt * k_sub + kt);
        if (!any) continue;
      }
      const size_t kv0 = static_cast<size_t>(kvb) * block_kv + n0;
      __syncthreads();  // previous sub-tile fully consumed
      int live = 0;
      for (int c = tid; c < BLOCK_N; c += WARPS * 32) {
        const float bias = c >= nvalid ? -INFINITY : (kv_bias ? kv_bias[kv0 + c] : 0.f);
        Bs[c] = bias;
        Ct[c] = (n0 + c) / tpt;
        live |= bias > LIVE_BIAS;
      }
      if (!__syncthreads_or(live)) continue;  // every key masked: adds nothing
      for (int e = tid; e < BLOCK_N * CHUNKS; e += WARPS * 32) {
        const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
        uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
        if (r < nvalid) {
          kv4 = *reinterpret_cast<const uint4*>(kp + (kv0 + r) * D + c);
          vv4 = *reinterpret_cast<const uint4*>(vp + (kv0 + r) * D + c);
        }
        *reinterpret_cast<uint4*>(Ks + r * LDS + c) = kv4;
        *reinterpret_cast<uint4*>(Vs + r * LDS + c) = vv4;
      }
      __syncthreads();

      float s[NT_S][4];
      qk_tile<D, NT_S, LDS>(s, qa, Ks, lane);
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          const bool vis = !has_bits || bit_at(bits, ((e >> 1) ? rt1 : rt0) + Ct[col]);
          if constexpr (STABLE) {
            s[n][e] = vis ? s[n][e] * sl + Bs[col] : NEG_INF;  // Bs -inf past the block
          } else {
            const float p = vis ? exp2f(s[n][e] + Bs[col]) : 0.f;  // exp2(-inf) = 0
            s[n][e] = p;
            l_part[e >> 1] += p;
          }
        }
      }
      if constexpr (STABLE) stable_update<NT_S, NT_O>(s, m_run, l_part, oacc);
      pv_tile<D, NT_S, LDS>(oacc, s, Vs, lane);
    }
  }

  const float l0 = row_sum(l_part[0]), l1 = row_sum(l_part[1]);
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * t;
    if (rg < block_q)
      *reinterpret_cast<uint32_t*>(out + (qrow + rg) * D + c) =
          pack_bf16(oacc[n][0] / l0, oacc[n][1] / l0);
    if (rg8 < block_q)
      *reinterpret_cast<uint32_t*>(out + (qrow + rg8) * D + c) =
          pack_bf16(oacc[n][2] / l1, oacc[n][3] / l1);
  }
}

template <int D, bool STABLE>
cudaError_t launch(int B, int H, const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, const int* ki, const int* kc,
                   const int* bits, const float* bias, const int* active, int Sq, int Skv,
                   int width, int block_q, int block_kv, int tpt, int k_sub, float sl,
                   cudaStream_t st) {
  const int chunks = (block_q + BLOCK_M - 1) / BLOCK_M;
  const dim3 grid((Sq / block_q) * chunks, H, B);
  sta_batched_kernel<D, STABLE><<<grid, WARPS * 32, 0, st>>>(
      q, k, v, out, ki, kc, bits, bias, active, H, Sq, Skv, width, block_q, block_kv, tpt, k_sub,
      chunks, sl);
  return cudaGetLastError();
}

}  // namespace

// q (pre-scaled), k, v, out: contiguous (B, H, S, D) bf16, tile-major.
// kv_index / pair_bits (nq, width), kv_count (nq,): int32 on the device,
// shared by all heads; pair_bits null for none (then tpt / k_sub unused);
// kv_bias: (Skv,) f32 on the device, or null; active: (H,) int32.  stable:
// the stable softmax, q not pre-scaled, scores scaled by sl = scale *
// log2(e).  Returns the CUDA error code.
extern "C" int vorta_sta_batched_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                          const void* kv_index, const void* kv_count,
                                          const void* pair_bits, const void* kv_bias,
                                          const void* active, int B, int H, int Sq, int Skv,
                                          int D, int nq, int width, int block_q, int block_kv,
                                          int tpt, int k_sub, int stable, float sl,
                                          void* stream) {
  if (block_q < 8 || block_kv < 8 || block_q % 8 || block_kv % 8 || Sq % block_q ||
      Skv % block_kv || nq != Sq / block_q || width < 1 || (D != 64 && D != 128) ||
      (pair_bits && (tpt < 1 || k_sub < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  auto run = [&](auto launcher) {
    return launcher(B, H, static_cast<const bf*>(q), static_cast<const bf*>(k),
                    static_cast<const bf*>(v), static_cast<bf*>(out),
                    static_cast<const int*>(kv_index), static_cast<const int*>(kv_count),
                    static_cast<const int*>(pair_bits), static_cast<const float*>(kv_bias),
                    static_cast<const int*>(active), Sq, Skv, width, block_q, block_kv,
                    pair_bits ? tpt : 1, pair_bits ? k_sub : 1, sl,
                    static_cast<cudaStream_t>(stream));
  };
  if (stable) return static_cast<int>(D == 128 ? run(launch<128, true>) : run(launch<64, true>));
  return static_cast<int>(D == 128 ? run(launch<128, false>) : run(launch<64, false>));
}
