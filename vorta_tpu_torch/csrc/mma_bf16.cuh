// Tensor-core tile helpers shared by the attention kernels (sm_90a):
// mma.sync m16n8k16 with bf16 inputs and f32 accumulators, ldmatrix loads
// from shared memory, and bf16 packing.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace vorta {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Q fragments (A operand) of one warp's 16 rows: row g at qg, row g + 8 at
// qg8 (null pointer: a row past the end, read as zeros).
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (*qa)[4], const __nv_bfloat16* qg,
                                             const __nv_bfloat16* qg8, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = qg ? *reinterpret_cast<const uint32_t*>(qg + c) : 0u;
    qa[kk][1] = qg8 ? *reinterpret_cast<const uint32_t*>(qg8 + c) : 0u;
    qa[kk][2] = qg ? *reinterpret_cast<const uint32_t*>(qg + c + 8) : 0u;
    qa[kk][3] = qg8 ? *reinterpret_cast<const uint32_t*>(qg8 + c + 8) : 0u;
  }
}

// S = Q K^T for one warp's 16 rows against the NT_S * 8 keys staged in Ks
// (row stride LDS).
template <int D, int NT_S, int LDS>
__device__ __forceinline__ void qk_tile(float (*s)[4], uint32_t (*qa)[4],
                                        const __nv_bfloat16* Ks, int lane) {
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int n = 0; n < NT_S; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t r[4];
      ldsm_x4(r, Ks + (n * 8 + mr) * LDS + kk * 16 + mi * 8);
      mma_bf16(s[n], qa[kk], r[0], r[1]);
      mma_bf16(s[n], qa[kk + 1], r[2], r[3]);
    }
  }
}

// O += P V with P (the accumulator layout of S, which is the A-operand
// layout of this product) rounded to bf16.
template <int D, int NT_S, int LDS>
__device__ __forceinline__ void pv_tile(float (*oacc)[4], float (*p)[4],
                                        const __nv_bfloat16* Vs, int lane) {
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < NT_S / 2; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t r[4];
      ldsm_x4_trans(r, Vs + (kk * 16 + (mi & 1) * 8 + mr) * LDS + n * 8 + (mi >> 1) * 8);
      mma_bf16(oacc[n], pa, r[0], r[1]);
      mma_bf16(oacc[n + 1], pa, r[2], r[3]);
    }
  }
}

// C = A B^T for one warp: A is 16 rows x D staged in shared memory at As,
// B is NT * 8 rows x D at Bs (both row stride LDS), C in the accumulator
// layout.  The backward's kv-row products (K Q^T, V dO^T) take both operands
// from shared memory this way.
template <int D, int NT, int LDS>
__device__ __forceinline__ void abt_tile(float (*c)[4], const __nv_bfloat16* As,
                                         const __nv_bfloat16* Bs, int lane) {
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, As + ((mi & 1) * 8 + mr) * LDS + kk * 16 + (mi >> 1) * 8);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t r[4];
      ldsm_x4(r, Bs + ((n + (mi >> 1)) * 8 + mr) * LDS + kk * 16 + (mi & 1) * 8);
      mma_bf16(c[n], a, r[0], r[1]);
      mma_bf16(c[n + 1], a, r[2], r[3]);
    }
  }
}

// The stable online-softmax update of the JAX kernels (flash_manual.py,
// sta_batched.py: the running max with m_safe) for one warp's rows g and
// g + 8: x holds their NT_S * 8 scores of a sub-tile, scaled, biased and
// masked (NEG_INF, or -inf); m_run moves to the new row max, m_safe is 0
// where that max is still NEG_INF, l_part and oacc are rescaled by
// exp2(m_old - m_safe), and x becomes p = exp2(x - m_safe), added to l_part.
template <int NT_S, int NT_O>
__device__ __forceinline__ void stable_update(float (*x)[4], float* m_run, float* l_part,
                                              float (*oacc)[4]) {
  float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < NT_S; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mc[e >> 1] = fmaxf(mc[e >> 1], x[n][e]);
  float alpha[2], m_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
    mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
    const float m_new = fmaxf(m_run[r], mc[r]);
    m_safe[r] = (m_new <= NEG_INF) ? 0.f : m_new;
    alpha[r] = exp2f(m_run[r] - m_safe[r]);
    m_run[r] = m_new;
    l_part[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < NT_S; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(x[n][e] - m_safe[e >> 1]);
      x[n][e] = p;
      l_part[e >> 1] += p;
    }
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    oacc[n][0] *= alpha[0];
    oacc[n][1] *= alpha[0];
    oacc[n][2] *= alpha[1];
    oacc[n][3] *= alpha[1];
  }
}

// Sum a per-thread partial row sum over the 4 threads of a quad.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Reduce a per-thread partial row sum over the 4 threads of a quad; l == 0
// becomes 1 so that a row with no visible key writes 0.
__device__ __forceinline__ float row_sum(float x) {
  x = quad_sum(x);
  return x == 0.f ? 1.f : x;
}

// Rows of a CUDA block for a table block of `rows` rows: 64 (4 warps) where
// they tile it, else 32 (2 warps), else 16 (1 warp).  A multiple of 8 that
// 16 does not divide leaves a ragged CUDA block per table block, whose rows
// past the table block the kernels mask: 64 rows for blocks above 64
// (the 360-token STA tiles: 6 CUDA blocks, the last with 40 rows), else 16.
__host__ __forceinline__ int warps_for(int rows) {
  if (rows % 16) return rows > 64 ? 4 : 1;
  return rows % 64 == 0 ? 4 : (rows % 32 == 0 ? 2 : 1);
}

}  // namespace vorta
