// int8 QK^T tile helper shared by the attention kernels' qk_scale mode
// (sm_90a): mma.sync m16n8k32 with s8 inputs and s32 accumulators.
//
// The m16n8k32 s8 A / B fragments have the layout of the m16n8k16 b16
// fragments of mma_bf16.cuh counted in 32-bit words (a0: row g, word t of a
// 32-byte k chunk; a2: word t + 4; b0 / b1 likewise from K's row g), and the
// s32 accumulator the layout of the f32 one.  So an int8 row of D values is
// handled as D / 2 b16 values: load_q_frags<D / 2> and ldmatrix read it
// unchanged, each k step covering 32 int8 values.
#pragma once
#include "mma_bf16.cuh"

namespace vorta {

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// S = (Q K^T) * qkc for one warp's 16 rows of int8 Q (fragments from
// load_q_frags<DK>) against the NT_S * 8 int8 keys staged in Ks, DK = D / 2
// b16 units per row (row stride LDK b16 units).  The int32 sums are exact;
// one f32 multiply by qkc = q_scale * k_scale * scale * log2(e) turns them
// into the log2-domain scores, as the TPU kernel does.
template <int DK, int NT_S, int LDK>
__device__ __forceinline__ void qk_tile_s8(float (*s)[4], uint32_t (*qa)[4],
                                           const __nv_bfloat16* Ks, float qkc, int lane) {
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int n = 0; n < NT_S; ++n) {
    int c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int kk = 0; kk < DK / 16; kk += 2) {
      uint32_t r[4];
      ldsm_x4(r, Ks + (n * 8 + mr) * LDK + kk * 16 + mi * 8);
      mma_s8(c, qa[kk], r[0], r[1]);
      mma_s8(c, qa[kk + 1], r[2], r[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = static_cast<float>(c[e]) * qkc;
  }
}

}  // namespace vorta
