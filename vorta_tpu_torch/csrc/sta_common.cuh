// Helpers shared by the window-dense sliding-tile kernels (sta_pipe.cu,
// sta_window.cu, sta_row.cu): the clamped window start, and one warp's
// stable online-softmax step over a 64-key shared-memory sub-tile.
#pragma once
#include <math.h>

#include "mma_bf16.cuh"

namespace vorta {

// element start of the clamped window of tile qt on an axis of n tiles:
// clip(qt - win // 2, 0, n - min(win, n)) tiles (geometry.window_starts)
__device__ __forceinline__ int window_start(int qt, int n, int win, int tile) {
  const int win_eff = min(win, n);
  return min(max(qt - win / 2, 0), n - win_eff) * tile;
}

// One stable online-softmax step of a warp's 16 query rows (Q fragments in
// qa) over the 64 keys staged in Ks / Vs (row stride LDS): s = q.k * sl
// (+ Bs[col] where Bs is given), for the columns of the n-blocks (8 keys
// each) whose bit is set in `rel` and below `nvalid`; the others are
// excluded (p = 0, and an n-block pair with no set bit costs no mma).
// m / l: the thread's two rows' running max and its share of their sums;
// oacc is rescaled by exp2(m_old - m_new); P is rounded to bf16 before PV.
template <int D, int LDS>
__device__ __forceinline__ void online_softmax_step(uint32_t (*qa)[4],
                                                    const __nv_bfloat16* Ks,
                                                    const __nv_bfloat16* Vs, const float* Bs,
                                                    int nvalid, uint32_t rel, float sl, float* m,
                                                    float* l, float (*oacc)[4], int lane) {
  constexpr int NT_S = 8;  // 64 keys
  const int mi = lane / 8, mr = lane % 8, t = lane % 4;
  float s[NT_S][4];
#pragma unroll
  for (int n = 0; n < NT_S; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if (!((rel >> n) & 1u)) continue;  // warp-uniform
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t r[4];
      ldsm_x4(r, Ks + (n * 8 + mr) * LDS + kk * 16 + mi * 8);
      mma_bf16(s[n], qa[kk], r[0], r[1]);
      mma_bf16(s[n], qa[kk + 1], r[2], r[3]);
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < NT_S; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * t + (e & 1);
      const bool ok = ((rel >> n) & 1u) && col < nvalid;
      const float x = ok ? s[n][e] * sl + (Bs ? Bs[col] : 0.f) : -INFINITY;
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < NT_S; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[n][e] - mx[e >> 1]);  // exp2(-inf) = 0
      s[n][e] = p;
      l[e >> 1] += p;
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    oacc[n][0] *= alpha[0];
    oacc[n][1] *= alpha[0];
    oacc[n][2] *= alpha[1];
    oacc[n][3] *= alpha[1];
  }
#pragma unroll
  for (int kk = 0; kk < NT_S / 2; ++kk) {
    if (!((rel >> (2 * kk)) & 3u)) continue;  // warp-uniform
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t r[4];
      ldsm_x4_trans(r, Vs + (kk * 16 + (mi & 1) * 8 + mr) * LDS + n * 8 + (mi >> 1) * 8);
      mma_bf16(oacc[n], pa, r[0], r[1]);
      mma_bf16(oacc[n + 1], pa, r[2], r[3]);
    }
  }
}

}  // namespace vorta
