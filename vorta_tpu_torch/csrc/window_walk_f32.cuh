// The window walk of the f32 attention core (csrc/attn_f32.cuh) for the
// window-dense STA kernels: sta_pipe's f32 and int8-QK-with-f32-v modes
// (csrc/sta_pipe.cu) and the f32 modes of sta_window and sta_row
// (csrc/sta_window.cu, csrc/sta_row.cu), which compute one function (a q
// tile over every key of its clamped window, then the joint text tail) and
// differ only in the softmax and whether q arrives pre-scaled.  At head dim
// 128 with q tiles of a multiple of 8 tokens (every f32 call of the 1.3B /
// 13B paths) sta_pipe's f32 mode and sta_window's run the tensor-core walk
// of csrc/window_walk_f32_tc.cuh instead (ops/sta_pipe.py:sta_f32_tc_path);
// this walk serves head dim 64, sta_pipe's int8 QK mode, sta_row's f32 mode
// and the FFMA yardsticks.
//
// The walk names each key's K and V rows for the core, which stages them
// one row pointer at a time: a window run of any width (the (4, 9, 10)
// tile's 30 tokens) is read key by key with nothing padded and no column to
// mask, unlike the bf16 Hopper path, whose TMA boxes read runs of 25 to 31
// tokens as 32 and mask the padded columns (csrc/sta_window_src.cuh).
//
// Each .cu file is its own library (ops/_build.py): this header holds one
// definition per library.
#pragma once

#include "attn_f32.cuh"
#include "sta_common.cuh"

namespace vorta {
namespace f32 {

// k and text_k: f32, or int8 (kb = 1) in the int8 QK mode; v and text_v
// f32; text_bias (Lt,) f32; active (H,) int32; parts: 64-row parts of a q
// tile.
struct WindowParams {
  const void *k, *text_k;
  const float *v, *text_v, *text_bias;
  const int* active;
  int H, T, HH, W, D, tt, th, tw, win_t, win_h, win_w, Lt, parts, kb;
};

// The window walk: 64-row part `part` of q tile `tile` (the tile's rows in
// their in-tile raster order, as the plain version's tile_sequence); its
// window box of bt x bh x bw tokens from the clamped origin in 64-key
// chunks in (t, h, w) order, then the Lt text keys with their bias.  Rows
// past the tile (a 360-token tile's sixth part holds 40) are not the
// walk's: rows() stops the core there.  An inactive head has no chunk, so
// the core writes its rows as zeros.
struct WindowWalk {
  static constexpr bool PAIRS = false;
  const WindowParams& p;  // a __grid_constant__ kernel parameter
  int h, part, it, ih, iw, tpt, t0, h0, w0, bh, bw, nk, nwc;
  long long base, text0;

  __device__ WindowWalk(const WindowParams& prm) : p(prm) {
    const int nt = p.T / p.tt, nh = p.HH / p.th, nw = p.W / p.tw;
    const int tile = blockIdx.x / p.parts;
    part = blockIdx.x % p.parts;
    h = blockIdx.y;
    it = tile / (nh * nw);
    ih = (tile / nw) % nh;
    iw = tile % nw;
    tpt = p.tt * p.th * p.tw;
    t0 = window_start(it, nt, p.win_t, p.tt);
    h0 = window_start(ih, nh, p.win_h, p.th);
    w0 = window_start(iw, nw, p.win_w, p.tw);
    bh = min(p.win_h, nh) * p.th;
    bw = min(p.win_w, nw) * p.tw;
    nk = min(p.win_t, nt) * p.tt * bh * bw;
    nwc = (nk + BK - 1) / BK;
    const long long bhh = static_cast<long long>(blockIdx.z) * p.H + h;
    base = bhh * p.T * p.HH * p.W;
    text0 = bhh * p.Lt;
  }
  __device__ int rows() const { return min(BQ, tpt - part * BQ); }
  __device__ long long q_off(int r) const {
    const int rr = part * BQ + r;
    const int tok = ((it * p.tt + rr / (p.th * p.tw)) * p.HH + ih * p.th + (rr / p.tw) % p.th) *
                        p.W + iw * p.tw + rr % p.tw;
    return (base + tok) * p.D;
  }
  __device__ int chunks() const {
    return p.active[h] == 0 ? 0 : nwc + (p.Lt + BK - 1) / BK;
  }
  __device__ void key(int c, int j, const void*& kp, const float*& vp, float& bias) const {
    kp = nullptr;
    vp = nullptr;
    bias = 0.f;
    if (c < nwc) {
      const int n = c * BK + j;
      if (n >= nk) return;
      const long long tok = ((t0 + n / (bh * bw)) * p.HH + h0 + (n / bw) % bh) * p.W + w0 + n % bw;
      kp = row_ptr(p.k, base + tok, p.D, p.kb);
      vp = p.v + (base + tok) * p.D;
      return;
    }
    const int n = (c - nwc) * BK + j;
    if (n >= p.Lt) return;
    kp = row_ptr(p.text_k, text0 + n, p.D, p.kb);
    vp = p.text_v + (text0 + n) * p.D;
    bias = p.text_bias[n];
  }
};

// The window kernels' common checks and grid: (q tiles x parts, H, B).
inline bool window_shape_ok(int T, int HH, int W, int D, int tt, int th, int tw, int win_t,
                            int win_h, int win_w, int Lt, const void* text_k,
                            const void* text_v, const void* text_bias, const void* active) {
  return !(T % tt || HH % th || W % tw || (D != 64 && D != 128) || win_t < 1 || win_h < 1 ||
           win_w < 1 || Lt < 0 || (Lt > 0 && (!text_k || !text_v || !text_bias)) || !active);
}

inline WindowParams window_params(const void* k, const void* v, const void* text_k,
                                  const void* text_v, const void* text_bias, const void* active,
                                  int Lt, int H, int T, int HH, int W, int D, int tt, int th,
                                  int tw, int win_t, int win_h, int win_w, int kb) {
  return WindowParams{k, text_k, static_cast<const float*>(v), static_cast<const float*>(text_v),
                      static_cast<const float*>(text_bias), static_cast<const int*>(active), H, T,
                      HH, W, D, tt, th, tw, win_t, win_h, win_w, Lt,
                      (tt * th * tw + BQ - 1) / BQ, kb};
}

inline dim3 window_grid(int B, const WindowParams& p) {
  return dim3((p.T / p.tt) * (p.HH / p.th) * (p.W / p.tw) * p.parts, p.H, B);
}

// The f32 entry of a window-dense kernel with the stable softmax (sta_window
// and sta_row: k64 / k128 its two instantiations, (q, out, params, sl)):
// q, k, v, out contiguous raster (B, H, T*HH*W, D) f32, q not pre-scaled;
// active (H,) int32; text_k / text_v (B, H, Lt, D) f32 and text_bias (Lt,)
// f32, or null with Lt = 0; sl = scale * log2(e).  The CUDA error code.
template <class K64, class K128>
cudaError_t launch_window_stable(K64 k64, K128 k128, const void* q, const void* k,
                                 const void* v, void* out, const void* active,
                                 const void* text_k, const void* text_v, const void* text_bias,
                                 float sl, int Lt, int B, int H, int T, int HH, int W, int D,
                                 int tt, int th, int tw, int win_t, int win_h, int win_w,
                                 void* stream) {
  if (!window_shape_ok(T, HH, W, D, tt, th, tw, win_t, win_h, win_w, Lt, text_k, text_v,
                       text_bias, active))
    return cudaErrorInvalidValue;
  const WindowParams p = window_params(k, v, text_k, text_v, text_bias, active, Lt, H, T, HH, W,
                                       D, tt, th, tw, win_t, win_h, win_w, 4);
  const dim3 grid = window_grid(B, p);
  auto st = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const float*>(q);
  auto* oo = static_cast<float*>(out);
  return D == 128 ? launch<128>(k128, grid, st, qq, oo, p, sl)
                  : launch<64>(k64, grid, st, qq, oo, p, sl);
}

}  // namespace f32
}  // namespace vorta
