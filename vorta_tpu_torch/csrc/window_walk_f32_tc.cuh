// The window walk of the f32 tensor-core core (csrc/attn_f32_tc.cuh: 3xTF32
// on wgmma) for the f32 modes of sta_window and sta_pipe (csrc/sta_window.cu,
// csrc/sta_pipe.cu) at head dim 128, in place of csrc/window_walk_f32.cuh's
// FFMA walk: one q tile over every key of its clamped window, then the joint
// text tail with its bias (the function of csrc/window_walk_f32.cuh's
// header).  sta_row's f32 mode, sta_pipe's int8-QK-with-f32-v mode and head
// dim 64 stay on the FFMA walk (the wrappers' rule, ops/sta_pipe.py:
// sta_f32_tc_path, mirrored by window_path_holds below).
//
// The raster layout is what makes a window hard for the tensor-core core:
// its PV product reads V^T with the keys permuted within aligned groups of 8
// (csrc/attn_f32_tc.cuh, "P stays in registers"), and a window's runs on the
// raster start anywhere mod 8 (the (4, 6, 4) tile's runs of 12 tokens at W =
// 52, the (4, 9, 10) tile's runs of 30 at W = 80), so no TMA box of a raster
// V^T lines up with those groups.  The design:
//
// - A split pre-pass (window_tc_split_rows_kernel, window_tc_split_t_kernel)
//   gathers q, k and V^T into tile-major order (ops/layout.py:tile_sequence's
//   order) as it splits them into their TF32 halves, the text keys of each
//   (b, h) after its S window keys.  In that order the w-adjacent tiles of a
//   window row are consecutive: the window is min(win_t, nt) x min(win_h, nh)
//   runs of min(win_w, nw) x tpt keys, each starting on a tile, so on a
//   multiple of 8 where tpt is one (96, 360 and 432 are), and V^T's permuted
//   groups line up.  An inactive head's rows are not split (nothing reads
//   them).
// - The walk (PieceWalk) cuts the runs, then the text keys, into 32-key
//   pieces, the last of each run or of the text cut short (its keys past
//   the run masked), and pairs consecutive pieces into the core's 64-key
//   chunks: a chunk may join the end of one run to the start of the next, so
//   only the window's last chunk is ragged where runs are not multiples of 64
//   (the (4, 6, 4) tile's runs of 288 keys: 41 chunks for 2,592 keys, not
//   the 45 of a chunk per 64 keys of each run).  K's halves come as 32-row
//   TMA boxes and V^T's as 32-key boxes, one per piece.
// - The core's consumer (S and O in registers, P's halves from S unmoved, the
//   PV product of each chunk joined to O by FMA) and its 64-row CTAs: a q
//   tile of tpt rows takes ceil(tpt / 64) CTAs, the last one's rows past the
//   tile computed from the next tile's rows and never stored.
// - The epilogue writes each row to its raster token (WindowWalk::q_off's
//   mapping): no un-gather pass.  An inactive head (active[h] == 0) writes
//   its rows as zeros before any barrier.
//
// The bias of a text key is text_bias[key - S] (0 on window keys), added
// after the scale as the FFMA walk adds it.  Scratch: the caller's, 2 B H
// (S + 2 (S + Lt)) 128 f32 (ops/flash.py:f32_tc_work(B, H, S, S + Lt)).
#pragma once

#include "attn_f32_tc.cuh"
#include "sta_common.cuh"

namespace vorta {
namespace f32tc {

constexpr int PIECE = 32;  // keys of a piece: two pieces a chunk

// The window geometry of a call, its text tail and its output.
struct WindowTc {
  const int* active;
  const float* text_bias;
  float* out;
  int H, T, HH, W, tt, th, tw, win_t, win_h, win_w, Lt, parts;

  __host__ __device__ int S() const { return T * HH * W; }
  __host__ __device__ int tpt() const { return tt * th * tw; }
  __host__ __device__ int tiles() const { return (T / tt) * (HH / th) * (W / tw); }
  // raster token of row j of the tile-major order (tile j / tpt, its row j %
  // tpt in the tile's own raster order)
  __device__ int raster(int j) const {
    const int nh = HH / th, nw = W / tw, tile = j / tpt(), r = j % tpt();
    const int it = tile / (nh * nw), ih = (tile / nw) % nh, iw = tile % nw;
    return ((it * tt + r / (th * tw)) * HH + ih * th + (r / tw) % th) * W + iw * tw + r % tw;
  }
};

// The 32-key pieces of q tile `tile`'s keys in tile-major key space: the
// window's runs in (t, h) order, then the text keys at S.., and the chunks
// that pair them.  ops/sta_pipe.py:window_f32_tc_walk mirrors it.
struct PieceWalk {
  int nruns, wh, runlen, t0, h0, w0, nh, nw, tpt, S, Lt;
  int run = 0, off = 0;

  __device__ PieceWalk(const WindowTc& p, int tile) {
    const int nt = p.T / p.tt;
    nh = p.HH / p.th;
    nw = p.W / p.tw;
    const int it = tile / (nh * nw), ih = (tile / nw) % nh, iw = tile % nw;
    t0 = window_start(it, nt, p.win_t, 1);
    h0 = window_start(ih, nh, p.win_h, 1);
    w0 = window_start(iw, nw, p.win_w, 1);
    wh = min(p.win_h, nh);
    nruns = min(p.win_t, nt) * wh;
    tpt = p.tpt();
    runlen = min(p.win_w, nw) * tpt;
    S = p.S();
    Lt = p.Lt;
  }
  __device__ bool next(int& key0, int& nvalid) {
    for (; run <= nruns; ++run, off = 0) {
      const int len = run < nruns ? runlen : Lt;
      if (off < len) {
        key0 = off + (run < nruns ? (((t0 + run / wh) * nh + h0 + run % wh) * nw + w0) * tpt : S);
        nvalid = min(PIECE, len - off);
        off += PIECE;
        return true;
      }
    }
    return false;
  }
  // the next chunk: pieces (ka, na) and (kb, nb); a lone last piece pairs
  // with itself at nb = 0 (its copy read again, every column masked)
  __device__ bool chunk(int& ka, int& na, int& kb, int& nb) {
    if (!next(ka, na)) return false;
    if (!next(kb, nb)) {
      kb = ka;
      nb = 0;
    }
    return true;
  }
};

// ---- the split pre-pass ----------------------------------------------------------

// Rows of x (B*H, S, 128) in tile-major order, then, where lt > 0, the rows
// of text (B*H, lt, 128), split: out[0 : BH SK 128] big, then small, SK = S
// + lt rows a (b, h).  A warp a row; an inactive head's rows skipped.
__global__ void __launch_bounds__(256) window_tc_split_rows_kernel(const float* __restrict__ x,
                                                                   const float* __restrict__ text,
                                                                   uint4* __restrict__ out,
                                                                   const WindowTc p, int BH,
                                                                   int lt) {
  const int S = p.S(), SK = S + lt, bh = blockIdx.y, lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= SK || p.active[bh % p.H] == 0) return;
  const float* src = row < S ? x + (static_cast<long long>(bh) * S + p.raster(row)) * D
                             : text + (static_cast<long long>(bh) * lt + row - S) * D;
  const float4 v = __ldg(reinterpret_cast<const float4*>(src) + lane);
  uint4 b, sm;
  split(v.x, b.x, sm.x);
  split(v.y, b.y, sm.y);
  split(v.z, b.z, sm.z);
  split(v.w, b.w, sm.w);
  const long long o = (static_cast<long long>(bh) * SK + row) * (D / 4) + lane;
  out[o] = b;
  out[static_cast<long long>(BH) * SK * (D / 4) + o] = sm;
}

// V^T of the same rows: out[half][bh][d][p] over SK = S + Lt keys, half 0
// big, 1 small, key j of each group of 8 at column p = 8 (j / 8) + (j % 2 ?
// 4 : 0) + (j % 8) / 2 (f32_tc_split_t_kernel's order).  A CTA transposes 64
// keys of one (b, h) through shared memory; an inactive head's skipped.
__global__ void __launch_bounds__(256) window_tc_split_t_kernel(const float* __restrict__ v,
                                                                const float* __restrict__ text,
                                                                uint32_t* __restrict__ out,
                                                                const WindowTc p, int BH) {
  __shared__ float tile[BK][D + 1];
  const int S = p.S(), SK = S + p.Lt, key0 = blockIdx.x * BK, bh = blockIdx.y, tid = threadIdx.x;
  if (p.active[bh % p.H] == 0) return;
  for (int e = tid; e < BK * D / 4; e += 256) {
    const int j = e / (D / 4), c = (e % (D / 4)) * 4, key = key0 + j;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < S)
      x = __ldg(reinterpret_cast<const float4*>(
          v + (static_cast<long long>(bh) * S + p.raster(key)) * D + c));
    else if (key < SK)
      x = __ldg(reinterpret_cast<const float4*>(
          text + (static_cast<long long>(bh) * p.Lt + key - S) * D + c));
    tile[j][c] = x.x;
    tile[j][c + 1] = x.y;
    tile[j][c + 2] = x.z;
    tile[j][c + 3] = x.w;
  }
  __syncthreads();
  split_t_store(tile, out, static_cast<long long>(BH) * D * SK, bh, SK, key0);
}

// ---- the attention kernel ----------------------------------------------------------

// The kernel body: CTA (blockIdx.x = q tile * parts + part, h, b) over the
// halves the pre-pass wrote: tq over q's (2 B H S rows of 128 f32, boxes of
// 32 columns x 64 rows), tk over k's (2 B H SK rows, boxes of 32 columns x
// 32 rows) and tv over V^T's (2 B H 128 rows of SK keys, boxes of 32 keys x
// 128 rows), all with the 128-byte swizzle.  mul: the scores' factor (sl,
// or 1 on a q pre-scaled in f32); stable: the online softmax, else exp2(s).
__device__ __forceinline__ void attend_window(const CUtensorMap& tq, const CUtensorMap& tk,
                                              const CUtensorMap& tv, const WindowTc& p,
                                              float mul, bool stable) {
  using namespace sm90;
  const int tile = blockIdx.x / p.parts, local0 = (blockIdx.x % p.parts) * BQ, h = blockIdx.y;
  const int tpt = p.tpt(), S = p.S(), SK = S + p.Lt;
  const int rows = min(BQ, tpt - local0);  // its rows of the q tile
  const long long bh = static_cast<long long>(blockIdx.z) * p.H + h;
  const int tid = threadIdx.x;
  auto orow = [&](int r) {  // row r of the CTA at its raster token
    return p.out + (bh * S + p.raster(tile * tpt + local0 + r)) * D;
  };
  if (p.active[h] == 0) {  // routed away: zeros, no barrier touched
    for (int e = tid; e < rows * D / 4; e += THREADS)
      reinterpret_cast<float4*>(orow(e / (D / 4)))[e % (D / 4)] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  PieceWalk walk(p, tile);

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_full = base + BAR, k_full = q_full + 8, k_empty = q_full + 16,
                 v_full = q_full + 24, v_empty = q_full + 32;
  init_barriers(base);
  int ka, na, kb, nb;

  if (tid >= 128) {
    // ---- producer: one thread issues every copy ------------------------------------
    if (tid != 128) return;
    const int qrows = gridDim.z * p.H * S, krows = gridDim.z * p.H * SK;
    const int vrows = gridDim.z * p.H * D, vrow = static_cast<int>(bh) * D;
    const int qrow = static_cast<int>(bh * S) + tile * tpt + local0;
    mbar_expect_tx(q_full, 2 * TILE);
    for (int half = 0; half < 2; ++half)
      for (int b = 0; b < 4; ++b)
        tma_load(base + (half ? QS : QB) + b * BQ * 128, &tq, q_full, 32 * b,
                 half * qrows + qrow);
    for (uint32_t phase = 1; walk.chunk(ka, na, kb, nb); phase ^= 1) {
      const int krow = static_cast<int>(bh * SK);
      mbar_wait(k_empty, phase);  // a fresh barrier passes parity 1
      mbar_expect_tx(k_full, 2 * TILE);
      for (int half = 0; half < 2; ++half)
        for (int pc = 0; pc < 2; ++pc)
          for (int b = 0; b < 4; ++b)
            tma_load(base + (half ? KS : KB) + b * BK * 128 + pc * PIECE * 128, &tk, k_full,
                     32 * b, half * krows + krow + (pc ? kb : ka));
      mbar_wait(v_empty, phase);
      mbar_expect_tx(v_full, 2 * TILE);
      for (int half = 0; half < 2; ++half)
        for (int pc = 0; pc < 2; ++pc)
          tma_load(base + (half ? VS : VB) + pc * D * 128, &tv, v_full, pc ? kb : ka,
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
  for (uint32_t phase = 0; walk.chunk(ka, na, kb, nb); phase ^= 1) {
    float bias[16];  // columns 8n + 2t + e of this chunk (n = i / 2, e = i % 2): text keys'
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = i / 2, key = (n < 4 ? ka + 8 * n : kb + 8 * (n - 4)) + 2 * t + i % 2;
      bias[i] = key >= S && key < SK ? __ldg(p.text_bias + key - S) : 0.f;
    }
    consume_chunk(o, m, l, bias,
                  [&](int col) { return col < PIECE ? col < na : col - PIECE < nb; }, base,
                  phase, mul, stable);
  }

  // ---- epilogue: rows 16w + g (+ 8) of the q tile, each at its raster token -------
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float x = quad_sum(l[hr]);
    const int r = 16 * w + g + 8 * hr;
    if (r >= rows) continue;
    const float inv = x == 0.f ? 0.f : 1.f / x;
    float* dst = orow(r) + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[4 * n + 2 * hr] * inv, o[4 * n + 2 * hr + 1] * inv);
  }
}

// ---- host side ---------------------------------------------------------------------

// The window walks' shape rule (ops/sta_pipe.py:sta_f32_tc_path, which
// sta_window's wrapper calls too): head dim 128, q tiles of a multiple of 8
// tokens, a text tail of a multiple of 8 keys or none.
inline bool window_path_holds(int D_, int tpt, int Lt) {
  return D_ == D && tpt % 8 == 0 && Lt >= 0 && Lt % 8 == 0;
}

inline WindowTc window_tc(const void* active, const void* text_bias, void* out, int Lt, int H,
                          int T, int HH, int W, int tt, int th, int tw, int win_t, int win_h,
                          int win_w) {
  return WindowTc{static_cast<const int*>(active), static_cast<const float*>(text_bias),
                  static_cast<float*>(out), H, T, HH, W, tt, th, tw, win_t, win_h, win_w, Lt,
                  (tt * th * tw + BQ - 1) / BQ};
}

// Split and gather q, k (+ text_k), V^T (+ text_v) into work (2 B H (S + 2
// (S + Lt)) 128 f32, 16-byte aligned: q's halves, k's, V^T's), then launch
// kern<<<(tiles * parts, H, B), THREADS, SMEM_BYTES>>>(tq, tk, tv, p,
// args...).  q, k, v: contiguous raster (B, H, S, 128) f32; text_k / text_v
// (B, H, Lt, 128) f32 or null with Lt = 0; all 16-byte aligned.  D_ off the
// rule, or no work: an error (never a fallback).  The CUDA error code.
template <class Kern, class... Args>
cudaError_t launch_window(Kern kern, const void* q, const void* k, const void* v,
                          const void* text_k, const void* text_v, void* work, int B, int D_,
                          const WindowTc& p, cudaStream_t st, Args... args) {
  if (!window_path_holds(D_, p.tpt(), p.Lt) || work == nullptr ||
      (p.Lt > 0 && (!text_k || !text_v || !p.text_bias)))
    return cudaErrorInvalidValue;
  const int BH = B * p.H, S = p.S(), SK = S + p.Lt;
  float* wq = static_cast<float*>(work);
  float* wk = wq + 2LL * BH * S * D;
  float* wv = wk + 2LL * BH * SK * D;
  window_tc_split_rows_kernel<<<dim3((S + 7) / 8, BH), 256, 0, st>>>(
      static_cast<const float*>(q), nullptr, reinterpret_cast<uint4*>(wq), p, BH, 0);
  window_tc_split_rows_kernel<<<dim3((SK + 7) / 8, BH), 256, 0, st>>>(
      static_cast<const float*>(k), static_cast<const float*>(text_k),
      reinterpret_cast<uint4*>(wk), p, BH, p.Lt);
  window_tc_split_t_kernel<<<dim3((SK + BK - 1) / BK, BH), 256, 0, st>>>(
      static_cast<const float*>(v), static_cast<const float*>(text_v),
      reinterpret_cast<uint32_t*>(wv), p, BH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, wq, 2ULL * BH * S, D, BQ) || !make_map(&tk, wk, 2ULL * BH * SK, D, PIECE) ||
      !make_map(&tv, wv, 2ULL * BH * D, SK, D))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.tiles() * p.parts, p.H, B), THREADS, SMEM_BYTES, st>>>(tq, tk, tv, p, args...);
  return cudaGetLastError();
}

}  // namespace f32tc
}  // namespace vorta
