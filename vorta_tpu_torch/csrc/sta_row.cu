// Window-dense sliding-tile attention with the stable softmax, a row of q
// tiles sharing one K/V slab, for Hopper (sm_90a).
//
// Replaces vorta_tpu/ops/sta_row.py:_kernel (reached through
// sta_row_attention).  Same function as sta_window.cu: every query of a
// tile attends to all tokens of the prod(window) tiles of its clamped
// window (geometry.window_starts), stable softmax with scores q.k * (scale
// * log2(e)) in f32, P rounded to bf16 before PV, inactive heads zero, and
// the optional joint text tail (text_k / text_v, text_bias added after the
// scale, sta_row.py:205).  The q tiles of one row (t-tile, h-tile) share
// their (t, h) window, so they share one slab of win_t * tile_t x win_h *
// tile_h lines of the latent's width; each tile takes its own w window of
// every line.  Needs tile_w % 8 == 0 (the TPU kernel's own condition,
// supports_row_dense): then every 8-key n-block of a line lies in one w
// window or outside it.
//
// Bound on this card: at Wan-1.3B 720p x 77f with tile (5, 9, 8) (72,000
// tokens, 9,720 keys per query) 4 * 72,000 * 9,720 * 128 = 3.6e11 FLOP per
// head against 74 MB of operands: the tensor cores bound it (0.36 ms per
// head at 989 TFLOP/s bf16).  Two designs, chosen per call by the wrapper's
// rule (ops/sta_row.py:row_wgmma_path, mirrored by the C entry):
//
// - The Hopper path (D = 128, a window box, a slot table that fits shared
//   memory, a text tail of a multiple of 8 keys): sta_window's
//   sta_window_sm90_kernel<0> (csrc/sta_window_src.cuh), the same kernel
//   instantiated here, since the function is the same.  tile_w % 8 == 0
//   makes every window run a multiple of 8 tokens, so its boxes are never
//   padded.  The TPU kernel's row-dense idea (the q tiles of one (t, h) row
//   share one slab of K / V lines) is that kernel's launch order on this
//   card: the CTAs of one row of q tiles sit at adjacent blockIdx.x, so
//   the row's shared lines come from the 50 MB L2 after their first read.
// - The mma.sync path (D = 64, windows with no box), below: one CUDA block
//   per (row of q tiles, group of at most 8 of its w tiles, 16-row stripe
//   of each tile, head, batch), one warp per w tile of the group; the block
//   stages the union of its tiles' w windows, line by line, in 64-key
//   sub-tiles of shared memory, and each warp runs an online-softmax step
//   on mma.sync m16n8k16 over the n-blocks inside its own window only
//   (sta_common.cuh), so a staged key serves every warp whose window holds
//   it.
//
// The f32 mode (f32 q / k / v and text, the JAX package's --dtype fp32 at
// a --resume_dir tile that sends the STA heads here): sta_row_f32_kernel<D>, the same function as
// sta_window's f32 kernel (the row-dense sharing is a VMEM layout detail), the FFMA
// core of csrc/attn_f32.cuh over the window walk of
// csrc/window_walk_f32.cuh (per 64-row part of a q tile, every key of the
// window then the text tail in 64-key chunks, each staged through its own
// row pointer, so the (4, 9, 10) tile's runs of 30 need no padding and no
// masked column), the stable softmax with q unscaled and the scores times
// sl, P kept in f32.  At 720p x 77f, 8 heads, the work is 2.87e12 FLOP:
// 42.8 ms at 67 TFLOP/s f32, which bounds it.
#include "sta_common.cuh"
#include "sta_window_src.cuh"
#include "window_walk_f32.cuh"

namespace {

using namespace vorta;

constexpr int BLOCK_N = 64;  // keys per shared-memory sub-tile
constexpr int MAX_WARPS = 8;  // w tiles per CUDA block

template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
sta_row_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
               const int* __restrict__ active, const __nv_bfloat16* __restrict__ text_k,
               const __nv_bfloat16* __restrict__ text_v, const float* __restrict__ text_bias,
               float sl, int Lt, int H, int T, int HH, int W, int tt, int th, int tw, int win_t,
               int win_h, int win_w, int groups, int per_group, int stripes) {
  constexpr int LDS = D + 8;
  constexpr int NT_O = D / 8;
  constexpr int CHUNKS = D / 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[BLOCK_N * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BLOCK_N * LDS];
  __shared__ float Bs[BLOCK_N];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nt = T / tt, nh = HH / th, nw = W / tw;
  const int row = blockIdx.x / (groups * stripes);
  const int grp = (blockIdx.x / stripes) % groups, stripe = blockIdx.x % stripes;
  const int it = row / nh, ih = row % nh;
  const int w_first = grp * per_group, w_last = min(nw, w_first + per_group) - 1;
  const int iw = w_first + warp;  // this warp's q tile
  const bool live = iw <= w_last;
  const int tpt = tt * th * tw;
  const size_t base = (static_cast<size_t>(b) * H + h) * T * HH * W;
  auto q_token = [&](int r) {
    return ((it * tt + r / (th * tw)) * HH + ih * th + (r / tw) % th) * W + iw * tw + r % tw;
  };
  const int rg = stripe * 16 + g, rg8 = rg + 8;
  const bool ok0 = live && rg < tpt, ok1 = live && rg8 < tpt;

  if (active[h] == 0) {
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int c = n * 8 + 2 * t;
      if (ok0) *reinterpret_cast<uint32_t*>(out + (base + q_token(rg)) * D + c) = 0u;
      if (ok1) *reinterpret_cast<uint32_t*>(out + (base + q_token(rg8)) * D + c) = 0u;
    }
    return;
  }

  // the row's slab: lines (t, h) of its clamped (t, h) window, columns
  // [wlo, wlo + wspan) = the union of the group's w windows
  const int t0 = window_start(it, nt, win_t, tt);
  const int h0 = window_start(ih, nh, win_h, th);
  const int bw = min(win_w, nw) * tw;
  const int wlo = window_start(w_first, nw, win_w, tw);
  const int wspan = window_start(w_last, nw, win_w, tw) + bw - wlo;
  const int bh_ = min(win_h, nh) * th;
  const int nk = min(win_t, nt) * tt * bh_ * wspan;
  const int ws = live ? window_start(iw, nw, win_w, tw) : 0;  // this warp's window

  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, ok0 ? q + (base + q_token(rg)) * D : nullptr,
                  ok1 ? q + (base + q_token(rg8)) * D : nullptr, t);
  float oacc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  auto stage = [&](int nvalid, const __nv_bfloat16* kk, const __nv_bfloat16* vv, auto kv_row) {
    __syncthreads();  // previous sub-tile fully consumed
    for (int e = tid; e < BLOCK_N * CHUNKS; e += nthreads) {
      const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (r < nvalid) {
        const size_t rr = kv_row(r);
        kv4 = *reinterpret_cast<const uint4*>(kk + rr * D + c);
        vv4 = *reinterpret_cast<const uint4*>(vv + rr * D + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDS + c) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * LDS + c) = vv4;
    }
  };

  for (int n0 = 0; n0 < nk; n0 += BLOCK_N) {
    const int nvalid = min(BLOCK_N, nk - n0);
    stage(nvalid, k, v, [&](int r) {
      const int n = n0 + r, line = n / wspan;
      return base + static_cast<size_t>(((t0 + line / bh_) * HH + h0 + line % bh_) * W + wlo +
                                        n % wspan);
    });
    __syncthreads();
    // the n-blocks of this sub-tile inside this warp's w window (wspan is a
    // multiple of 8, so an n-block never straddles two lines)
    uint32_t rel = 0u;
#pragma unroll
    for (int nb = 0; nb < BLOCK_N / 8; ++nb) {
      const int n8 = n0 + nb * 8;
      const int w8 = wlo + n8 % wspan;
      if (live && n8 < nk && w8 >= ws && w8 < ws + bw) rel |= 1u << nb;
    }
    if (rel)  // warp-uniform
      online_softmax_step<D, LDS>(qa, Ks, Vs, nullptr, nvalid, rel, sl, m, l, oacc, lane);
  }
  const size_t text0 = (static_cast<size_t>(b) * H + h) * Lt;
  for (int n0 = 0; n0 < Lt; n0 += BLOCK_N) {
    const int nvalid = min(BLOCK_N, Lt - n0);
    stage(nvalid, text_k, text_v, [&](int r) { return text0 + n0 + r; });
    for (int r = tid; r < BLOCK_N; r += nthreads) Bs[r] = r < nvalid ? text_bias[n0 + r] : 0.f;
    __syncthreads();
    if (live)
      online_softmax_step<D, LDS>(qa, Ks, Vs, Bs, nvalid, (1u << ((nvalid + 7) / 8)) - 1u, sl,
                                  m, l, oacc, lane);
  }

  const float l0 = row_sum(l[0]), l1 = row_sum(l[1]);
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * t;
    if (ok0)
      *reinterpret_cast<uint32_t*>(out + (base + q_token(rg)) * D + c) =
          pack_bf16(oacc[n][0] / l0, oacc[n][1] / l0);
    if (ok1)
      *reinterpret_cast<uint32_t*>(out + (base + q_token(rg8)) * D + c) =
          pack_bf16(oacc[n][2] / l1, oacc[n][3] / l1);
  }
}

template <int D>
cudaError_t launch(int B, int H, const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, const int* active,
                   const __nv_bfloat16* text_k, const __nv_bfloat16* text_v,
                   const float* text_bias, float sl, int Lt, int T, int HH, int W, int tt, int th,
                   int tw, int win_t, int win_h, int win_w, cudaStream_t st) {
  const int nw = W / tw;
  const int groups = (nw + MAX_WARPS - 1) / MAX_WARPS;
  const int per_group = (nw + groups - 1) / groups;
  const int stripes = (tt * th * tw + 15) / 16;
  const dim3 grid((T / tt) * (HH / th) * groups * stripes, H, B);
  sta_row_kernel<D><<<grid, per_group * 32, 0, st>>>(
      q, k, v, out, active, text_k, text_v, text_bias, sl, Lt, H, T, HH, W, tt, th, tw, win_t,
      win_h, win_w, groups, per_group, stripes);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: contiguous raster (B, H, T*HH*W, D) bf16 (q not pre-scaled);
// active: (H,) int32 on the device; text_k / text_v: contiguous (B, H, Lt, D)
// bf16 and text_bias (Lt,) f32, or null with Lt = 0; sl = scale * log2(e);
// tile_w a multiple of 8.  hopper: the wrapper's rule
// (ops/sta_row.py:row_wgmma_path) chose the Hopper path, with walk
// (n_slots, WALK_COLS) int32 on the device and boxes of box_w = run_w
// tokens x box_h rows (csrc/sta_window_src.cuh: launch_window_online);
// anything else there is an error, never a fallback.  Returns the CUDA
// error code.
extern "C" int vorta_sta_row_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                      const void* active, const void* text_k,
                                      const void* text_v, const void* text_bias, float sl,
                                      int Lt, int B, int H, int T, int HH, int W, int D, int tt,
                                      int th, int tw, int win_t, int win_h, int win_w,
                                      const void* walk, int n_slots, int box_w, int box_h,
                                      int run_w, int hopper, void* stream) {
  if (T % tt || HH % th || W % tw || tw % 8 || (D != 64 && D != 128) || win_t < 1 ||
      win_h < 1 || win_w < 1 || Lt < 0 || (Lt > 0 && (!text_k || !text_v || !text_bias)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hopper)  // the wrapper's rule picked the Hopper path: its shapes or an error
    return launch_window_online<false>(q, k, v, out, active, text_k, text_v, text_bias, sl, Lt,
                                       B, H, T, HH, W, D, tt, th, tw, win_t, win_h, win_w, walk,
                                       n_slots, box_w, box_h, run_w,
                                       static_cast<cudaStream_t>(stream));
  using bf = __nv_bfloat16;
  auto run = [&](auto launcher) {
    return launcher(B, H, static_cast<const bf*>(q), static_cast<const bf*>(k),
                    static_cast<const bf*>(v), static_cast<bf*>(out),
                    static_cast<const int*>(active), static_cast<const bf*>(text_k),
                    static_cast<const bf*>(text_v), static_cast<const float*>(text_bias), sl, Lt,
                    T, HH, W, tt, th, tw, win_t, win_h, win_w, static_cast<cudaStream_t>(stream));
  };
  return static_cast<int>(D == 128 ? run(launch<128>) : run(launch<64>));
}

// ---- the f32 mode: csrc/attn_f32.cuh's FFMA core over the window ----------

namespace {

// sta_row.py:_kernel at f32 inputs: the stable softmax over the window and the text
// tail, q unscaled and the scores times sl = scale * log2(e), P kept in f32.
template <int D>
__global__ void __launch_bounds__(vorta::f32::THREADS, 2)
sta_row_f32_kernel(const float* __restrict__ q, float* __restrict__ out,
                   const __grid_constant__ vorta::f32::WindowParams p, float sl) {
  const vorta::f32::WindowWalk walk(p);
  vorta::f32::attend<D>(walk, q, out, sl, /*stable=*/true);
}

}  // namespace

// The f32 mode (csrc/window_walk_f32.cuh: launch_window_stable's
// arguments; an inactive head writes zeros); D 64 or 128; tile_w a multiple of 8.
// work: sta_window's scratch argument, which sta_row's f32 mode refuses: it
// has no tensor-core walk (it stays on the FFMA core; no served path runs
// it).  Returns the CUDA error code.
extern "C" int vorta_sta_row_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                     const void* active, const void* text_k, const void* text_v,
                                     const void* text_bias, float sl, int Lt, int B, int H, int T,
                                     int HH, int W, int D, int tt, int th, int tw, int win_t,
                                     int win_h, int win_w, void* work, void* stream) {
  if (tw % 8 || work != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(vorta::f32::launch_window_stable(
      sta_row_f32_kernel<64>, sta_row_f32_kernel<128>, q, k, v, out, active, text_k, text_v,
      text_bias, sl, Lt, B, H, T, HH, W, D, tt, th, tw, win_t, win_h, win_w, stream));
}
