// Window-dense sliding-tile attention with the stable softmax, one q tile
// over its window box, for Hopper (sm_90a).
//
// Replaces vorta_tpu/ops/sta_window.py:_kernel (reached through
// sta_window_attention), the JAX package's last window-dense STA fallback.
// Same function: every query of a (tile_t, tile_h, tile_w) tile attends to
// all tokens of the prod(window) tiles of its window, the window start
// clamped per axis to clip(q_tile - win // 2, 0, n_tiles - min(win,
// n_tiles)) tiles (geometry.window_starts), read straight from the raster
// (B, H, S, D) tensors.  Softmax is the TPU kernel's stable one: scores
// q.k * (scale * log2(e)) in f32 (q not pre-scaled), a running max, P
// rounded to bf16 before the PV product, rows normalised by l.  Heads whose
// active entry is 0 write zeros.  With a joint text tail (text_k / text_v
// (B, H, Lt, D), text_bias (Lt,) f32) every query of an active head also
// attends to the Lt text keys, the bias added after the scale
// (sta_window.py:294), after its window's keys.  The TPU kernel's
// 8-aligned superset box with its slack-column bias, for a tile_w that is
// not a multiple of 8, is a VMEM layout detail: here every tile width reads
// exactly its window.
//
// Bound on this card: at Wan-1.3B 720p x 77f with tile (4, 9, 10) (72,000
// tokens, 9,720 keys per query) the work is 4 * 72,000 * 9,720 * 128 =
// 3.6e11 FLOP per head against 74 MB of operands, so the tensor cores bound
// it (0.36 ms per head at 989 TFLOP/s bf16).  Two designs, chosen per call
// by the wrapper's rule (ops/sta_window.py:window_wgmma_path, mirrored by
// the C entry):
//
// - The Hopper path (D = 128, a window box that lands, a slot table that
//   fits shared memory, a text tail of a multiple of 8 keys: every served
//   geometry): csrc/attn_sm90.cuh's mainloop with the online softmax over
//   the window source of csrc/sta_window_src.cuh (sta_window_sm90_kernel,
//   which sta_row.cu instantiates too),
//   sta_pipe's Hopper path with sta_window's softmax.  At (4, 9, 10) the
//   window's 324 runs of 30 tokens land on no 8-row multiple (27 runs per
//   plane, 30 * box_h never a multiple of 8), so each run is read as a box
//   of 32 tokens, 4 a slot (93.75% of the products useful), the 2 extra
//   columns masked: in the interior they are the neighbouring tile's
//   tokens.  Which of a slot's 8-column blocks end a run is a compile-time
//   pattern (RB, the run's 8-column blocks), so the mask costs one select
//   on 8 of a thread's 64 scores, with no branch.  The online softmax is
//   the mainloop's (flash's), the text slots' bias added after the scale.
// - The mma.sync path (D = 64, windows with no box, tables past the shared
//   memory), below: one CUDA block of 4 warps per (64-row chunk of a q
//   tile, head, batch); the window box is walked in 64-key sub-tiles
//   gathered from its contiguous w runs into shared memory; one
//   online-softmax step per sub-tile on mma.sync m16n8k16 (sta_common.cuh).
//   The q tiles of one window re-read its keys from L2.
//
// The f32 mode (f32 q / k / v and text, the JAX package's --dtype fp32 at
// a --resume_dir tile that sends the STA heads here): the stable softmax
// with q unscaled and the scores times sl, P kept in f32, on one of two
// kernels by the wrapper's rule (ops/sta_pipe.py:sta_f32_tc_path,
// mirrored by the C entry: a scratch pointer asks for the tensor cores).
// At D = 128 with q tiles of a multiple of 8 tokens (the (4, 9, 10) tile's
// 360: every served call) sta_window_f32_tc_kernel, 3xTF32 on wgmma over q,
// k and V^T gathered into tile-major order (csrc/window_walk_f32_tc.cuh);
// at 720p x 77f, 8 heads, the work is 2.87e12 FLOP, 3 x that at 495 TFLOP/s
// TF32: 17.4 ms bounds it.  Else (D = 64) sta_window_f32_kernel<D>, the FFMA
// core of csrc/attn_f32.cuh over the window walk of csrc/window_walk_f32.cuh
// (per 64-row part of a q tile, every key of the window then the text tail
// in 64-key chunks, each staged through its own row pointer, so runs of any
// width need no padding and no masked column): 42.8 ms at 67 TFLOP/s f32 at
// the same call, which sta_window_attention_ffma times beside the tensor
// cores.
#include "sta_common.cuh"
#include "sta_window_src.cuh"
#include "window_walk_f32.cuh"
#include "window_walk_f32_tc.cuh"

namespace {

using namespace vorta;

constexpr int BLOCK_N = 64;  // keys per shared-memory sub-tile
constexpr int WARPS = 4;
constexpr int BLOCK_M = 16 * WARPS;

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
sta_window_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ active, const __nv_bfloat16* __restrict__ text_k,
                  const __nv_bfloat16* __restrict__ text_v, const float* __restrict__ text_bias,
                  float sl, int Lt, int H, int T, int HH, int W, int tt, int th, int tw,
                  int win_t, int win_h, int win_w, int chunks) {
  constexpr int LDS = D + 8;  // padded rows: conflict-free ldmatrix
  constexpr int NT_O = D / 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 Ks[BLOCK_N * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BLOCK_N * LDS];
  __shared__ float Bs[BLOCK_N];  // text_bias of a text sub-tile

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nt = T / tt, nh = HH / th, nw = W / tw;
  const int tile = blockIdx.x / chunks;
  const int row0 = (blockIdx.x % chunks) * BLOCK_M;
  const int it = tile / (nh * nw), ih = (tile / nw) % nh, iw = tile % nw;
  const int tpt = tt * th * tw;
  const size_t base = (static_cast<size_t>(b) * H + h) * T * HH * W;
  // raster token of row r of this q tile
  auto q_token = [&](int r) {
    return ((it * tt + r / (th * tw)) * HH + ih * th + (r / tw) % th) * W + iw * tw + r % tw;
  };

  if (active[h] == 0) {
    const int rows = min(BLOCK_M, tpt - row0);
    for (int e = tid; e < rows * CHUNKS; e += WARPS * 32) {
      const int r = row0 + e / CHUNKS, c = (e % CHUNKS) * 8;
      *reinterpret_cast<uint4*>(out + (base + q_token(r)) * D + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  // the window box: bt x bh x bw tokens from (t0, h0, w0)
  const int t0 = window_start(it, nt, win_t, tt);
  const int h0 = window_start(ih, nh, win_h, th);
  const int w0 = window_start(iw, nw, win_w, tw);
  const int bh_ = min(win_h, nh) * th, bw = min(win_w, nw) * tw;
  const int nk = min(win_t, nt) * tt * bh_ * bw;

  const int rg = row0 + warp * 16 + g, rg8 = rg + 8;
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, rg < tpt ? q + (base + q_token(rg)) * D : nullptr,
                  rg8 < tpt ? q + (base + q_token(rg8)) * D : nullptr, t);
  float oacc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // stage keys r < nvalid of a sub-tile (key r at row kv_row(r) of kk / vv)
  auto stage = [&](int nvalid, const __nv_bfloat16* kk, const __nv_bfloat16* vv, auto kv_row) {
    __syncthreads();  // previous sub-tile fully consumed
    for (int e = tid; e < BLOCK_N * CHUNKS; e += WARPS * 32) {
      const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (r < nvalid) {
        const size_t row = kv_row(r);
        kv4 = *reinterpret_cast<const uint4*>(kk + row * D + c);
        vv4 = *reinterpret_cast<const uint4*>(vv + row * D + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDS + c) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * LDS + c) = vv4;
    }
  };
  auto nblocks = [](int nvalid) { return (1u << ((nvalid + 7) / 8)) - 1u; };

  for (int n0 = 0; n0 < nk; n0 += BLOCK_N) {
    const int nvalid = min(BLOCK_N, nk - n0);
    stage(nvalid, k, v, [&](int r) {
      const int n = n0 + r;
      return base + static_cast<size_t>(
          ((t0 + n / (bh_ * bw)) * HH + h0 + (n / bw) % bh_) * W + w0 + n % bw);
    });
    __syncthreads();
    online_softmax_step<D, LDS>(qa, Ks, Vs, nullptr, nvalid, nblocks(nvalid), sl, m, l, oacc,
                                lane);
  }
  const size_t text0 = (static_cast<size_t>(b) * H + h) * Lt;
  for (int n0 = 0; n0 < Lt; n0 += BLOCK_N) {
    const int nvalid = min(BLOCK_N, Lt - n0);
    stage(nvalid, text_k, text_v, [&](int r) { return text0 + n0 + r; });
    for (int r = tid; r < BLOCK_N; r += WARPS * 32) Bs[r] = r < nvalid ? text_bias[n0 + r] : 0.f;
    __syncthreads();
    online_softmax_step<D, LDS>(qa, Ks, Vs, Bs, nvalid, nblocks(nvalid), sl, m, l, oacc, lane);
  }

  const float l0 = row_sum(l[0]), l1 = row_sum(l[1]);
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * t;
    if (rg < tpt)
      *reinterpret_cast<uint32_t*>(out + (base + q_token(rg)) * D + c) =
          pack_bf16(oacc[n][0] / l0, oacc[n][1] / l0);
    if (rg8 < tpt)
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
  const int chunks = (tt * th * tw + BLOCK_M - 1) / BLOCK_M;
  const dim3 grid((T / tt) * (HH / th) * (W / tw) * chunks, H, B);
  sta_window_kernel<D><<<grid, WARPS * 32, 0, st>>>(q, k, v, out, active, text_k, text_v,
                                                    text_bias, sl, Lt, H, T, HH, W, tt, th, tw,
                                                    win_t, win_h, win_w, chunks);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: contiguous raster (B, H, T*HH*W, D) bf16 (q not pre-scaled);
// active: (H,) int32 on the device; text_k / text_v: contiguous (B, H, Lt, D)
// bf16 and text_bias (Lt,) f32, or null with Lt = 0; sl = scale * log2(e).
// hopper: the wrapper's rule (ops/sta_window.py:window_wgmma_path) chose the
// Hopper path, with walk (n_slots, WALK_COLS) int32 on the device and boxes
// of box_w tokens x box_h rows: box_w the window's run (run_w), or a run of
// 25 to 31 tokens padded to 32 (RB = 4);
// box_h dividing the window's rows, box_w * box_h a multiple of 8 up to
// 128; k, v, text_k, text_v and text_bias 16-byte aligned; anything else
// there is an error, never a fallback.  Returns the CUDA error code.
extern "C" int vorta_sta_window_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                         const void* active, const void* text_k,
                                         const void* text_v, const void* text_bias, float sl,
                                         int Lt, int B, int H, int T, int HH, int W, int D,
                                         int tt, int th, int tw, int win_t, int win_h,
                                         int win_w, const void* walk, int n_slots, int box_w,
                                         int box_h, int run_w, int hopper, void* stream) {
  if (T % tt || HH % th || W % tw || (D != 64 && D != 128) || win_t < 1 || win_h < 1 ||
      win_w < 1 || Lt < 0 || (Lt > 0 && (!text_k || !text_v || !text_bias)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hopper)  // the wrapper's rule picked the Hopper path: its shapes or an error
    return launch_window_online<true>(q, k, v, out, active, text_k, text_v, text_bias, sl, Lt, B,
                                      H, T, HH, W, D, tt, th, tw, win_t, win_h, win_w, walk,
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

// ---- the f32 mode: the tensor-core walk, or csrc/attn_f32.cuh's FFMA core --

namespace {

// sta_window.py:_kernel at f32 inputs: the stable softmax over the window and the text
// tail, q unscaled and the scores times sl = scale * log2(e), P kept in f32.
template <int D>
__global__ void __launch_bounds__(vorta::f32::THREADS, 2)
sta_window_f32_kernel(const float* __restrict__ q, float* __restrict__ out,
                      const __grid_constant__ vorta::f32::WindowParams p, float sl) {
  const vorta::f32::WindowWalk walk(p);
  vorta::f32::attend<D>(walk, q, out, sl, /*stable=*/true);
}

// The same on the tensor cores (csrc/window_walk_f32_tc.cuh: 3xTF32 on wgmma), D = 128.
__global__ void __launch_bounds__(vorta::f32tc::THREADS, 1)
sta_window_f32_tc_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ vorta::f32tc::WindowTc p, float sl) {
  vorta::f32tc::attend_window(tq, tk, tv, p, sl, /*stable=*/true);
}

}  // namespace

// The f32 mode (csrc/window_walk_f32.cuh: launch_window_stable's
// arguments; an inactive head writes zeros); D 64 or 128.  work: null (the
// FFMA core), or where the wrapper's rule (ops/sta_pipe.py:
// sta_f32_tc_path) chose the tensor cores, the scratch of
// csrc/window_walk_f32_tc.cuh (2 B H (S + 2 (S + Lt)) 128 f32, 16-byte
// aligned): then D = 128, a q tile of a multiple of 8 tokens and Lt a
// multiple of 8, else an error, never a fallback.  Returns the CUDA error
// code.
extern "C" int vorta_sta_window_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                        const void* active, const void* text_k, const void* text_v,
                                        const void* text_bias, float sl, int Lt, int B, int H,
                                        int T, int HH, int W, int D, int tt, int th, int tw,
                                        int win_t, int win_h, int win_w, void* work,
                                        void* stream) {
  if (work != nullptr) {
    if (!vorta::f32::window_shape_ok(T, HH, W, D, tt, th, tw, win_t, win_h, win_w, Lt, text_k,
                                     text_v, text_bias, active))
      return static_cast<int>(cudaErrorInvalidValue);
    const vorta::f32tc::WindowTc p = vorta::f32tc::window_tc(
        active, text_bias, out, Lt, H, T, HH, W, tt, th, tw, win_t, win_h, win_w);
    return static_cast<int>(vorta::f32tc::launch_window(
        sta_window_f32_tc_kernel, q, k, v, text_k, text_v, work, B, D, p,
        static_cast<cudaStream_t>(stream), sl));
  }
  return static_cast<int>(vorta::f32::launch_window_stable(
      sta_window_f32_kernel<64>, sta_window_f32_kernel<128>, q, k, v, out, active, text_k, text_v,
      text_bias, sl, Lt, B, H, T, HH, W, D, tt, th, tw, win_t, win_h, win_w, stream));
}
