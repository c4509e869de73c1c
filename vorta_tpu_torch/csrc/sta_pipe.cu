// Sliding-tile attention forward on the raster layout, for Hopper (sm_90a).
//
// Replaces vorta_tpu/ops/sta_pipe.py:_kernel (reached through
// sta_pipe_attention).  Same function: every query of a
// (tile_t, tile_h, tile_w) tile attends to all tokens of the tiles in its
// window, the window start clamped per axis to
// clip(q_tile - win // 2, 0, n_tiles - min(win, n_tiles)) tiles, as
// geometry.window_starts gives it.  q arrives pre-scaled by
// scale * log2(e) (rounded to bf16 by the wrapper, as the JAX wrapper
// rounds it); p = exp2(q.k) with no running max (qk-normed inputs), P
// rounded to bf16 before the PV product, rows normalised by l.  Heads whose
// active entry is 0 write zeros.  With a joint text tail (HunyuanVideo's
// text_k / text_v, (B, H, Lt, D), and text_bias, (Lt,) f32), every query
// of an active head also attends to the Lt text keys, the bias added to
// their scores (p = exp2(q.k + bias), -1e30 on padded text), after its
// window's keys, as the TPU kernel's last step does (sta_pipe.py:308-318).
// The TPU kernel's per-w-tile, grouped-width and masked-width variants are
// VMEM layouts of this one function, so this kernel serves every tile width.
//
// Bound on this card: at Wan-1.3B 480p x 77f (31,200 tokens, tile (4, 6, 4),
// window (3, 3, 3): 2,592 keys per query) the work is 4 * 31,200 * 2,592 *
// 128 = 4.1e10 FLOP per head against 24 MB of operands, so the tensor cores
// bound it (0.042 ms per head at 989 TFLOP/s bf16; 0.362 ms at 720p, tile
// (5, 9, 8), 9,720 keys).  Two designs, chosen per call by the wrapper's
// rule (ops/sta_pipe.py:sta_wgmma_path, mirrored by the C entry):
//
// - The Hopper path (D = 128, bf16, the fast softmax, the full variant,
//   with or without the text tail, on every tile whose window runs can land
//   on 8-row multiples and whose slot table fits shared memory: every
//   served geometry): csrc/attn_sm90.cuh's mainloop with the fast policy
//   over WindowSource<-1> (csrc/sta_window_src.cuh, which sta_window's
//   Hopper path shares; sta_pipe_sm90_kernel).  A CTA takes 128 rows of one
//   q tile (96 / 360 / 432-row tiles take 1 / 3 / 4 CTAs, the rows past the
//   tile idle); Q arrives by plain 16-byte loads, each row from its raster
//   token, into the swizzled layout, each consumer warpgroup loading its
//   own 64 rows while the first K/V copies fly.  The window is a box of bt
//   x bh x bw tokens from its clamped origin, bt * bh runs of bw contiguous
//   tokens of the raster tensors; a 4D tensor map (D, W, HH, B*H*T) loads
//   box_h runs at a time by TMA, and a host table (ops/sta_pipe.py:
//   window_walk, copied into shared memory so that its reads stay off the
//   producer's path) packs those boxes into 128-key ring slots, each box on
//   a multiple of 8 rows (the 1,024 B atom of the 128-byte swizzle).  Runs
//   of 24 tokens fill 120 of a slot's 128 keys, 5 boxes a slot; the last 8
//   columns are masked per 8-column block, and the V ring is zeroed once
//   (the rows no box fills meet P = 0, and 0 x NaN is not 0).  The text
//   tail's keys follow in 128-key slots of a 2D map, text_bias loaded as
//   flash_manual loads kv_bias.  An inactive head writes zeros and exits.
// - The mma.sync path (the int8 QK mode, the stable softmax, the dots / qk /
//   sT variants, D = 64, tiles whose runs cannot land on 8-row multiples),
//   below: one CUDA block per (64- or 32-row chunk of a q tile, head,
//   batch); its window's (t, h) runs gathered straight from the raster
//   tensors into 64-key shared-memory sub-tiles between two barriers (no
//   relayout pass); products on mma.sync m16n8k16 with the tile code of
//   csrc/flash.cu.  The q tiles of one window re-read its keys from L2.
//
// The int8 QK mode (qk_scale, sta_pipe.py:197-210): q, k and text_k arrive
// as int8 with an (H,) f32 qk_scale = q_scale * k_scale, q not pre-scaled;
// the window's and the text tail's scores are exact int32 sums of mma.sync
// m16n8k32 s8 (mma_s8.cuh) times qk_scale[h] * scale * log2(e), then as
// above.  K's shared-memory tile halves; V, P and PV stay bf16.  With an
// f32 v and text_v the f32 mode's kernel takes the int8 q / k / text_k
// instead (sta_pipe_f32_kernel<D, true>: csrc/attn_f32.cuh's int8 QK, exact
// dp4a sums times the same factor, P and PV in f32).
//
// MODE selects the window's softmax and the TPU kernel's diagnostic
// variants (sta_pipe.py:270-302): FAST (above); STABLE, a running max per
// row (the online step of sta_common.cuh on the pre-scaled scores, no
// m_safe, as sta_pipe.py:260-269); and with the fast or stable text tail
// (text_stable), DOTS (p = bf16(s * 1e-3), no max, no l), QK (O += rowsum(s)
// * 1e-3 on every column, no PV product, no l) and ST (the fast softmax on
// the transposed scores S^T = K Q^T: K the A operand, Q's fragments the B
// operand, P^T turned into P's A fragments by movmatrix.trans, the row sums
// taken down the columns of P^T; its output is FAST's).  The variants leave
// the running max at -1e30, so a stable text tail after them rescales the
// window's sums by exp2(-1e30 - m) = 0, as the TPU kernel's does.  The text
// tail is always the softmax step (sta_pipe.py:309-318), whatever the mode.
#include <type_traits>

#include <algorithm>

#include "attn_sm90.cuh"
#include "mma_s8.cuh"
#include "sta_common.cuh"
#include "sta_window_src.cuh"
#include "window_walk_f32.cuh"

namespace {

using namespace vorta;

constexpr int BLOCK_N = 64;  // keys per shared-memory sub-tile

enum Mode { FAST = 0, STABLE = 1, DOTS = 2, QK = 3, ST = 4 };

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// I8: q, k and text_k are int8 (qk_scale mode, FAST only), rows of DK = D /
// 2 b16 values; else bf16, DK = D.
template <int D, int WARPS, bool I8, int MODE>
__global__ void __launch_bounds__(WARPS * 32)
sta_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
           const int* __restrict__ active, const __nv_bfloat16* __restrict__ text_k,
           const __nv_bfloat16* __restrict__ text_v, const float* __restrict__ text_bias,
           const float* __restrict__ qkc, int Lt, int H, int T, int HH, int W, int tt, int th,
           int tw, int win_t, int win_h, int win_w, int chunks, int text_stable) {
  static_assert(!I8 || MODE == FAST, "the int8 mode is the fast full variant only");
  constexpr int BLOCK_M = 16 * WARPS;
  constexpr int DK = I8 ? D / 2 : D;  // a q / k row in b16 units
  constexpr int LDK = DK + 8;
  constexpr int LDS = D + 8;
  constexpr int NT_S = BLOCK_N / 8;
  constexpr int NT_O = D / 8;
  constexpr int CHUNKS = D / 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[BLOCK_N * LDK];
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
  uint32_t qa[DK / 16][4];
  load_q_frags<DK>(qa, rg < tpt ? q + (base + q_token(rg)) * DK : nullptr,
                   rg8 < tpt ? q + (base + q_token(rg8)) * DK : nullptr, t);
  const float qk_factor = I8 ? qkc[h] : 1.f;
  float oacc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float l_part[2] = {0.f, 0.f};
  float m[2] = {NEG_INF, NEG_INF};  // running max (STABLE, a stable text tail)
  float l_st[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // ST: column sums of P^T, queries 8ni + 2t + e

  // ST: S^T = K Q^T for the 64 staged keys (4 m-tiles of 16) x this warp's 16
  // queries (2 n-tiles of 8: Q's fragments qa[kk][0 / 2] and qa[kk][1 / 3]
  // are the B operand), p^T = exp2(S^T), then O += P V with P's A fragments
  // the movmatrix transposes of P^T's accumulator blocks
  auto st_step = [&](int nvalid) {
    const int mi = lane / 8, mr = lane % 8;
#pragma unroll
    for (int mt = 0; mt < BLOCK_N / 16; ++mt) {
      float st[2][4];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) st[ni][0] = st[ni][1] = st[ni][2] = st[ni][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, Ks + (mt * 16 + (mi & 1) * 8 + mr) * LDK + kk * 16 + (mi >> 1) * 8);
        mma_bf16(st[0], a, qa[kk][0], qa[kk][2]);
        mma_bf16(st[1], a, qa[kk][1], qa[kk][3]);
      }
      uint32_t x[2][2];  // [ni][key half]: P^T blocks keys 16mt + 8 half + g, queries 8ni + 2t
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = mt * 16 + g + 8 * (e >> 1);
          const float p = key < nvalid ? exp2f(st[ni][e]) : 0.f;
          st[ni][e] = p;
          l_st[ni][e & 1] += p;
        }
        x[ni][0] = movmatrix_trans(pack_bf16(st[ni][0], st[ni][1]));
        x[ni][1] = movmatrix_trans(pack_bf16(st[ni][2], st[ni][3]));
      }
      const uint32_t pa[4] = {x[0][0], x[1][0], x[0][1], x[1][1]};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t r[4];
        ldsm_x4_trans(r, Vs + (mt * 16 + (mi & 1) * 8 + mr) * LDS + n * 8 + (mi >> 1) * 8);
        mma_bf16(oacc[n], pa, r[0], r[1]);
        mma_bf16(oacc[n + 1], pa, r[2], r[3]);
      }
    }
  };

  // one 64-key sub-tile: stage K / V rows (key r at kv_row(r), r < nvalid)
  // and, for text keys, their bias; then the mode's step (text: the softmax)
  auto step = [&](int nvalid, auto kv_row, auto text_key) {
    constexpr bool TEXT = decltype(text_key)::value;
    __syncthreads();  // previous sub-tile fully consumed
    // one pass over V's chunks, K's (DK / 8 per row) among them: kv_row's
    // divisions once per chunk, both loads issued before the stores
    for (int e = tid; e < BLOCK_N * CHUNKS; e += WARPS * 32) {
      const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (r < nvalid) {
        const size_t row = kv_row(r);
        if (c < DK) kv4 = *reinterpret_cast<const uint4*>((TEXT ? text_k : k) + row * DK + c);
        vv4 = *reinterpret_cast<const uint4*>((TEXT ? text_v : v) + row * D + c);
      }
      if (c < DK) *reinterpret_cast<uint4*>(Ks + r * LDK + c) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * LDS + c) = vv4;
    }
    if constexpr (TEXT)
      for (int r = tid; r < BLOCK_N; r += WARPS * 32)
        Bs[r] = r < nvalid ? text_bias[kv_row(r) % Lt] : 0.f;
    __syncthreads();

    if constexpr (!I8 && MODE != FAST) {
      // FAST's text tail is fast and STABLE's stable; a variant's follows text_stable
      if (TEXT ? (MODE == STABLE || text_stable != 0) : MODE == STABLE) {
        const unsigned rel = (1u << ((nvalid + 7) / 8)) - 1u;
        online_softmax_step<D, LDS>(qa, Ks, Vs, TEXT ? Bs : nullptr, nvalid, rel, 1.f, m,
                                    l_part, oacc, lane);
        return;
      }
      if constexpr (!TEXT && MODE == ST) {
        st_step(nvalid);
        return;
      }
    }
    float s[NT_S][4];
    if constexpr (I8)
      qk_tile_s8<DK, NT_S, LDK>(s, qa, Ks, qk_factor, lane);
    else
      qk_tile<D, NT_S, LDS>(s, qa, Ks, lane);
    if constexpr (!TEXT && MODE == QK) {
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n * 8 + 2 * t + (e & 1) < nvalid) rs[e >> 1] += s[n][e];
      rs[0] = quad_sum(rs[0]) * 1e-3f;
      rs[1] = quad_sum(rs[1]) * 1e-3f;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        oacc[n][0] += rs[0];
        oacc[n][1] += rs[0];
        oacc[n][2] += rs[1];
        oacc[n][3] += rs[1];
      }
      return;
    }
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        float p;
        if constexpr (!TEXT && MODE == DOTS) {
          p = (col < nvalid) ? s[n][e] * 1e-3f : 0.f;
        } else {
          p = (col < nvalid) ? exp2f(TEXT ? s[n][e] + Bs[col] : s[n][e]) : 0.f;
          l_part[e >> 1] += p;
        }
        s[n][e] = p;
      }
    }
    pv_tile<D, NT_S, LDS>(oacc, s, Vs, lane);
  };

  for (int n0 = 0; n0 < nk; n0 += BLOCK_N)
    step(min(BLOCK_N, nk - n0), [&](int r) {
      const int n = n0 + r;
      return base + static_cast<size_t>(
          ((t0 + n / (bh_ * bw)) * HH + h0 + (n / bw) % bh_) * W + w0 + n % bw);
    }, std::false_type{});
  if constexpr (MODE == ST) {
    // P^T's column sums down the 8 key rows of each block (lanes g), then
    // row g's and g + 8's sums to this thread, into the quad's first lane
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o *= 2) l_st[ni][e] += __shfl_xor_sync(0xffffffffu, l_st[ni][e], o);
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const float e0 = __shfl_sync(0xffffffffu, l_st[ni][0], g >> 1);
      const float e1 = __shfl_sync(0xffffffffu, l_st[ni][1], g >> 1);
      l_part[ni] = t == 0 ? ((g & 1) ? e1 : e0) : 0.f;
    }
  }
  const size_t text0 = (static_cast<size_t>(b) * H + h) * Lt;
  for (int n0 = 0; n0 < Lt; n0 += BLOCK_N)
    step(min(BLOCK_N, Lt - n0), [&](int r) { return text0 + n0 + r; },
         std::true_type{});

  const float l0 = row_sum(l_part[0]), l1 = row_sum(l_part[1]);
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

template <int D, int WARPS, bool I8, int MODE>
cudaError_t launch(int B, int H, const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, const int* active,
                   const __nv_bfloat16* text_k, const __nv_bfloat16* text_v,
                   const float* text_bias, const float* qkc, int Lt, int T, int HH, int W,
                   int tt, int th, int tw, int win_t, int win_h, int win_w, int text_stable,
                   cudaStream_t st) {
  const int tpt = tt * th * tw, chunks = (tpt + 16 * WARPS - 1) / (16 * WARPS);
  const dim3 grid((T / tt) * (HH / th) * (W / tw) * chunks, H, B);
  sta_kernel<D, WARPS, I8, MODE><<<grid, WARPS * 32, 0, st>>>(
      q, k, v, out, active, text_k, text_v, text_bias, qkc, Lt, H, T, HH, W, tt, th, tw, win_t,
      win_h, win_w, chunks, text_stable);
  return cudaGetLastError();
}

template <int D, int WARPS>
cudaError_t launch_mode(int mode, bool i8, int B, int H, const __nv_bfloat16* q,
                        const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* out,
                        const int* active, const __nv_bfloat16* text_k,
                        const __nv_bfloat16* text_v, const float* text_bias, const float* qkc,
                        int Lt, int T, int HH, int W, int tt, int th, int tw, int win_t,
                        int win_h, int win_w, int text_stable, cudaStream_t st) {
  auto run = [&](auto launcher) {
    return launcher(B, H, q, k, v, out, active, text_k, text_v, text_bias, qkc, Lt, T, HH, W, tt,
                    th, tw, win_t, win_h, win_w, text_stable, st);
  };
  if (i8) return run(launch<D, WARPS, true, FAST>);
  switch (mode) {
    case FAST: return run(launch<D, WARPS, false, FAST>);
    case STABLE: return run(launch<D, WARPS, false, STABLE>);
    case DOTS: return run(launch<D, WARPS, false, DOTS>);
    case QK: return run(launch<D, WARPS, false, QK>);
    default: return run(launch<D, WARPS, false, ST>);
  }
}

// ---- the Hopper path: csrc/attn_sm90.cuh's mainloop over the window --------------

__global__ void __launch_bounds__(sm90::THREADS, 1)
sta_pipe_sm90_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tkt,
                     const __grid_constant__ CUtensorMap tvt, const __grid_constant__ StaParams p) {
  WindowSource<-1> src{&tk, &tv, &tkt, &tvt, p};
  sm90::attn_mainloop<sm90::Softmax::Fast, false>(src);
}

}  // namespace

// q (pre-scaled), k, v, out: contiguous raster (B, H, T*HH*W, D) bf16;
// active: (H,) int32 on the device; text_k / text_v: contiguous (B, H, Lt, D)
// bf16 and text_bias (Lt,) f32, or null with Lt = 0.  qk_factor: null, or
// (H,) f32 qk_scale * scale * log2(e) on the device, and then q, k and
// text_k are int8 (q not pre-scaled).  mode: 0 fast, 1 stable, 2 dots, 3 qk,
// 4 sT (0 with qk_factor); text_stable: the text tail's softmax is the
// stable one (the caller's softmax="stable").  hopper: the wrapper's rule
// (ops/sta_pipe.py:sta_wgmma_path) chose the Hopper path, with walk
// (n_slots, WALK_COLS) int32 on the device and boxes of box_w tokens x
// box_h rows (box_w the window's run, box_h dividing its rows, box_w *
// box_h a multiple of 8 up to 128); k, v, text_k, text_v 16-byte aligned,
// text_bias too; anything else there is an error, never a fallback.
// Returns the CUDA error code.
extern "C" int vorta_sta_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                  const void* active, const void* text_k, const void* text_v,
                                  const void* text_bias, const void* qk_factor, int Lt, int B,
                                  int H, int T, int HH, int W, int D, int tt, int th, int tw,
                                  int win_t, int win_h, int win_w, int mode, int text_stable,
                                  const void* walk, int n_slots, int box_w, int box_h,
                                  int hopper, void* stream) {
  if (T % tt || HH % th || W % tw || (D != 64 && D != 128) || win_t < 1 || win_h < 1 ||
      win_w < 1 || Lt < 0 || (Lt > 0 && (!text_k || !text_v || !text_bias)) || mode < 0 ||
      mode > 4 || (qk_factor && (mode != FAST || text_stable)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hopper) {  // the wrapper's rule picked the Hopper path: its shapes or an error
    const int bh = std::min(win_h, HH / th) * th, bw = std::min(win_w, W / tw) * tw;
    if (D != sm90::D || mode != FAST || qk_factor || text_stable || !walk || n_slots < 1 ||
        sta_smem_bytes(n_slots) > 232448 ||
        box_w != bw || box_h < 1 || bh % box_h || (box_w * box_h) % 8 ||
        box_w * box_h > sm90::BN || Lt % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    const int tpt = tt * th * tw;
    const StaParams p{static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(q),
                      static_cast<const int*>(active), static_cast<const int*>(walk),
                      static_cast<const float*>(text_bias), n_slots, H, T, HH, W, tt, th, tw,
                      win_t, win_h, win_w, (tpt + sm90::BM - 1) / sm90::BM, box_w, box_h, Lt,
                      box_w, 0.f};
    return static_cast<int>(launch_window(sta_pipe_sm90_kernel, B, p, k, v, text_k, text_v,
                                          static_cast<cudaStream_t>(stream)));
  }
  using bf = __nv_bfloat16;
  auto* qq = static_cast<const bf*>(q);
  auto* kk = static_cast<const bf*>(k);
  auto* vv = static_cast<const bf*>(v);
  auto* oo = static_cast<bf*>(out);
  auto* act = static_cast<const int*>(active);
  auto* tk = static_cast<const bf*>(text_k);
  auto* tv = static_cast<const bf*>(text_v);
  auto* tb = static_cast<const float*>(text_bias);
  auto* qf = static_cast<const float*>(qk_factor);
  auto st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto launcher) {
    return launcher(mode, qf != nullptr, B, H, qq, kk, vv, oo, act, tk, tv, tb, qf, Lt, T, HH, W,
                    tt, th, tw, win_t, win_h, win_w, text_stable, st);
  };
  // 2 warps (32 q rows) where that tiles the q tile exactly and 4 would not
  const int tpt = tt * th * tw;
  const bool two = tpt % 64 != 0 && tpt % 32 == 0;
  cudaError_t err;
  if (D == 128)
    err = two ? run(launch_mode<128, 2>) : run(launch_mode<128, 4>);
  else
    err = two ? run(launch_mode<64, 2>) : run(launch_mode<64, 4>);
  return static_cast<int>(err);
}

// The Hopper path's dynamic shared memory per CTA for a walk table of
// n_slots rows, in bytes (for reports).
extern "C" int vorta_sta_sm90_smem_bytes(int n_slots) { return sta_smem_bytes(n_slots); }

// ---- the f32 mode: csrc/attn_f32.cuh's FFMA core over the window ----------

namespace {

// I8: int8 q / k / text_k with an f32 v and text_v (the int8 QK mode of the
// f32 path): the scores are the exact int32 sums (dp4a) times qkc[h].
template <int D, bool I8>
__global__ void __launch_bounds__(vorta::f32::THREADS, 2)
sta_pipe_f32_kernel(const void* __restrict__ q, float* __restrict__ out,
                    const __grid_constant__ vorta::f32::WindowParams p,
                    const float* __restrict__ qkc, int stable) {
  const vorta::f32::WindowWalk walk(p);
  vorta::f32::attend<D, vorta::f32::WindowWalk, I8>(walk, q, out, I8 ? qkc[walk.h] : 1.f,
                                                    stable != 0);
}

}  // namespace

// The f32 mode (sta_pipe.py's kernel at f32 inputs, the full variant): q
// (pre-scaled in f32), k, v, out contiguous raster (B, H, T*HH*W, D) f32;
// active (H,) int32; text_k / text_v (B, H, Lt, D) f32 and text_bias (Lt,)
// f32, or null with Lt = 0.  stable: the stable softmax over the window and
// the text tail (a running max, as the TPU kernel's stable mode), else the
// fast one.  qk_factor: null, or (H,) f32 qk_scale * scale * log2(e) with q,
// k and text_k int8 (q not pre-scaled; the fast softmax): the int8 QK mode
// with an f32 v.  D 64 or 128.  P kept in f32.  Returns the CUDA error code.
extern "C" int vorta_sta_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                 const void* active, const void* text_k, const void* text_v,
                                 const void* text_bias, const void* qk_factor, int Lt, int B,
                                 int H, int T, int HH, int W, int D, int tt, int th, int tw,
                                 int win_t, int win_h, int win_w, int stable, void* stream) {
  if (!vorta::f32::window_shape_ok(T, HH, W, D, tt, th, tw, win_t, win_h, win_w, Lt, text_k,
                                   text_v, text_bias, active) ||
      (qk_factor && stable))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool i8 = qk_factor != nullptr;
  const vorta::f32::WindowParams p = vorta::f32::window_params(
      k, v, text_k, text_v, text_bias, active, Lt, H, T, HH, W, D, tt, th, tw, win_t, win_h,
      win_w, i8 ? 1 : 4);
  const dim3 grid = vorta::f32::window_grid(B, p);
  auto st = static_cast<cudaStream_t>(stream);
  auto* oo = static_cast<float*>(out);
  auto* qf = static_cast<const float*>(qk_factor);
  auto run = [&](auto kern, auto d) {
    return vorta::f32::launch<decltype(d)::value>(kern, grid, st, q, oo, p, qf, stable);
  };
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  cudaError_t err;
  if (D == 128)
    err = i8 ? run(sta_pipe_f32_kernel<128, true>, D128{})
             : run(sta_pipe_f32_kernel<128, false>, D128{});
  else
    err = i8 ? run(sta_pipe_f32_kernel<64, true>, D64{})
             : run(sta_pipe_f32_kernel<64, false>, D64{});
  return static_cast<int>(err);
}
