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
// (5, 9, 8), 9,720 keys).  Design: one CUDA block per (64- or 32-row chunk
// of a q tile, head, batch); its window is a box of win*tile tokens per axis
// whose (t, h) rows are contiguous runs of win_w * tile_w tokens, gathered
// straight from the raster tensors into 64-key shared-memory sub-tiles (no
// relayout pass); products on mma.sync m16n8k16 with the tile code of
// csrc/flash.cu.  The q tiles of one window re-read its keys from L2.
// Simple first: no wgmma, TMA or cp.async pipelining yet.
//
// The int8 QK mode (qk_scale, sta_pipe.py:197-210): q, k and text_k arrive
// as int8 with an (H,) f32 qk_scale = q_scale * k_scale, q not pre-scaled;
// the window's and the text tail's scores are exact int32 sums of mma.sync
// m16n8k32 s8 (mma_s8.cuh) times qk_scale[h] * scale * log2(e), then as
// above.  K's shared-memory tile halves; V, P and PV stay bf16.
#include <type_traits>

#include "mma_s8.cuh"
#include "sta_common.cuh"

namespace {

using namespace vorta;

constexpr int BLOCK_N = 64;  // keys per shared-memory sub-tile

// I8: q, k and text_k are int8 (qk_scale mode), rows of DK = D / 2 b16
// values; else bf16, DK = D.
template <int D, int WARPS, bool I8>
__global__ void __launch_bounds__(WARPS * 32)
sta_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
           const int* __restrict__ active, const __nv_bfloat16* __restrict__ text_k,
           const __nv_bfloat16* __restrict__ text_v, const float* __restrict__ text_bias,
           const float* __restrict__ qkc, int Lt, int H, int T, int HH, int W, int tt, int th,
           int tw, int win_t, int win_h, int win_w, int chunks) {
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

  // one 64-key sub-tile: stage K / V rows (key r at kv_row(r), r < nvalid)
  // and, for text keys, their bias; accumulate exp2(s + bias) into l and O
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

    float s[NT_S][4];
    if constexpr (I8)
      qk_tile_s8<DK, NT_S, LDK>(s, qa, Ks, qk_factor, lane);
    else
      qk_tile<D, NT_S, LDS>(s, qa, Ks, lane);
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const float p = (col < nvalid) ? exp2f(TEXT ? s[n][e] + Bs[col] : s[n][e]) : 0.f;
        s[n][e] = p;
        l_part[e >> 1] += p;
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

template <int D, int WARPS, bool I8>
cudaError_t launch(int B, int H, const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, const int* active,
                   const __nv_bfloat16* text_k, const __nv_bfloat16* text_v,
                   const float* text_bias, const float* qkc, int Lt, int T, int HH, int W,
                   int tt, int th, int tw, int win_t, int win_h, int win_w, cudaStream_t st) {
  const int tpt = tt * th * tw, chunks = (tpt + 16 * WARPS - 1) / (16 * WARPS);
  const dim3 grid((T / tt) * (HH / th) * (W / tw) * chunks, H, B);
  sta_kernel<D, WARPS, I8><<<grid, WARPS * 32, 0, st>>>(
      q, k, v, out, active, text_k, text_v, text_bias, qkc, Lt, H, T, HH, W, tt, th, tw, win_t,
      win_h, win_w, chunks);
  return cudaGetLastError();
}

}  // namespace

// q (pre-scaled), k, v, out: contiguous raster (B, H, T*HH*W, D) bf16;
// active: (H,) int32 on the device; text_k / text_v: contiguous (B, H, Lt, D)
// bf16 and text_bias (Lt,) f32, or null with Lt = 0.  qk_factor: null, or
// (H,) f32 qk_scale * scale * log2(e) on the device, and then q, k and
// text_k are int8 (q not pre-scaled).  Returns the CUDA error code.
extern "C" int vorta_sta_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                  const void* active, const void* text_k, const void* text_v,
                                  const void* text_bias, const void* qk_factor, int Lt, int B,
                                  int H, int T, int HH, int W, int D, int tt, int th, int tw,
                                  int win_t, int win_h, int win_w, void* stream) {
  if (T % tt || HH % th || W % tw || (D != 64 && D != 128) || win_t < 1 || win_h < 1 ||
      win_w < 1 || Lt < 0 || (Lt > 0 && (!text_k || !text_v || !text_bias)))
    return static_cast<int>(cudaErrorInvalidValue);
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
    return launcher(B, H, qq, kk, vv, oo, act, tk, tv, tb, qf, Lt, T, HH, W, tt, th, tw, win_t,
                    win_h, win_w, st);
  };
  // 2 warps (32 q rows) where that tiles the q tile exactly and 4 would not
  const int tpt = tt * th * tw;
  const bool two = tpt % 64 != 0 && tpt % 32 == 0;
  cudaError_t err;
  if (qf != nullptr) {
    if (D == 128)
      err = two ? run(launch<128, 2, true>) : run(launch<128, 4, true>);
    else
      err = two ? run(launch<64, 2, true>) : run(launch<64, 4, true>);
  } else if (D == 128) {
    err = two ? run(launch<128, 2, false>) : run(launch<128, 4, false>);
  } else {
    err = two ? run(launch<64, 2, false>) : run(launch<64, 4, false>);
  }
  return static_cast<int>(err);
}
