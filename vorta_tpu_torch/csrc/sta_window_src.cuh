// The window source of csrc/attn_sm90.cuh's mainloop, shared by the two
// window-dense STA kernels on the Hopper path: sta_pipe.cu's fast-softmax
// kernel and sta_window.cu's stable one.  A CTA's q rows are at most 128
// rows of one q tile, scattered over the raster (B, H, T*HH*W, D) tensors;
// its ring slots are the rows of a host table (ops/sta_pipe.py:window_walk):
// window boxes loaded by TMA from a 4D map (D, W, HH, B*H*T), then the
// joint text tail's keys from a 2D map with their text_bias.
//
// A box holds box_h of the window's runs, each run box_w tokens from the
// window origin's w.  Each box lands on a multiple of 8 slot rows (the
// 1,024 B atom of the 128-byte swizzle that the wgmma descriptors assume),
// so box_w * box_h is a multiple of 8.  A run of run_w tokens that no
// divisor of the window's rows turns into such a box is padded instead
// (sta_window's padded rule): box_w = 8 * RB > run_w > box_w - 8, the box's
// last box_w - run_w columns of every run masked.  In the interior those
// columns are real tokens of the neighbouring tile; past the grid's edge
// TMA fills them with zeros.
#pragma once
#include <algorithm>

#include "attn_sm90.cuh"
#include "sta_common.cuh"

namespace vorta {

// A walk-table row (ops/sta_pipe.py:window_walk): nvalid, the first text key
// (-1 for a window slot), the slot's boxes, 0, then (dt, dh) of each box
// from the window origin, box i landing on row i * box_w * box_h.
constexpr int WALK_COLS = 36;

struct StaParams {
  __nv_bfloat16* out;      // (B, H, T*HH*W, D)
  const __nv_bfloat16* q;  // the same layout (sta_pipe: pre-scaled)
  const int* active;       // (H,)
  const int* walk;         // (n_slots, WALK_COLS)
  const float* text_bias;  // (Lt,), or null with Lt = 0
  int n_slots, H, T, HH, W, tt, th, tw, win_t, win_h, win_w, chunks, box_w, box_h, Lt;
  int run_w;               // the window's run: box_w, or less in a padded box
  float scale_log2;        // sta_window: scale * log2(e) (q not pre-scaled); sta_pipe: unused
};

// The source: the CTA's rows are rows row0().. (at most BM) of q tile
// tile() of head (blockIdx.z, blockIdx.y).  RB < 0: sta_pipe's (the
// mainloop's softmax_tile, slots cut at multiples of 8 keys); RB >= 0:
// sta_window's online softmax of its own (window_scores) over boxes whose
// runs are padded to RB 8-column blocks (RB = 0: not padded).
template <int RB>
struct WindowSource {
  static constexpr bool Q_BY_TMA = false;
  static constexpr bool BY8 = true;  // boxes of 8k tokens; the text cut at Lt % 128, Lt % 8 == 0
  static constexpr bool OWN_SOFTMAX = RB >= 0;
  const CUtensorMap *tk, *tv, *tkt, *tvt;
  const StaParams& p;
  int j = 0;                      // the next walk-table row
  const int* walk = nullptr;      // the table's copy in shared memory (stage_shared)
  int w0 = -1, h0 = 0, plane0 = 0;  // the window origin, set at the producer's first box

  __device__ __forceinline__ int tile() const { return blockIdx.x / p.chunks; }
  __device__ __forceinline__ int row0() const { return (blockIdx.x % p.chunks) * sm90::BM; }
  __device__ __forceinline__ int tpt() const { return p.tt * p.th * p.tw; }
  __device__ __forceinline__ int head() const {
    return static_cast<int>(blockIdx.z) * p.H + static_cast<int>(blockIdx.y);
  }
  __device__ __forceinline__ size_t head_base() const {
    return static_cast<size_t>(head()) * p.T * p.HH * p.W;
  }
  // raster token (from the head's first) of row r of the q tile
  __device__ __forceinline__ int q_token(int r) const {
    const int nh = p.HH / p.th, nw = p.W / p.tw, tl = tile();
    const int it = tl / (nh * nw), ih = (tl / nw) % nh, iw = tl % nw;
    return ((it * p.tt + r / (p.th * p.tw)) * p.HH + ih * p.th + (r / p.tw) % p.th) * p.W +
           iw * p.tw + r % p.tw;
  }

  __device__ __forceinline__ void prepare(uint8_t*, int) {}
  __device__ __forceinline__ bool idle() const { return p.active[blockIdx.y] == 0; }
  __device__ __forceinline__ void write_zeros(int tid) const {
    const int r0 = row0(), rows = min(sm90::BM, tpt() - r0);
    const size_t base = head_base();
    for (int e = tid; e < rows * (sm90::D / 8); e += sm90::THREADS) {
      const int r = r0 + e / (sm90::D / 8), c = (e % (sm90::D / 8)) * 8;
      *reinterpret_cast<uint4*>(p.out + (base + q_token(r)) * sm90::D + c) = make_uint4(0, 0, 0, 0);
    }
  }
  // Before the producer starts: the walk table into shared memory (its
  // reads leave the producer's path), and the V ring zeroed (the rows no
  // box fills meet p = 0, and 0 x NaN would not be 0), then a proxy fence
  // before TMA writes the ring
  __device__ __forceinline__ void stage_shared(uint8_t* smem, int tid) {
    using namespace sm90;
    int4* t = reinterpret_cast<int4*>(smem + SRC_OFF);
    const int4* g = reinterpret_cast<const int4*>(p.walk);
    for (int e = tid; e < p.n_slots * (WALK_COLS / 4); e += THREADS) t[e] = g[e];
    walk = reinterpret_cast<const int*>(t);
    for (int s = 0; s < STAGES; ++s) {
      uint4* v4 = reinterpret_cast<uint4*>(smem + Q_BYTES + s * STAGE_BYTES + KV_BYTES);
      for (int e = tid; e < KV_BYTES / 16; e += THREADS) v4[e] = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
  // Warpgroup wg's 64 Q rows by plain 16-byte loads into the swizzled layout
  // (chunk c of row r at box c / 8, position (c % 8) ^ (r % 8); rows past
  // the tile zero)
  __device__ __forceinline__ void stage_q(uint8_t* smem, int wg, int ltid) const {
    using namespace sm90;
    constexpr int CH = D / 8;  // 16-byte chunks of a row
    const int r0 = row0(), n = tpt();
    const size_t base = head_base();
    for (int e = ltid; e < 64 * CH; e += 128) {
      const int r = wg * 64 + e / CH, c = e % CH;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r0 + r < n)
        x = *reinterpret_cast<const uint4*>(p.q + (base + q_token(r0 + r)) * D + 8 * c);
      *reinterpret_cast<uint4*>(smem + (c / 8) * (BM * ROW_BYTES) + r * ROW_BYTES +
                                16 * ((c % 8) ^ (r % 8))) = x;
    }
  }

  __device__ __forceinline__ bool next(sm90::Slot& s) {
    if (j >= p.n_slots) return false;
    const int* row = walk + j * WALK_COLS;
    s.key0 = j++;
    s.nvalid = row[0];
    s.bias = row[1] >= 0;  // a text slot
    return true;
  }
  // walk row jr's window boxes into a K or V slot at dst
  __device__ __forceinline__ void boxes(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                        int jr) {
    using namespace sm90;
    const int* row = walk + jr * WALK_COLS;
    const int n = row[2];
    const uint32_t box_bytes = static_cast<uint32_t>(p.box_w * p.box_h * ROW_BYTES);
    mbar_expect_tx(bar, 2 * n * box_bytes);
    if (w0 < 0) {  // the window box's first token
      const int nt = p.T / p.tt, nh = p.HH / p.th, nw = p.W / p.tw, tl = tile();
      plane0 = head() * p.T + window_start(tl / (nh * nw), nt, p.win_t, p.tt);
      h0 = window_start((tl / nw) % nh, nh, p.win_h, p.th);
      w0 = window_start(tl % nw, nw, p.win_w, p.tw);
    }
    for (int i = 0; i < n; ++i) {
      const int dt = row[4 + 2 * i], dh = row[5 + 2 * i];
      const uint32_t at = dst + i * box_bytes;
      tma_load_4d(at, map, bar, 0, w0, h0 + dh, plane0 + dt);
      tma_load_4d(at + BN * ROW_BYTES, map, bar, 64, w0, h0 + dh, plane0 + dt);
    }
  }
  // 128 text rows from text key key0 of this head into a K or V slot
  __device__ __forceinline__ void text_rows(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                            int key0) const {
    const int row = head() * p.Lt + key0;
    sm90::tma_load(dst, map, bar, 0, row);
    sm90::tma_load(dst + sm90::BN * sm90::ROW_BYTES, map, bar, 64, row);
  }
  __device__ __forceinline__ void issue_k(const sm90::Slot& s, uint32_t dst, uint32_t bias_dst,
                                          uint32_t bar) {
    if (!s.bias) return boxes(tk, dst, bar, s.key0);
    const int key0 = walk[s.key0 * WALK_COLS + 1];
    sm90::mbar_expect_tx(bar, sm90::KV_BYTES + s.nvalid * 4);
    text_rows(tkt, dst, bar, key0);
    sm90::bulk_load(bias_dst, p.text_bias + key0, s.nvalid * 4, bar);
  }
  __device__ __forceinline__ void issue_v(const sm90::Slot& s, uint32_t dst, uint32_t bar) {
    if (!s.bias) return boxes(tv, dst, bar, s.key0);
    sm90::mbar_expect_tx(bar, sm90::KV_BYTES);
    text_rows(tvt, dst, bar, walk[s.key0 * WALK_COLS + 1]);
  }

  // sta_window's online softmax: window_scores then the online update; a
  // text slot takes its bias and no padding
  template <sm90::Softmax SM>
  __device__ __forceinline__ void softmax(float (&s)[64], const sm90::Slot& slot, int, int t,
                                          float sl, const float* bs, float (&m_run)[2],
                                          float (&l_part)[2], float (&alpha)[2]) const {
    using namespace sm90;
    static_assert(SM == Softmax::Online, "sta_window's softmax is the stable one");
    const bool cut = slot.nvalid < BN;
    if (bs != nullptr) {
      if (cut)
        window_scores<true, true, 0>(s, slot.nvalid, t, sl, bs, 0u);
      else
        window_scores<false, true, 0>(s, slot.nvalid, t, sl, bs, 0u);
    } else {
      // this thread's columns 2t, 2t + 1 of a run's last block: padding past run_w
      const int lim = p.run_w - 8 * (RB - 1);
      const uint32_t pad = (2 * t >= lim ? 1u : 0u) | (2 * t + 1 >= lim ? 2u : 0u);
      if (cut)
        window_scores<true, false, RB>(s, slot.nvalid, t, sl, nullptr, pad);
      else
        window_scores<false, false, RB>(s, slot.nvalid, t, sl, nullptr, pad);
    }
    online_update(s, m_run, l_part, alpha);
  }

  __device__ __forceinline__ float scale_log2() const { return p.scale_log2; }
  __device__ __forceinline__ float qk_factor() const { return 1.f; }
  __device__ __forceinline__ __nv_bfloat16* out_row(int r) const {
    const int tr = row0() + r;
    return tr < tpt() ? p.out + (head_base() + q_token(tr)) * sm90::D : nullptr;
  }
  __device__ __forceinline__ float* lse_row(int) const { return nullptr; }
};

// A raster (B*H*T, HH, W, D = 128) bf16 tensor in boxes of 64 columns x
// box_w tokens x box_h rows x 1 plane, 128-byte swizzle.
inline bool make_window_map(CUtensorMap* map, const void* ptr, uint64_t planes, int HH, int W,
                            int box_w, int box_h) {
  auto fn = sm90::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t row = sm90::D * 2;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(sm90::D), static_cast<cuuint64_t>(W),
                        static_cast<cuuint64_t>(HH), planes};
  cuuint64_t strides[3] = {row, row * W, row * W * HH};
  cuuint32_t box[4] = {64u, static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h), 1u};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The stable window-dense kernel on the Hopper path (sta_window.cu's and
// sta_row.cu's): RB, the 8-column blocks of a padded run (0: runs not
// padded).  Its grid (launch_window) puts the q tiles of one (t, h) row of
// tiles, and the 128-row chunks of each, at adjacent blockIdx.x, so the K /
// V lines those tiles share come from L2 after their first read.
template <int RB>
__global__ void __launch_bounds__(sm90::THREADS, 1)
sta_window_sm90_kernel(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tkt,
                       const __grid_constant__ CUtensorMap tvt,
                       const __grid_constant__ StaParams p) {
  WindowSource<RB> src{&tk, &tv, &tkt, &tvt, p};
  sm90::attn_mainloop<sm90::Softmax::Online, false>(src);
}

// A window kernel's dynamic shared memory: the mainloop's, and the walk
// table past its barriers (with the base's alignment slack), and `extra`
// bytes of a source's own past the table (sta_diag's stash).
inline int sta_smem_bytes(int n_slots, int extra = 0) {
  return sm90::SRC_OFF + n_slots * WALK_COLS * 4 + extra + 1024;
}

// The four maps of a window kernel (the text maps over k / v when Lt = 0:
// never read, any valid map will do) and its launch.
template <class Kernel>
cudaError_t launch_window(Kernel kern, int B, const StaParams& p, const void* k, const void* v,
                          const void* text_k, const void* text_v, cudaStream_t st,
                          int extra_smem = 0) {
  CUtensorMap tk, tv, tkt, tvt;
  const uint64_t planes = static_cast<uint64_t>(B) * p.H * p.T;
  const bool text = p.Lt > 0;
  const uint64_t text_rows = text ? static_cast<uint64_t>(B) * p.H * p.Lt : planes * p.HH * p.W;
  if (!make_window_map(&tk, k, planes, p.HH, p.W, p.box_w, p.box_h) ||
      !make_window_map(&tv, v, planes, p.HH, p.W, p.box_w, p.box_h) ||
      !sm90::make_map(&tkt, text ? text_k : k, text_rows, sm90::BN) ||
      !sm90::make_map(&tvt, text ? text_v : v, text_rows, sm90::BN))
    return cudaErrorInvalidValue;
  const int smem = sta_smem_bytes(p.n_slots, extra_smem);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T / p.tt) * (p.HH / p.th) * (p.W / p.tw) * p.chunks, p.H, B);
  kern<<<grid, sm90::THREADS, smem, st>>>(tk, tv, tkt, tvt, p);
  return cudaGetLastError();
}

// The checks and launch of sta_window_sm90_kernel for the C entries of
// sta_window.cu (PADDED_OK: runs of 25 to 31 tokens read as boxes of 32,
// RB = 4) and sta_row.cu (its runs are multiples of 8: never padded), once
// the wrapper's rule chose the Hopper path: walk (n_slots, WALK_COLS) int32
// on the device, boxes of box_w tokens x box_h rows, box_w the window's run
// (run_w) or its padding; box_h dividing the window's rows, box_w * box_h a
// multiple of 8 up to 128; k, v, text_k, text_v and text_bias 16-byte
// aligned.  Anything else is an error, never a fallback.
template <bool PADDED_OK>
int launch_window_online(const void* q, const void* k, const void* v, void* out,
                         const void* active, const void* text_k, const void* text_v,
                         const void* text_bias, float sl, int Lt, int B, int H, int T, int HH,
                         int W, int D, int tt, int th, int tw, int win_t, int win_h, int win_w,
                         const void* walk, int n_slots, int box_w, int box_h, int run_w,
                         cudaStream_t st) {
  const int bh = std::min(win_h, HH / th) * th, bw = std::min(win_w, W / tw) * tw;
  const bool padded = box_w != bw;
  if (D != sm90::D || !walk || n_slots < 1 || sta_smem_bytes(n_slots) > 232448 ||
      run_w != bw || box_h < 1 || bh % box_h || (box_w * box_h) % 8 ||
      box_w * box_h > sm90::BN || Lt % 8 ||
      (padded && (!PADDED_OK || box_w != 32 || bw >= box_w || bw <= box_w - 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tpt = tt * th * tw;
  const StaParams p{static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(q),
                    static_cast<const int*>(active), static_cast<const int*>(walk),
                    static_cast<const float*>(text_bias), n_slots, H, T, HH, W, tt, th, tw,
                    win_t, win_h, win_w, (tpt + sm90::BM - 1) / sm90::BM, box_w, box_h, Lt,
                    run_w, sl};
  if constexpr (PADDED_OK) {
    if (padded)
      return static_cast<int>(
          launch_window(sta_window_sm90_kernel<4>, B, p, k, v, text_k, text_v, st));
  }
  return static_cast<int>(
      launch_window(sta_window_sm90_kernel<0>, B, p, k, v, text_k, text_v, st));
}

}  // namespace vorta
