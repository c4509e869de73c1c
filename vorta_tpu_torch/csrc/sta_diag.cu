// Bisection variants of the window-dense sliding-tile attention kernel, for
// Hopper (sm_90a): the CUDA kernel of vorta_tpu_torch/tools/sta_diag.py.
//
// Replaces tools/sta_diag.py:_kernel (reached through tools/sta_diag.py:run).
// Same function: each (tt, th, tw) q tile of a raster (B, H, T*HH*W, D)
// tensor attends to the box of win_eff tiles per axis that starts at its
// clamped window start (geometry.window_starts); q is not pre-scaled, the
// scores are q.k * scale * log2(e) in f32.  The box is walked in CHUNKS, as
// the TPU kernel walks it: chunk j = dt * win_h + dh is the tt x th x bw keys
// (bw = win_w * tw) of one (dt, dh) tile row of the box.  The TPU kernel
// keeps a whole chunk in VMEM; at the tool's default geometry a chunk is
// 5 x 9 x 24 = 1,080 keys, 276 KB of K alone, more than the 227 KB of shared
// memory a block can have.  So on this card a chunk is walked in 64-key
// SUB-TILES of K and V, and the ring holds sub-tiles: N_SLOTS = 4 slots of
// 64 keys of K and V each (34 KB a slot with the padded rows), filled by
// cp.async ahead of the compute.  The TPU kernel's two softmax chains stay:
// even chunks feed chain 0, odd chunks chain 1, each with its own running
// max, and the output is (acc_0 + acc_1) / (l_0 + l_1) (l == 0 -> 1), the
// chains summed without a common max, exactly as sta_diag.py:158-161 sums
// them.  VARIANT selects what runs, as the TPU kernel's `variant`:
//   FULL         the stable online softmax, the pair loop over chunks;
//   FULL_UNROLL  the same with the chunk loop unrolled at compile time (up to
//                MAX_CHUNKS chunks), every chain index static;
//   DOTS_ONLY    both products, p = bf16(s * 1e-3) with no max and no l;
//   DMA_ONLY     the copies and their waits only: the output is 0;
//   NO_DMA       the copies issued and their waits skipped: the compute of
//                FULL on whatever the slots hold, an undefined output (timed
//                only, as in the TPU tool).
//
// Bound on this card: 4 * 9,720 * 128 FLOP per query at the default geometry
// (Wan 720p, 72,000 tokens, 12 heads): 4.30e12 FLOP, 4.35 ms at 989 TFLOP/s
// bf16; the copies move each q tile's 9,720-key box of K and V, 11.9 GB read
// through L2 from 0.66 GB of operands in device memory.  Two designs, chosen
// per call by the wrapper's rule (tools/sta_diag.py:diag_wgmma_path,
// mirrored by the C entry):
//
// - The Hopper path (D = 128, a chunk box, a table that fits beside the
//   stash): the served window kernels' mainloop, csrc/attn_sm90.cuh over
//   csrc/sta_window_src.cuh's WindowSource (the window's runs as TMA boxes
//   into a two-slot ring of 128-key K and V slots, wgmma for both products,
//   a producer warp and two consumer warpgroups of 64 q rows, 128-row
//   CTAs), so that each variant bisects the kernels users run:
//   dma_only times their producer and ring, dots_only their products.  The
//   walk (tools/sta_diag.py:diag_walk) is chunk-aligned: each slot holds
//   runs of one chunk only, chain-major (chain 0's chunks, then chain
//   1's), each slot's chain in the table's fourth column.  The two chains
//   are consecutive online softmaxes in one set of registers (the
//   mainloop's Loop::Chains): where chain 1 starts, chain 0's finished O
//   goes to shared memory as bf16 (STASH_BYTES past the walk table: one
//   rounding, 2^-9 of the stashed value) and its sums stay in registers,
//   chain 1 restarts from no max, and at the end the two are summed without
//   a common max, as the TPU kernel sums them.  Holding chain 0's O in
//   registers instead would need 64 more a consumer thread, past the 232
//   that setmaxnreg gives them.  The variants: FULL (Loop::Chains, the
//   served online softmax), FULL_UNROLL (Loop::ChainsUnrolled: the slot
//   loop unrolled by the ring's two stages, every stage index and barrier
//   address compile-time; at most MAX_CHUNKS chunks, as the TPU tool),
//   DOTS_ONLY (the fast mainloop, p = s * scale_log2 * 1e-3, no max, no
//   sum), DMA_ONLY (Loop::DmaOnly) and NO_DMA (Loop::NoDma: the compute of
//   FULL without a wait for any copy; the producer drains every copy before
//   the CTA ends).
// - The mma.sync path (any shape; D = 64; sta_diag_attention_mma_sync, the
//   yardstick beside the Hopper path), the first design, below: one CUDA
//   block of 8 warps per (128-row chunk of a q tile, head, batch), the Q
//   fragments in registers, products on mma.sync m16n8k16 (mma_bf16.cuh),
//   64-key sub-tiles of each chunk through a 4-slot cp.async ring 3
//   sub-tiles ahead.
#include "sta_common.cuh"
#include "sta_window_src.cuh"

namespace {

using namespace vorta;

constexpr int BLOCK_N = 64;  // keys per sub-tile
constexpr int WARPS = 8;  // 128 q rows: a 360-row tile reads its box 3 times, not 6
constexpr int BLOCK_M = 16 * WARPS;
constexpr int N_SLOTS = 4;
constexpr int MAX_CHUNKS = 9;  // FULL_UNROLL's compile-time chunk bound (3 x 3 windows)

enum Variant { FULL = 0, FULL_UNROLL = 1, DOTS_ONLY = 2, DMA_ONLY = 3, NO_DMA = 4 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D, int VARIANT>
__global__ void __launch_bounds__(WARPS * 32)
sta_diag_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, float sl,
                int H, int T, int HH, int W, int tt, int th, int tw, int win_t, int win_h,
                int win_w, int chunks) {
  constexpr int LDS = D + 8;  // padded rows: conflict-free ldmatrix
  constexpr int NT_S = BLOCK_N / 8;
  constexpr int NT_O = D / 8;
  constexpr int CHUNKS = D / 8;  // 16-byte pieces of a row
  constexpr int SLOT = 2 * BLOCK_N * LDS;  // K then V
  extern __shared__ __align__(16) __nv_bfloat16 ring[];

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
  auto q_token = [&](int r) {
    return ((it * tt + r / (th * tw)) * HH + ih * th + (r / tw) % th) * W + iw * tw + r % tw;
  };

  const int t0 = window_start(it, nt, win_t, tt);
  const int h0 = window_start(ih, nh, win_h, th);
  const int w0 = window_start(iw, nw, win_w, tw);
  const int wh = min(win_h, nh), bw = min(win_w, nw) * tw;
  const int ck = tt * th * bw;  // keys of a chunk
  const int spc = (ck + BLOCK_N - 1) / BLOCK_N;  // sub-tiles of a chunk
  const int n_chunks = min(win_t, nt) * wh;
  const int nsub = n_chunks * spc;

  // copy sub-tile i (chunk i / spc) into its slot; rows past the chunk are zeros
  auto issue = [&](int i) {
    if (i < nsub) {
      const int j = i / spc, n0 = (i % spc) * BLOCK_N;
      const int dt = j / wh, dh = j % wh;
      __nv_bfloat16* ks = ring + (i % N_SLOTS) * SLOT;
      __nv_bfloat16* vs = ks + BLOCK_N * LDS;
      for (int e = tid; e < BLOCK_N * CHUNKS; e += WARPS * 32) {
        const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
        const int n = n0 + r;
        const bool ok = n < ck;
        const size_t row = ok ? base + static_cast<size_t>(
            ((t0 + dt * tt + n / (th * bw)) * HH + h0 + dh * th + (n / bw) % th) * W + w0 +
            n % bw) : base;
        cp_async16(ks + r * LDS + c, k + row * D + c, ok);
        cp_async16(vs + r * LDS + c, v + row * D + c, ok);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  };

  const int rg = row0 + warp * 16 + g, rg8 = rg + 8;
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, rg < tpt ? q + (base + q_token(rg)) * D : nullptr,
                  rg8 < tpt ? q + (base + q_token(rg8)) * D : nullptr, t);
  float acc0[NT_O][4], acc1[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[n][e] = acc1[n][e] = 0.f;
  float m0[2] = {NEG_INF, NEG_INF}, m1[2] = {NEG_INF, NEG_INF};
  float l0[2] = {0.f, 0.f}, l1[2] = {0.f, 0.f};

#pragma unroll
  for (int i = 0; i < N_SLOTS - 1; ++i) issue(i);

  // sub-tile i: wait for it, free the slot of i - 1 for i + N_SLOTS - 1, return
  // its K / V and valid key count
  auto arrive = [&](int i, int& nvalid) {
    if constexpr (VARIANT != NO_DMA) cp_async_wait<N_SLOTS - 2>();
    __syncthreads();
    issue(i + N_SLOTS - 1);
    nvalid = min(BLOCK_N, ck - (i % spc) * BLOCK_N);
    return ring + (i % N_SLOTS) * SLOT;
  };
  auto nblocks = [](int nvalid) { return (1u << ((nvalid + 7) / 8)) - 1u; };
  // one chunk into chain (m, l, acc)
  auto softmax_chunk = [&](int j, float* m, float* l, float (*acc)[4]) {
    for (int sub = 0; sub < spc; ++sub) {
      int nvalid;
      const __nv_bfloat16* ks = arrive(j * spc + sub, nvalid);
      online_softmax_step<D, LDS>(qa, ks, ks + BLOCK_N * LDS, nullptr, nvalid, nblocks(nvalid),
                                  sl, m, l, acc, lane);
    }
  };

  if constexpr (VARIANT == FULL || VARIANT == NO_DMA) {
    for (int j = 0; j + 1 < n_chunks; j += 2) {  // the pair loop: chains 0 and 1
      softmax_chunk(j, m0, l0, acc0);
      softmax_chunk(j + 1, m1, l1, acc1);
    }
    if (n_chunks % 2) softmax_chunk(n_chunks - 1, m0, l0, acc0);
  } else if constexpr (VARIANT == FULL_UNROLL) {
#pragma unroll
    for (int j = 0; j < MAX_CHUNKS; ++j) {
      if (j < n_chunks) {
        if (j % 2 == 0)
          softmax_chunk(j, m0, l0, acc0);
        else
          softmax_chunk(j, m1, l1, acc1);
      }
    }
  } else {
    for (int i = 0; i < nsub; ++i) {
      int nvalid;
      const __nv_bfloat16* ks = arrive(i, nvalid);
      if constexpr (VARIANT == DOTS_ONLY) {
        float s[NT_S][4];
        qk_tile<D, NT_S, LDS>(s, qa, ks, lane);
#pragma unroll
        for (int n = 0; n < NT_S; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = (n * 8 + 2 * t + (e & 1) < nvalid) ? (s[n][e] * sl) * 1e-3f : 0.f;
        pv_tile<D, NT_S, LDS>(acc0, s, ks + BLOCK_N * LDS, lane);
      }
    }
  }
  cp_async_wait<0>();

  float lr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float x = quad_sum(l0[r]) + quad_sum(l1[r]);
    lr[r] = x == 0.f ? 1.f : x;
  }
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * t;
    if (rg < tpt)
      *reinterpret_cast<uint32_t*>(out + (base + q_token(rg)) * D + c) =
          pack_bf16((acc0[n][0] + acc1[n][0]) / lr[0], (acc0[n][1] + acc1[n][1]) / lr[0]);
    if (rg8 < tpt)
      *reinterpret_cast<uint32_t*>(out + (base + q_token(rg8)) * D + c) =
          pack_bf16((acc0[n][2] + acc1[n][2]) / lr[1], (acc0[n][3] + acc1[n][3]) / lr[1]);
  }
}

template <int D, int VARIANT>
cudaError_t launch(int B, int H, const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, float sl, int T, int HH, int W,
                   int tt, int th, int tw, int win_t, int win_h, int win_w, cudaStream_t st) {
  const size_t smem = N_SLOTS * 2 * BLOCK_N * (D + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(sta_diag_kernel<D, VARIANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int chunks = (tt * th * tw + BLOCK_M - 1) / BLOCK_M;
  const dim3 grid((T / tt) * (HH / th) * (W / tw) * chunks, H, B);
  sta_diag_kernel<D, VARIANT><<<grid, WARPS * 32, smem, st>>>(q, k, v, out, sl, H, T, HH, W, tt,
                                                               th, tw, win_t, win_h, win_w,
                                                               chunks);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_variant(int variant, int B, int H, const __nv_bfloat16* q,
                           const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* out,
                           float sl, int T, int HH, int W, int tt, int th, int tw, int win_t,
                           int win_h, int win_w, cudaStream_t st) {
  auto run = [&](auto launcher) {
    return launcher(B, H, q, k, v, out, sl, T, HH, W, tt, th, tw, win_t, win_h, win_w, st);
  };
  switch (variant) {
    case FULL: return run(launch<D, FULL>);
    case FULL_UNROLL: return run(launch<D, FULL_UNROLL>);
    case DOTS_ONLY: return run(launch<D, DOTS_ONLY>);
    case DMA_ONLY: return run(launch<D, DMA_ONLY>);
    default: return run(launch<D, NO_DMA>);
  }
}

// ---- the Hopper path ----------------------------------------------------------

// both consumer warpgroups' chain-0 O as bf16 pairs: 256 threads x 32 words
constexpr int STASH_BYTES = sm90::CONSUMERS * 128 * 32 * 4;

// The source: sta_window's (no active mask, no text: every head attends),
// over the chunk-aligned walk; a slot's chain (Slot::info) from the
// table's fourth column; the variant's loop and softmax.
template <int VARIANT>
struct DiagSource : WindowSource<0> {
  static constexpr sm90::Loop LOOP =
      VARIANT == FULL ? sm90::Loop::Chains
      : VARIANT == FULL_UNROLL ? sm90::Loop::ChainsUnrolled
      : VARIANT == DMA_ONLY ? sm90::Loop::DmaOnly
      : VARIANT == NO_DMA ? sm90::Loop::NoDma
                          : sm90::Loop::Served;  // DOTS_ONLY: one sum, no chains

  __device__ __forceinline__ bool idle() const { return false; }
  __device__ __forceinline__ bool next(sm90::Slot& s) {
    if (!WindowSource<0>::next(s)) return false;
    s.info = static_cast<uint32_t>(walk[s.key0 * WALK_COLS + 3]);
    return true;
  }
  // chain 0's O, past the walk table in shared memory (16-byte aligned:
  // WALK_COLS * 4 = 144 bytes a row)
  __device__ __forceinline__ uint32_t* stash(uint8_t* smem) const {
    return reinterpret_cast<uint32_t*>(smem + sm90::SRC_OFF + p.n_slots * WALK_COLS * 4);
  }
  // the online step on the window's scores (Online: FULL, FULL_UNROLL,
  // NO_DMA), or DOTS_ONLY's p = s * sl * 1e-3 with no max and no sum; the
  // columns past nvalid masked (the slots are cut at multiples of 8 keys)
  template <sm90::Softmax SM>
  __device__ __forceinline__ void softmax(float (&s)[64], const sm90::Slot& slot, int, int t,
                                          float sl, const float*, float (&m_run)[2],
                                          float (&l_part)[2], float (&alpha)[2]) const {
    using namespace sm90;
    const bool cut = slot.nvalid < BN;
    if constexpr (SM == Softmax::Online) {
      if (cut)
        window_scores<true, false, 0>(s, slot.nvalid, t, sl, nullptr, 0u);
      else
        window_scores<false, false, 0>(s, slot.nvalid, t, sl, nullptr, 0u);
      online_update(s, m_run, l_part, alpha);
    } else {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const bool off = cut && 8 * n >= slot.nvalid;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * n + e] = off ? 0.f : (s[4 * n + e] * sl) * 1e-3f;
      }
    }
  }
};

template <int VARIANT>
__global__ void __launch_bounds__(sm90::THREADS, 1)
sta_diag_sm90_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tkt,
                     const __grid_constant__ CUtensorMap tvt,
                     const __grid_constant__ StaParams p) {
  DiagSource<VARIANT> src{{&tk, &tv, &tkt, &tvt, p}};
  constexpr bool FAST = VARIANT == DOTS_ONLY || VARIANT == DMA_ONLY;
  sm90::attn_mainloop<FAST ? sm90::Softmax::Fast : sm90::Softmax::Online, false>(src);
}

// The Hopper path's checks (tools/sta_diag.py:diag_wgmma_path: D = 128, a
// box of box_h of a chunk's runs of box_w = bw tokens, box_h dividing the
// tile's th, box_w * box_h a multiple of 8 up to 128, the table and stash
// in shared memory) and its launch; anything else is an error, never a
// fallback.
int launch_hopper(int variant, const void* q, const void* k, const void* v, void* out, float sl,
                  int B, int H, int T, int HH, int W, int D, int tt, int th, int tw, int win_t,
                  int win_h, int win_w, const void* walk, int n_slots, int box_w, int box_h,
                  cudaStream_t st) {
  const int bw = min(win_w, W / tw) * tw;
  if (D != sm90::D || !walk || n_slots < 1 || sta_smem_bytes(n_slots, STASH_BYTES) > 232448 ||
      box_w != bw || box_h < 1 || th % box_h || (box_w * box_h) % 8 ||
      box_w * box_h > sm90::BN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tpt = tt * th * tw;
  const StaParams p{static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(q),
                    nullptr, static_cast<const int*>(walk), nullptr, n_slots, H, T, HH, W, tt,
                    th, tw, win_t, win_h, win_w, (tpt + sm90::BM - 1) / sm90::BM, box_w, box_h,
                    0, bw, sl};
  auto run = [&](auto kern) {
    return static_cast<int>(launch_window(kern, B, p, k, v, k, v, st, STASH_BYTES));
  };
  switch (variant) {
    case FULL: return run(sta_diag_sm90_kernel<FULL>);
    case FULL_UNROLL: return run(sta_diag_sm90_kernel<FULL_UNROLL>);
    case DOTS_ONLY: return run(sta_diag_sm90_kernel<DOTS_ONLY>);
    case DMA_ONLY: return run(sta_diag_sm90_kernel<DMA_ONLY>);
    default: return run(sta_diag_sm90_kernel<NO_DMA>);
  }
}

}  // namespace

// The Hopper path's dynamic shared memory for a walk of n_slots rows.
extern "C" int vorta_sta_diag_sm90_smem_bytes(int n_slots) {
  return sta_smem_bytes(n_slots, STASH_BYTES);
}

// q, k, v, out: contiguous raster (B, H, T*HH*W, D) bf16, q not pre-scaled;
// sl = scale * log2(e); variant: 0 full, 1 full_unroll, 2 dots_only,
// 3 dma_only, 4 no_dma.  hopper: the wrapper's rule picked the Hopper path,
// over walk (n_slots, WALK_COLS) int32 on the device in boxes of box_w x
// box_h (16-byte aligned k and v); else the mma.sync kernel.  Returns the
// CUDA error code.
extern "C" int vorta_sta_diag_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                       float sl, int variant, int B, int H, int T, int HH, int W,
                                       int D, int tt, int th, int tw, int win_t, int win_h,
                                       int win_w, const void* walk, int n_slots, int box_w,
                                       int box_h, int hopper, void* stream) {
  if (T % tt || HH % th || W % tw || (D != 64 && D != 128) || win_t < 1 || win_h < 1 ||
      win_w < 1 || variant < 0 || variant > 4 ||
      (variant == FULL_UNROLL && min(win_t, T / tt) * min(win_h, HH / th) > MAX_CHUNKS))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hopper)
    return launch_hopper(variant, q, k, v, out, sl, B, H, T, HH, W, D, tt, th, tw, win_t, win_h,
                         win_w, walk, n_slots, box_w, box_h, static_cast<cudaStream_t>(stream));
  using bf = __nv_bfloat16;
  auto* qq = static_cast<const bf*>(q);
  auto* kk = static_cast<const bf*>(k);
  auto* vv = static_cast<const bf*>(v);
  auto* oo = static_cast<bf*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      D == 128 ? launch_variant<128>(variant, B, H, qq, kk, vv, oo, sl, T, HH, W, tt, th, tw,
                                     win_t, win_h, win_w, st)
               : launch_variant<64>(variant, B, H, qq, kk, vv, oo, sl, T, HH, W, tt, th, tw,
                                    win_t, win_h, win_w, st);
  return static_cast<int>(err);
}
