// Coreset pooling of the low-resolution attention expert, for Hopper
// (sm_90a): pool (q, k, v) -> pooled sequences + picks, and unpool.
//
// Replaces vorta_tpu/ops/coreset_pallas.py:_pool_kernel (reached through
// pool_qkv) and :_unpool_kernel (reached through unpool), in their
// "active" and "head-map" modes with picks, and the copy probe of
// tools/bench_pool.py (main.copy_probe).  Same function: per non-overlapping
// (wt, wh, ww) window ("group") of the raster grid, rank the margin slots
// by (c.m) * rsqrt(max(|m|^2, 1e-24)) in f32 from Q (c the center slot),
// the center excluded by a +inf sentinel, then U arg-min passes with ties to
// the lower slot; K and V share Q's picks, or (kv_from_k, HunyuanVideo's
// joint experts: coreset_pallas.py kv_matching_from_k) are pooled by K's own
// matching under the same rule, while the picks written stay Q's (unpool
// scatters the queries' outputs).  Pooled layout:
// [G centers | G*U kept margins, group-major, least similar first]; picks:
// (B, H, G, U) int32 slot ids, the TPU's (B, H, T2, H3, W2, U).  Unpool
// writes each slot its kept value if picked, else its group center.
// Inactive heads write zeros.  Head-map mode (head_map + num_active, the
// TPU kernels' "headmap"): the grid's head dimension covers num_active
// positions, position i pooling / unpooling head head_map[i]; the rows of
// every other head are not written (the caller allocates with torch.empty
// and masks downstream), so data movement and matching scale with the routed
// heads.  Values are moved, never computed: pooled and unpooled rows equal
// their sources bit for bit.  Pool and unpool take bf16 (the model in
// bf16) or f32 (the f32 serving path: the tiny models, `--dtype fp32`),
// each kernel instantiated on the element type: the similarity sums are f32
// either way and the rows are moved as bytes, so an f32 pool or unpool is
// its plain version bit for bit wherever the picks agree.
//
// unpool's two kernels.  unpool_rows_kernel (the path ops/coreset_pallas.py:
// unpool_layout gives every shape this file takes: D 64 or 128, groups of
// 1 to 32 slots; both modes) is a batched 16-byte copy: a (head, token) row
// is D / 8 lanes of 16 bytes, so a warp instruction moves RPI = 256 / D rows
// (2 at D = 128, 4 at D = 64).  Per group a warp first reads every row the
// group needs, then writes: the centre row once (the warp's RPI row parts
// read the same bytes: one transaction), the U kept rows RPI an
// instruction, before any store.  The picks are resolved once per group, off
// the loads' path: lane s < group size finds which kept row, if any, names
// its slot in one pass over the U picks (shuffles of the lane-held picks),
// and the group's gs stores are listed as entries, the U kept rows first,
// then the unpicked slots (the centre's value) in slot order; a warp's
// 32-int table in shared memory turns an entry into its slot.  Each warp
// walks groups gridDim.x * WARPS apart: it issues the next group's loads
// and pick, stores the current group, then resolves the next group's pick,
// which has landed meanwhile (resolved before the stores, it would leave a
// load latency a group exposed).  unpool_kernel, the first design (a warp
// per group, each slot a U-shuffle search then one dependent 8-byte-a-lane
// load and store: one 256-byte row in flight per warp), stays as the
// yardstick that ops/coreset_pallas.py:unpool_per_group runs.
//
// The copy probe (tools/bench_pool.py's copy_probe, the pool's data-movement
// floor): the same cells (one warp per group) with no matching: it writes
// slot 0 of each group as the "center" and slots 0..U-1 as the "margins", for
// q, k and v, into the pooled layout.  It reads (1 + U) rows and writes
// (1 + U) rows per group and tensor, against the pool's full Q read.
//
// Bound on this card: bytes.  At Wan-1.3B 480p x 77f (31,200 tokens,
// d = 128, window (2, 3, 2): 2,600 groups of 12, U = 5) pool reads all of
// Q (8 MB) and only the 15,600 center and kept rows of K and V (2 x 4 MB),
// and writes 3 x 4 MB per head: 28 MB, 8.4 us at 3.35 TB/s (with K's own
// matching it reads all of K too: 32 MB); unpool reads
// 4 MB and writes 8 MB per head (3.6 us).  The pool's design (and the copy
// probe's): one warp per group, each lane holding d / 32 elements of a row, so a row is one coalesced 256-byte
// access; the similarity sums reduce by warp shuffles, lane s keeps slot
// s's similarity (a group has at most 32 slots) and the arg-min passes are
// warp reductions.  No shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;  // groups per block

// d / 32 elements of type T per lane as one load (4, 8 or 16 bytes)
template <int D, typename T>
using LaneVec = typename std::conditional<
    D * sizeof(T) == 512, uint4,
    typename std::conditional<D * sizeof(T) == 256, uint2, uint32_t>::type>::type;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

struct Group {
  int g2t, g2h, g2w;
  __device__ Group(int g, int HH, int W, int wh, int ww)
      : g2t(g / ((HH / wh) * (W / ww))), g2h((g / (W / ww)) % (HH / wh)), g2w(g % (W / ww)) {}
  // raster token of slot s (raster order inside the window)
  __device__ int token(int s, int wt, int wh, int ww, int HH, int W) const {
    return ((g2t * wt + s / (wh * ww)) * HH + g2h * wh + (s / ww) % wh) * W + g2w * ww + s % ww;
  }
};

template <int D, typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int lane) {
  static_assert(sizeof(LaneVec<D, T>) == D / 32 * sizeof(T), "lane vector width");
  reinterpret_cast<LaneVec<D, T>*>(dst)[lane] = reinterpret_cast<const LaneVec<D, T>*>(src)[lane];
}

template <int D, typename T>
__device__ __forceinline__ void zero_row(T* dst, int lane) {
  reinterpret_cast<LaneVec<D, T>*>(dst)[lane] = LaneVec<D, T>{};
}

template <int D, typename T>
__device__ __forceinline__ void load_f32(float* x, const T* src, int lane) {
  constexpr int EPL = D / 32;
#pragma unroll
  for (int e = 0; e < EPL; ++e) x[e] = to_f32(src[lane * EPL + e]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int D, typename Elem>
__global__ void __launch_bounds__(WARPS * 32)
pool_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k, const Elem* __restrict__ v,
            Elem* __restrict__ pq, Elem* __restrict__ pk, Elem* __restrict__ pv,
            int* __restrict__ picks, const int* __restrict__ active,
            const int* __restrict__ head_map, int kv_from_k, int H, int T, int HH, int W, int wt,
            int wh, int ww, int U) {
  constexpr int EPL = D / 32;
  const int lane = threadIdx.x % 32;
  const int gs = wt * wh * ww, G = (T / wt) * (HH / wh) * (W / ww);
  const int g = blockIdx.x * WARPS + threadIdx.x / 32;
  if (g >= G) return;
  const int h = head_map != nullptr ? head_map[blockIdx.y] : blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t in0 = bh * T * HH * W, out0 = bh * G * (1 + U);
  const int cs = (wt / 2) * wh * ww + (wh / 2) * ww + ww / 2;
  const Group grp(g, HH, W, wh, ww);
  auto src = [&](const Elem* x, int s) {
    return x + (in0 + grp.token(s, wt, wh, ww, HH, W)) * D;
  };
  auto dst_row = [&](int i) { return (out0 + (i < 0 ? g : G + g * U + i)) * D; };

  if (active != nullptr && active[h] == 0) {
    for (int i = -1; i < U; ++i) {
      zero_row<D, Elem>(pq + dst_row(i), lane);
      zero_row<D, Elem>(pk + dst_row(i), lane);
      zero_row<D, Elem>(pv + dst_row(i), lane);
    }
    if (lane < U) picks[(bh * G + g) * U + lane] = 0;
    return;
  }

  // similarity of every slot to the center, in f32; lane s holds slot s's,
  // the center and lanes >= gs stay +inf
  auto similarity = [&](const Elem* x) {
    float c[EPL], y[EPL];
    load_f32<D, Elem>(c, src(x, cs), lane);
    float my_sim = CUDART_INF_F;
    for (int s = 0; s < gs; ++s) {
      load_f32<D, Elem>(y, src(x, s), lane);
      float dot = 0.f, sq = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        dot += y[e] * c[e];
        sq += y[e] * y[e];
      }
      dot = warp_sum(dot);
      sq = warp_sum(sq);
      if (lane == s && s != cs) my_sim = dot * rsqrtf(fmaxf(sq, 1e-24f));
    }
    return my_sim;
  };
  // the next arg-min pass: the least similar slot left, ties to the lower
  auto next_pick = [&](float& my_sim) {
    const float m = warp_min(my_sim);
    const int pick = warp_min(my_sim <= m ? lane : 32);
    if (lane == pick) my_sim = CUDART_INF_F;
    return pick;
  };
  float sim_q = similarity(q);
  float sim_k = kv_from_k ? similarity(k) : 0.f;

  copy_row<D, Elem>(pq + dst_row(-1), src(q, cs), lane);
  copy_row<D, Elem>(pk + dst_row(-1), src(k, cs), lane);
  copy_row<D, Elem>(pv + dst_row(-1), src(v, cs), lane);
  for (int i = 0; i < U; ++i) {
    const int pick = next_pick(sim_q);
    const int kv_pick = kv_from_k ? next_pick(sim_k) : pick;
    if (lane == 0) picks[(bh * G + g) * U + i] = pick;
    copy_row<D, Elem>(pq + dst_row(i), src(q, pick), lane);
    copy_row<D, Elem>(pk + dst_row(i), src(k, kv_pick), lane);
    copy_row<D, Elem>(pv + dst_row(i), src(v, kv_pick), lane);
  }
}

template <int D, typename Elem>
__global__ void __launch_bounds__(WARPS * 32)
unpool_kernel(const Elem* __restrict__ pooled, const int* __restrict__ picks,
              const int* __restrict__ active, const int* __restrict__ head_map,
              Elem* __restrict__ out, int H, int T, int HH, int W, int wt, int wh,
              int ww, int U) {
  const int lane = threadIdx.x % 32;
  const int gs = wt * wh * ww, G = (T / wt) * (HH / wh) * (W / ww);
  const int g = blockIdx.x * WARPS + threadIdx.x / 32;
  if (g >= G) return;
  const int h = head_map != nullptr ? head_map[blockIdx.y] : blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t out0 = bh * T * HH * W, in0 = bh * G * (1 + U);
  const Group grp(g, HH, W, wh, ww);
  const bool on = active == nullptr || active[h] != 0;
  const int my_pick = (on && lane < U) ? picks[(bh * G + g) * U + lane] : -1;
  for (int s = 0; s < gs; ++s) {
    Elem* dst = out + (out0 + grp.token(s, wt, wh, ww, HH, W)) * D;
    if (!on) {
      zero_row<D, Elem>(dst, lane);
      continue;
    }
    size_t row = g;  // dropped slots and the center take the center
    for (int i = 0; i < U; ++i)
      if (__shfl_sync(0xffffffffu, my_pick, i) == s) row = G + static_cast<size_t>(g) * U + i;
    copy_row<D, Elem>(dst, pooled + (in0 + row) * D, lane);
  }
}

// NL: store instructions a lane has per group (ceil(gs / RPI), rounded up to
// 4, 8 or 16); KL: kept-row loads a lane has per group (ceil(U / RPI), as
// NL / 2 where it fits, else NL): ops/coreset_pallas.py:unpool_layout.  E:
// the element type (RPI = 256 / D rows an instruction in bf16, 128 / D in
// f32).
template <int D, int NL, int KL, typename E>
__global__ void __launch_bounds__(WARPS * 32, NL <= 8 ? 2 : 1)
unpool_rows_kernel(const E* __restrict__ pooled, const int* __restrict__ picks,
                   const int* __restrict__ active, const int* __restrict__ head_map,
                   E* __restrict__ out, int H, int T, int HH, int W, int wt, int wh,
                   int ww, int U) {
  constexpr int LPR = D * static_cast<int>(sizeof(E)) / 16;  // lanes of a row, 16 bytes each
  constexpr int RPI = 32 / LPR;  // rows a warp instruction moves
  static_assert(KL <= NL, "a kept row is one of the group's stores");
  __shared__ int entry_slot[WARPS][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane / LPR, piece = lane % LPR;
  const int gs = wt * wh * ww, G = (T / wt) * (HH / wh) * (W / ww);
  const int h = head_map != nullptr ? head_map[blockIdx.y] : blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t out0 = bh * T * HH * W, in0 = bh * G * (1 + U);
  const bool on = active == nullptr || active[h] != 0;
  const int u = on ? U : 0;  // kept rows read: none for an inactive head (zeros)
  int* es = entry_slot[warp];
  const uint4* src = reinterpret_cast<const uint4*>(pooled) + piece;  // rows of D / 8 pieces

  // group g's loads, issued and not waited for: the centre row, the kept
  // rows (entry r * RPI + sub < u), this lane's pick
  auto issue = [&](int g, uint4 (&kept)[KL], uint4& centre, int& pick) {
    if (on) {
      centre = __ldg(src + (in0 + g) * LPR);
#pragma unroll
      for (int r = 0; r < KL; ++r) {
        const int e = r * RPI + sub;
        if (e < U) kept[r] = __ldg(src + (in0 + G + static_cast<size_t>(g) * U + e) * LPR);
      }
    }
    pick = lane < u ? __ldg(picks + (bh * G + g) * U + lane) : -1;
  };
  // the warp's table of each entry's slot.  Lane s < gs finds its slot's
  // entry: kept row i where pick i names it, else u + its rank among the
  // unpicked slots (an inactive head: every slot unpicked, u = 0).  The
  // entries are a permutation of the group's slots whatever the picks hold:
  // a repeated pick, or one outside the group, gives unspecified values (as
  // the plain version's scatter does for a repeated one), never a slot
  // unwritten or a write outside it.
  auto resolve = [&](int my_pick) {
    int ki = -1;
    for (int i = 0; i < u; ++i)
      if (__shfl_sync(0xffffffffu, my_pick, i) == lane && lane < gs) ki = i;
    const unsigned won = __reduce_or_sync(0xffffffffu, ki >= 0 ? 1u << ki : 0u);
    const unsigned unpicked = __ballot_sync(0xffffffffu, lane < gs && ki < 0);
    const int entry = ki >= 0 ? __popc(won & ((1u << ki) - 1u))
                              : __popc(won) + __popc(unpicked & ((1u << lane) - 1u));
    __syncwarp();  // the previous group's reads of es are done
    if (lane < gs) es[entry] = lane;
    __syncwarp();
  };
  // group g's rows to the tokens of their entries' slots
  auto store = [&](int g, const uint4 (&kept)[KL], const uint4& centre) {
    const Group grp(g, HH, W, wh, ww);
#pragma unroll
    for (int r = 0; r < NL; ++r) {
      const int e = r * RPI + sub;
      if (e >= gs) continue;
      const uint4 x = !on ? make_uint4(0, 0, 0, 0)
                          : (r < KL && e < U ? kept[r < KL ? r : 0] : centre);
      const int tok = grp.token(es[e], wt, wh, ww, HH, W);
      reinterpret_cast<uint4*>(out + (out0 + tok) * D)[piece] = x;
    }
  };

  // each warp: groups g, g + stride, ...; the next group's loads and pick are
  // in flight while the current group stores, and its pick is resolved after
  const int stride = gridDim.x * WARPS;
  int g = blockIdx.x * WARPS + warp;
  if (g >= G) return;
  uint4 kept[KL], centre;
  int pick;
  issue(g, kept, centre, pick);
  resolve(pick);
  for (;;) {
    const int gn = g + stride;
    uint4 kept_n[KL], centre_n;
    int pick_n = -1;
    if (gn < G) issue(gn, kept_n, centre_n, pick_n);
    store(g, kept, centre);
    if (gn >= G) break;
    resolve(pick_n);
#pragma unroll
    for (int r = 0; r < KL; ++r) kept[r] = kept_n[r];
    centre = centre_n;
    g = gn;
  }
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
copy_probe_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ pq,
                  __nv_bfloat16* __restrict__ pk, __nv_bfloat16* __restrict__ pv, int H, int T,
                  int HH, int W, int wt, int wh, int ww, int U) {
  const int lane = threadIdx.x % 32;
  const int G = (T / wt) * (HH / wh) * (W / ww);
  const int g = blockIdx.x * WARPS + threadIdx.x / 32;
  if (g >= G) return;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const size_t in0 = bh * T * HH * W, out0 = bh * G * (1 + U);
  const Group grp(g, HH, W, wh, ww);
  const __nv_bfloat16* src[3] = {q, k, v};
  __nv_bfloat16* dst[3] = {pq, pk, pv};
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    const __nv_bfloat16* s0 = src[x] + (in0 + grp.token(0, wt, wh, ww, HH, W)) * D;
    copy_row<D>(dst[x] + (out0 + g) * D, s0, lane);
    for (int i = 0; i < U; ++i)
      copy_row<D>(dst[x] + (out0 + G + static_cast<size_t>(g) * U + i) * D,
                  src[x] + (in0 + grp.token(i, wt, wh, ww, HH, W)) * D, lane);
  }
}

// ops/coreset_pallas.py:unpool_layout: the rows kernel's store instructions
// a lane (ceil(gs / RPI) rounded up to 4, 8 or 16, RPI = 512 / (D * esize)
// rows an instruction) and kept-row loads a lane (NL / 2 where ceil(U / RPI)
// fits it, else NL); false where it takes no shape (f32 at D = 128 with more
// than 16 slots a group)
bool unpool_layout(int D, int gs, int U, int esize, int& NL, int& KL) {
  if ((D != 64 && D != 128) || gs < 1 || gs > 32 || U < 0 || U >= gs) return false;
  const int rpi = 512 / (D * esize), need = (gs + rpi - 1) / rpi;
  if (need > 16) return false;
  NL = need <= 4 ? 4 : need <= 8 ? 8 : 16;
  KL = (U + rpi - 1) / rpi <= NL / 2 ? NL / 2 : NL;
  return true;
}

// groups per warp of the rows kernel (each warp walks them gridDim.x * WARPS apart)
constexpr int GROUPS_PER_WARP = 4;

bool bad_shape(int T, int HH, int W, int D, int wt, int wh, int ww, int U) {
  return T % wt || HH % wh || W % ww || (D != 64 && D != 128) || wt * wh * ww > 32 || U < 0 ||
         U >= wt * wh * ww;
}

// one warp per group; the head dimension covers `heads` positions
dim3 grid_of(int B, int heads, int T, int HH, int W, int wt, int wh, int ww) {
  const int G = (T / wt) * (HH / wh) * (W / ww);
  return dim3((G + WARPS - 1) / WARPS, heads, B);
}

template <typename Elem>
int pool(const void* q, const void* k, const void* v, void* pq, void* pk, void* pv, void* picks,
         const void* active, const void* head_map, int num_active, int kv_from_k, int B, int H,
         int T, int HH, int W, int D, int wt, int wh, int ww, int U, void* stream) {
  if (bad_shape(T, HH, W, D, wt, wh, ww, U) || (active == nullptr) == (head_map == nullptr) ||
      (head_map != nullptr && (num_active < 1 || num_active > H)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of(B, head_map != nullptr ? num_active : H, T, HH, W, wt, wh, ww);
  auto st = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const Elem*>(q);
  auto* kk = static_cast<const Elem*>(k);
  auto* vv = static_cast<const Elem*>(v);
  auto* oq = static_cast<Elem*>(pq);
  auto* ok = static_cast<Elem*>(pk);
  auto* ov = static_cast<Elem*>(pv);
  auto* pi = static_cast<int*>(picks);
  auto* act = static_cast<const int*>(active);
  auto* hm = static_cast<const int*>(head_map);
  if (D == 128)
    pool_kernel<128, Elem><<<grid, WARPS * 32, 0, st>>>(qq, kk, vv, oq, ok, ov, pi, act, hm,
                                                        kv_from_k, H, T, HH, W, wt, wh, ww, U);
  else
    pool_kernel<64, Elem><<<grid, WARPS * 32, 0, st>>>(qq, kk, vv, oq, ok, ov, pi, act, hm,
                                                       kv_from_k, H, T, HH, W, wt, wh, ww, U);
  return static_cast<int>(cudaGetLastError());
}

template <typename Elem>
int unpool(const void* pooled, const void* picks, const void* active, const void* head_map,
           void* out, int num_active, int B, int H, int T, int HH, int W, int D, int wt, int wh,
           int ww, int U, int stores, int loads, void* stream) {
  int NL = 0, KL = 0;
  const bool rows = stores != 0 || loads != 0;
  if (bad_shape(T, HH, W, D, wt, wh, ww, U) || (active == nullptr) == (head_map == nullptr) ||
      (head_map != nullptr && (num_active < 1 || num_active > H)) ||
      (rows && (!unpool_layout(D, wt * wh * ww, U, sizeof(Elem), NL, KL) || NL != stores ||
                KL != loads || reinterpret_cast<uintptr_t>(pooled) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int heads = head_map != nullptr ? num_active : H;
  auto st = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<const Elem*>(pooled);
  auto* pi = static_cast<const int*>(picks);
  auto* act = static_cast<const int*>(active);
  auto* hm = static_cast<const int*>(head_map);
  auto* oo = static_cast<Elem*>(out);
  if (rows) {
    const int G = (T / wt) * (HH / wh) * (W / ww);
    const dim3 grid((G + WARPS * GROUPS_PER_WARP - 1) / (WARPS * GROUPS_PER_WARP), heads, B);
    auto run = [&](auto kern) {
      kern<<<grid, WARPS * 32, 0, st>>>(pp, pi, act, hm, oo, H, T, HH, W, wt, wh, ww, U);
    };
    const bool half = KL < NL;
    if (D == 128) {
      if (NL == 4)
        half ? run(unpool_rows_kernel<128, 4, 2, Elem>) : run(unpool_rows_kernel<128, 4, 4, Elem>);
      if (NL == 8)
        half ? run(unpool_rows_kernel<128, 8, 4, Elem>) : run(unpool_rows_kernel<128, 8, 8, Elem>);
      if (NL == 16)
        half ? run(unpool_rows_kernel<128, 16, 8, Elem>)
             : run(unpool_rows_kernel<128, 16, 16, Elem>);
    } else {
      if (NL == 4)
        half ? run(unpool_rows_kernel<64, 4, 2, Elem>) : run(unpool_rows_kernel<64, 4, 4, Elem>);
      if (NL == 8)
        half ? run(unpool_rows_kernel<64, 8, 4, Elem>) : run(unpool_rows_kernel<64, 8, 8, Elem>);
      if (NL == 16)
        half ? run(unpool_rows_kernel<64, 16, 8, Elem>)
             : run(unpool_rows_kernel<64, 16, 16, Elem>);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid = grid_of(B, heads, T, HH, W, wt, wh, ww);
  if (D == 128)
    unpool_kernel<128, Elem><<<grid, WARPS * 32, 0, st>>>(pp, pi, act, hm, oo, H, T, HH, W, wt,
                                                          wh, ww, U);
  else
    unpool_kernel<64, Elem><<<grid, WARPS * 32, 0, st>>>(pp, pi, act, hm, oo, H, T, HH, W, wt,
                                                         wh, ww, U);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: contiguous raster (B, H, T*HH*W, D) bf16; pq, pk, pv: (B, H,
// G*(1+U), D) bf16; picks: (B, H, G, U) int32 (Q's); kv_from_k: 1 to pool K
// and V by K's own matching.  Either active: (H,) int32 (head_map null,
// num_active ignored), or head_map: (>= num_active,) int32 distinct head ids
// (active null), only heads head_map[:num_active] written.
extern "C" int vorta_coreset_pool_bf16(const void* q, const void* k, const void* v, void* pq,
                                       void* pk, void* pv, void* picks, const void* active,
                                       const void* head_map, int num_active, int kv_from_k,
                                       int B, int H, int T, int HH, int W, int D, int wt, int wh,
                                       int ww, int U, void* stream) {
  return pool<__nv_bfloat16>(q, k, v, pq, pk, pv, picks, active, head_map, num_active, kv_from_k,
                             B, H, T, HH, W, D, wt, wh, ww, U, stream);
}

// The same pool in f32: q, k, v, pq, pk, pv f32 (the similarity sums as in
// bf16, the rows moved bit for bit).
extern "C" int vorta_coreset_pool_f32(const void* q, const void* k, const void* v, void* pq,
                                      void* pk, void* pv, void* picks, const void* active,
                                      const void* head_map, int num_active, int kv_from_k, int B,
                                      int H, int T, int HH, int W, int D, int wt, int wh, int ww,
                                      int U, void* stream) {
  return pool<float>(q, k, v, pq, pk, pv, picks, active, head_map, num_active, kv_from_k, B, H,
                     T, HH, W, D, wt, wh, ww, U, stream);
}

// pooled: contiguous (B, H, G*(1+U), D) bf16, 16-byte aligned; picks: (B, H,
// G, U) int32; out: raster (B, H, T*HH*W, D) bf16; active / head_map +
// num_active as for the pool.  stores, loads: the rows kernel's store and
// kept-row load instructions a lane, as ops/coreset_pallas.py:unpool_layout
// gives them (any other pair is an error), or 0, 0 for the first design's
// kernel (unpool_per_group).
extern "C" int vorta_coreset_unpool_bf16(const void* pooled, const void* picks,
                                         const void* active, const void* head_map, void* out,
                                         int num_active, int B, int H, int T, int HH, int W,
                                         int D, int wt, int wh, int ww, int U, int stores,
                                         int loads, void* stream) {
  return unpool<__nv_bfloat16>(pooled, picks, active, head_map, out, num_active, B, H, T, HH, W,
                               D, wt, wh, ww, U, stores, loads, stream);
}

// The same unpool in f32 (pooled, out f32; the layout rule at 4-byte
// elements).
extern "C" int vorta_coreset_unpool_f32(const void* pooled, const void* picks,
                                        const void* active, const void* head_map, void* out,
                                        int num_active, int B, int H, int T, int HH, int W,
                                        int D, int wt, int wh, int ww, int U, int stores,
                                        int loads, void* stream) {
  return unpool<float>(pooled, picks, active, head_map, out, num_active, B, H, T, HH, W, D, wt,
                       wh, ww, U, stores, loads, stream);
}

// The copy probe: q, k, v raster (B, H, T*HH*W, D) bf16 -> pq, pk, pv (B, H,
// G*(1+U), D) bf16, slot 0 as each group's center, slots 0..U-1 as its
// margins.
extern "C" int vorta_copy_probe_bf16(const void* q, const void* k, const void* v, void* pq,
                                     void* pk, void* pv, int B, int H, int T, int HH, int W,
                                     int D, int wt, int wh, int ww, int U, void* stream) {
  if (bad_shape(T, HH, W, D, wt, wh, ww, U)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of(B, H, T, HH, W, wt, wh, ww);
  auto st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  auto* qq = static_cast<const bf*>(q);
  auto* kk = static_cast<const bf*>(k);
  auto* vv = static_cast<const bf*>(v);
  auto* oq = static_cast<bf*>(pq);
  auto* ok = static_cast<bf*>(pk);
  auto* ov = static_cast<bf*>(pv);
  if (D == 128)
    copy_probe_kernel<128><<<grid, WARPS * 32, 0, st>>>(qq, kk, vv, oq, ok, ov, H, T, HH, W, wt,
                                                        wh, ww, U);
  else
    copy_probe_kernel<64><<<grid, WARPS * 32, 0, st>>>(qq, kk, vv, oq, ok, ov, H, T, HH, W, wt,
                                                       wh, ww, U);
  return static_cast<int>(cudaGetLastError());
}
