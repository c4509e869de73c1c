// Tile-major block-sparse sliding-tile attention with sub-tile pair bits and
// the fast softmax, for Hopper (sm_90a).
//
// Replaces vorta_tpu/ops/sta_batched.py:_kernel (reached through
// sta_flash_headbatched), the JAX package's STA kernel for tiles too small
// for its window-dense kernels and for the joint layouts whose text length
// is not a multiple of 8.  Same function: q, k, v in tile-major layout;
// q block i (block_q rows) visits the kv blocks kv_index[0, i, :kv_count[0,
// i]] (tables shared by all heads); within a visited block, query row r
// sees key column c where bit (r / tpt) * k_sub + c / tpt of that entry's
// pair-bit word is set (a uint32 word stored as int32; a bit index of 32 or
// more sees nothing, as XLA's logical shift gives); an optional kv_bias,
// (Skv,) f32 shared by every batch row and head, is added to the scores.
// Fast softmax: q arrives pre-scaled by scale * log2(e) (rounded to bf16
// by the wrapper, as the JAX wrapper rounds it), p = exp2(q.k + bias) with
// no running max, masked entries give exactly 0, P rounded to bf16 before
// the PV product, rows normalised by l (l == 0 -> 0: rows that see
// nothing, q blocks with count 0).  Heads whose active entry is 0 write
// zeros.  Block sizes need not be powers of two (HunyuanVideo's (2, 9, 8)
// tile gives 432 / 1008): any multiple of 8.
//
// Bound on this card: at HunyuanVideo-13B 720p x 45f with tile (2, 9, 8)
// (the joint layout, 48,384 rows) the visible pairs are ~3.0e8 per head
// (video rows see 27 tiles of 144 keys and the text; text rows, padding
// included, see everything), 4 * 128 FLOP each: 1.6e11 FLOP per head
// against 50 MB of operands, so the tensor cores bound it.  Two designs,
// chosen per call by the wrapper's rule (ops/sta_batched.py:
// batched_wgmma_path, mirrored by the C entry):
//
// - The Hopper path (the fast softmax, D = 128, tiles of at least 128
//   tokens or no pair bits: every served geometry): csrc/attn_sm90.cuh's
//   mainloop with the fast softmax and the kv_bias slot over PairBitSource
//   (sta_batched_sm90_kernel).  Blocks need not be multiples of 128 (432 /
//   1008 at (2, 9, 8)): a q block takes ceil(block_q / 128) CTAs of 128
//   rows (rows past the block computed, never stored: 84% of the rows
//   useful), a kv block ceil(block_kv / 128) slots of 128 keys (keys past
//   the block masked: 98% useful), so the tables stay bit for bit JAX's.
//   With tiles of at least 128 tokens a CTA's rows cross at most one row
//   tile boundary and a slot's keys at most one key tile boundary, so the
//   pair bits of a (CTA, slot) are 2 x 2 bits and a column split; the key
//   split falls on a multiple of 8 (tiles and slots are), so each thread's
//   mask is one bit per 8-column block of each of its two rows, a select
//   per score with a compile-time shift, no branch, and none at all on a
//   slot every pair of which is visible.  Before the ring starts, one warp
//   builds the CTA's slot list in shared memory: a slot no pair bit links
//   to the CTA's rows, or whose keys the bias masks completely (a
//   per-block table of live slots, sta_batched_live_kernel's, one pass
//   over the bias), is neither loaded nor multiplied, as the mma.sync
//   kernel skips its sub-tiles (exp2 of -1e30 is exactly 0: the skip
//   changes no bit).  Q, K and V arrive by TMA (rows contiguous), the
//   slot's bias by a bulk copy of its valid keys' floats.
// - The mma.sync path (the stable softmax, D = 64, tiles under 128 tokens
//   with pair bits), below: one CUDA block of 4 warps per (64-row chunk of
//   a q block, head, batch); each visited kv block is walked in 64-key
//   sub-tiles staged in shared memory, and a sub-tile is skipped whole (no
//   load, no mma) where no pair bit links the chunk's rows to it or where
//   the bias masks all its keys; products on mma.sync m16n8k16
//   (mma_bf16.cuh).
//
// The stable softmax (STABLE; sta_batched.py:126-171, the JAX wrapper's
// default): q is not pre-scaled; the f32 scores are scaled by sl = scale *
// log2(e), kv_bias added, the pairs the bits hide set to -1e30; a running
// max per row with the TPU kernel's m_safe, the sums and the accumulator
// rescaled at every sub-tile (stable_update, mma_bf16.cuh).  The skipped
// sub-tiles (no pair bit, or every key masked by the bias) change nothing
// here either: they could only offer -1e30 to the max.
#include <math.h>

#include <type_traits>

#include "attn_sm90.cuh"
#include "attn_f32.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace vorta;

constexpr int BLOCK_N = 64;  // kv rows per shared-memory sub-tile
constexpr int WARPS = 4;
constexpr int BLOCK_M = 16 * WARPS;
constexpr float LIVE_BIAS = -1e20f;  // a bias at or below it masks its key exactly

__device__ __forceinline__ bool bit_at(uint32_t word, int idx) {
  return idx < 32 && ((word >> idx) & 1u);
}

template <int D, bool STABLE>
__global__ void __launch_bounds__(WARPS * 32)
sta_batched_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                   const int* __restrict__ kv_index, const int* __restrict__ kv_count,
                   const int* __restrict__ pair_bits, const float* __restrict__ kv_bias,
                   const int* __restrict__ active, int H, int Sq, int Skv, int width,
                   int block_q, int block_kv, int tpt, int k_sub, int chunks, float sl) {
  constexpr int LDS = D + 8;  // padded rows: conflict-free ldmatrix
  constexpr int NT_S = BLOCK_N / 8;
  constexpr int NT_O = D / 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 Ks[BLOCK_N * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BLOCK_N * LDS];
  __shared__ float Bs[BLOCK_N];  // the sub-tile's bias (-inf past the block)
  __shared__ int Ct[BLOCK_N];  // the sub-tile's column tiles, col / tpt

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qi = blockIdx.x / chunks;
  const int r0 = (blockIdx.x % chunks) * BLOCK_M;  // first row of the chunk in its q block
  const int rows = min(BLOCK_M, block_q - r0);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const __nv_bfloat16* kp = k + bh * Skv * D;
  const __nv_bfloat16* vp = v + bh * Skv * D;

  const int rg = r0 + warp * 16 + g, rg8 = rg + 8;  // rows in the q block
  const size_t qrow = bh * Sq + static_cast<size_t>(qi) * block_q;
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, rg < block_q ? q + (qrow + rg) * D : nullptr,
                  rg8 < block_q ? q + (qrow + rg8) * D : nullptr, t);
  float oacc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float l_part[2] = {0.f, 0.f};
  float m_run[2] = {NEG_INF, NEG_INF};  // STABLE: the running row max
  const bool has_bits = pair_bits != nullptr;
  const int rt0 = rg / tpt * k_sub, rt1 = rg8 / tpt * k_sub;  // bit offsets of the two rows
  const int mt_lo = r0 / tpt, mt_hi = (r0 + rows - 1) / tpt;  // the chunk's row tiles

  const int count = active[h] ? kv_count[qi] : 0;
  for (int j = 0; j < count; ++j) {
    const size_t entry = static_cast<size_t>(qi) * width + j;
    const int kvb = kv_index[entry];
    const uint32_t bits = has_bits ? static_cast<uint32_t>(pair_bits[entry]) : 0u;
    for (int n0 = 0; n0 < block_kv; n0 += BLOCK_N) {
      const int nvalid = min(BLOCK_N, block_kv - n0);
      if (has_bits) {  // block-uniform: does any row tile of the chunk see this sub-tile?
        bool any = false;
        for (int mt = mt_lo; mt <= mt_hi && !any; ++mt)
          for (int kt = n0 / tpt; kt <= (n0 + nvalid - 1) / tpt && !any; ++kt)
            any = bit_at(bits, mt * k_sub + kt);
        if (!any) continue;
      }
      const size_t kv0 = static_cast<size_t>(kvb) * block_kv + n0;
      __syncthreads();  // previous sub-tile fully consumed
      int live = 0;
      for (int c = tid; c < BLOCK_N; c += WARPS * 32) {
        const float bias = c >= nvalid ? -INFINITY : (kv_bias ? kv_bias[kv0 + c] : 0.f);
        Bs[c] = bias;
        Ct[c] = (n0 + c) / tpt;
        live |= bias > LIVE_BIAS;
      }
      if (!__syncthreads_or(live)) continue;  // every key masked: adds nothing
      for (int e = tid; e < BLOCK_N * CHUNKS; e += WARPS * 32) {
        const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
        uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
        if (r < nvalid) {
          kv4 = *reinterpret_cast<const uint4*>(kp + (kv0 + r) * D + c);
          vv4 = *reinterpret_cast<const uint4*>(vp + (kv0 + r) * D + c);
        }
        *reinterpret_cast<uint4*>(Ks + r * LDS + c) = kv4;
        *reinterpret_cast<uint4*>(Vs + r * LDS + c) = vv4;
      }
      __syncthreads();

      float s[NT_S][4];
      qk_tile<D, NT_S, LDS>(s, qa, Ks, lane);
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          const bool vis = !has_bits || bit_at(bits, ((e >> 1) ? rt1 : rt0) + Ct[col]);
          if constexpr (STABLE) {
            s[n][e] = vis ? s[n][e] * sl + Bs[col] : NEG_INF;  // Bs -inf past the block
          } else {
            const float p = vis ? exp2f(s[n][e] + Bs[col]) : 0.f;  // exp2(-inf) = 0
            s[n][e] = p;
            l_part[e >> 1] += p;
          }
        }
      }
      if constexpr (STABLE) stable_update<NT_S, NT_O>(s, m_run, l_part, oacc);
      pv_tile<D, NT_S, LDS>(oacc, s, Vs, lane);
    }
  }

  const float l0 = row_sum(l_part[0]), l1 = row_sum(l_part[1]);
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * t;
    if (rg < block_q)
      *reinterpret_cast<uint32_t*>(out + (qrow + rg) * D + c) =
          pack_bf16(oacc[n][0] / l0, oacc[n][1] / l0);
    if (rg8 < block_q)
      *reinterpret_cast<uint32_t*>(out + (qrow + rg8) * D + c) =
          pack_bf16(oacc[n][2] / l1, oacc[n][3] / l1);
  }
}

// ---- the Hopper path: csrc/attn_sm90.cuh's mainloop over the pair-bit tables --------

struct BatchedParams {
  __nv_bfloat16* out;    // (B, H, Sq, D) tile-major
  const int* kv_index;   // (nq, width)
  const int* kv_count;   // (nq,)
  const int* pair_bits;  // (nq, width), or null: every pair of a visited block visible
  const float* kv_bias;  // (Skv,), or null
  const int* live;       // (Skv / block_kv,): bit i set where slot i of the block has a
                         // key the bias leaves; null without a bias
  const int* active;     // (H,)
  int H, Sq, Skv, width, block_q, block_kv, tpt, k_sub;
  int cpb, spb;          // CTAs per q block, 128-key slots per kv block
};

// The CTA's slot list in shared memory past the mainloop's barriers: its
// length, then (first key, info) per slot; info = nvalid | key split << 8 |
// the 2 x 2 pair bits << 16 | every pair visible << 20.
constexpr int LIST_OFF = sm90::SRC_OFF + 16;
constexpr int LIST_MAX = (232448 - LIST_OFF - 1024) / 8;

__device__ __forceinline__ uint32_t blocks_below(int cols) {  // 8-column blocks under cols
  return cols >= sm90::BN ? 0xFFFFu : (1u << (cols / 8)) - 1u;
}

// sta_batched's source: the CTA's rows are rows r0.. (at most 128, fewer
// in a q block's last CTA) of q block qi of head (blockIdx.z, blockIdx.y),
// loaded by TMA; its ring slots the list prepare() builds.
struct PairBitSource {
  static constexpr bool Q_BY_TMA = true;
  static constexpr bool OWN_SOFTMAX = true;
  const CUtensorMap *tq, *tk, *tv;
  const BatchedParams& p;
  size_t bh;              // b * H + h
  int qrow0, rows, j = 0, n_slots = 0;
  const int2* list = nullptr;
  uint32_t rowsel = 0;    // bit hr: this thread's row hr is in the CTA's second row tile

  __device__ __forceinline__ PairBitSource(const CUtensorMap& tq_, const CUtensorMap& tk_,
                                           const CUtensorMap& tv_, const BatchedParams& p_)
      : tq(&tq_), tk(&tk_), tv(&tv_), p(p_) {
    bh = static_cast<size_t>(blockIdx.z) * p.H + blockIdx.y;
    const int qi = blockIdx.x / p.cpb, r0 = (blockIdx.x % p.cpb) * sm90::BM;
    qrow0 = qi * p.block_q + r0;
    rows = min(sm90::BM, p.block_q - r0);
  }

  // Warp 0 lists the CTA's live slots (in the tables' order: kv_index's
  // blocks, each block's slots in turn), a lane per kv block: its entry's
  // loads are the only global reads, one round of them per 32 blocks; a
  // warp scan of the lanes' slot counts places each lane's slots.  Every
  // thread notes which row tile its two consumer rows are in.
  __device__ __forceinline__ void prepare(uint8_t* smem, int tid) {
    using namespace sm90;
    const int qi = blockIdx.x / p.cpb, r0 = qrow0 - qi * p.block_q;
    const int tpt = p.pair_bits ? p.tpt : 1 << 30;  // without bits: one tile of everything
    const int ra = r0 / tpt, rb = (r0 + rows - 1) / tpt;
    const int row = (tid / 128) * 64 + ((tid % 128) / 32) * 16 + (tid % 32) / 4;
    rowsel = ((r0 + row) / tpt != ra ? 1u : 0u) | ((r0 + row + 8) / tpt != ra ? 2u : 0u);
    int* count_smem = reinterpret_cast<int*>(smem + SRC_OFF);
    int2* slots = reinterpret_cast<int2*>(smem + LIST_OFF);
    if (tid < 32) {
      const int count = p.active[blockIdx.y] ? p.kv_count[qi] : 0;
      auto bit = [&](uint32_t word, int rt, int kt) {
        const int idx = rt * p.k_sub + kt;
        return idx < 32 && ((word >> idx) & 1u);
      };
      // slot si of a block with pair-bit word `word`: its info word, 0 where
      // no pair bit links it to the CTA's rows
      auto slot_info = [&](uint32_t word, int si) -> uint32_t {
        const int n0 = si * BN, nvalid = min(BN, p.block_kv - n0);
        const int kt0 = n0 / tpt, split = min((kt0 + 1) * tpt - n0, nvalid);
        uint32_t vis4 = 0xFu;  // bit 2 * (row tile b?) + (key tile kt0 + 1?)
        bool full = nvalid == BN;
        if (p.pair_bits) {
          const bool two_cols = split < nvalid;
          const bool a0 = bit(word, ra, kt0), a1 = two_cols && bit(word, ra, kt0 + 1);
          const bool b0 = bit(word, rb, kt0), b1 = two_cols && bit(word, rb, kt0 + 1);
          vis4 = a0 | (a1 << 1) | (b0 << 2) | (b1 << 3);
          full = full && a0 && b0 && (!two_cols || (a1 && b1));
        }
        return vis4 == 0 ? 0u : nvalid | (split << 8) | (vis4 << 16) | (full ? 1u << 20 : 0u);
      };
      int n = 0;
      for (int j0 = 0; j0 < count; j0 += 32) {
        const int jj = j0 + tid;
        int kvb = 0;
        uint32_t word = 0, live = 0;  // live: bit si where slot si is listed
        if (jj < count) {
          const size_t entry = static_cast<size_t>(qi) * p.width + jj;
          kvb = p.kv_index[entry];
          word = p.pair_bits ? static_cast<uint32_t>(p.pair_bits[entry]) : 0u;
          const uint32_t bias_live = p.live ? static_cast<uint32_t>(p.live[kvb]) : ~0u;
          for (int si = 0; si < p.spb; ++si)
            if (((bias_live >> si) & 1u) && slot_info(word, si)) live |= 1u << si;
        }
        const int mine = __popc(live);
        int incl = mine;  // inclusive scan of the lanes' slot counts
        for (int o = 1; o < 32; o *= 2) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (tid >= o) incl += y;
        }
        int at = n + incl - mine;
        for (int si = 0; si < p.spb; ++si)
          if ((live >> si) & 1u)
            slots[at++] = make_int2(kvb * p.block_kv + si * BN,
                                    static_cast<int>(slot_info(word, si)));
        n += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (tid == 0) *count_smem = n;
    }
    __syncthreads();
    n_slots = *count_smem;
    list = slots;
  }
  // routed away, count 0, or no slot left to attend: zeros, no barrier touched
  __device__ __forceinline__ bool idle() const { return n_slots == 0; }
  __device__ __forceinline__ void write_zeros(int tid) const {
    uint4* o4 = reinterpret_cast<uint4*>(p.out + (bh * p.Sq + qrow0) * sm90::D);
    for (int e = tid; e < rows * sm90::D / 8; e += sm90::THREADS) o4[e] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void issue_q(uint32_t q_smem, uint32_t bar) const {
    using namespace sm90;
    mbar_expect_tx(bar, KV_BYTES);
    const int qrow = static_cast<int>(bh * p.Sq) + qrow0;
    tma_load(q_smem, tq, bar, 0, qrow);
    tma_load(q_smem + BM * ROW_BYTES, tq, bar, 64, qrow);
  }
  __device__ __forceinline__ bool next(sm90::Slot& s) {
    if (j >= n_slots) return false;
    const int2 e = list[j++];
    s.key0 = e.x;
    s.info = static_cast<uint32_t>(e.y);
    s.nvalid = e.y & 0xFF;
    s.bias = p.kv_bias != nullptr;
    return true;
  }
  __device__ __forceinline__ void issue_k(const sm90::Slot& s, uint32_t dst, uint32_t bias_dst,
                                          uint32_t bar) const {
    using namespace sm90;
    const int row = static_cast<int>(bh * p.Skv) + s.key0;
    mbar_expect_tx(bar, KV_BYTES + (s.bias ? s.nvalid * 4 : 0));
    tma_load(dst, tk, bar, 0, row);
    tma_load(dst + BN * ROW_BYTES, tk, bar, 64, row);
    if (s.bias) bulk_load(bias_dst, p.kv_bias + s.key0, s.nvalid * 4, bar);
  }
  __device__ __forceinline__ void issue_v(const sm90::Slot& s, uint32_t dst, uint32_t bar) const {
    using namespace sm90;
    const int row = static_cast<int>(bh * p.Skv) + s.key0;
    mbar_expect_tx(bar, KV_BYTES);
    tma_load(dst, tv, bar, 0, row);
    tma_load(dst + BN * ROW_BYTES, tv, bar, 64, row);
  }
  // the fast softmax under the slot's pair bits: the thread's rows' 8-column
  // blocks from the key split, the 2 x 2 bits and nvalid; none on a slot
  // whose every pair is visible
  template <sm90::Softmax SM>
  __device__ __forceinline__ void softmax(float (&s)[64], const sm90::Slot& slot, int, int t,
                                          float, const float* bs, float (&m_run)[2],
                                          float (&l_part)[2], float (&alpha)[2]) const {
    using namespace sm90;
    static_assert(SM == Softmax::Fast, "sta_batched's Hopper path is the fast softmax");
    const uint32_t info = slot.info;
    if ((info >> 20) & 1u) {
      if (bs != nullptr)
        fast_p<false, true, true>(s, BN, t, bs, l_part);
      else
        fast_p<false, false, true>(s, BN, t, bs, l_part);
      return;
    }
    const uint32_t lo = blocks_below((info >> 8) & 0xFF), valid = blocks_below(info & 0xFF);
    uint32_t vis[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const uint32_t b = (info >> (16 + 2 * ((rowsel >> hr) & 1u))) & 3u;
      vis[hr] = ((b & 1u) ? lo : 0u) | ((b & 2u) ? valid & ~lo : 0u);
    }
    if (bs != nullptr)
      fast_p_vis<true>(s, t, bs, vis, l_part);
    else
      fast_p_vis<false>(s, t, bs, vis, l_part);
  }
  __device__ __forceinline__ float scale_log2() const { return 0.f; }  // q pre-scaled
  __device__ __forceinline__ float qk_factor() const { return 1.f; }
  __device__ __forceinline__ __nv_bfloat16* out_row(int r) const {
    return r < rows ? p.out + (bh * p.Sq + qrow0 + r) * sm90::D : nullptr;
  }
  __device__ __forceinline__ float* lse_row(int) const { return nullptr; }
};

__global__ void __launch_bounds__(sm90::THREADS, 1)
sta_batched_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ BatchedParams p) {
  PairBitSource src(tq, tk, tv, p);
  sm90::attn_mainloop<sm90::Softmax::Fast, false>(src);
}

// Which 128-key slots of each kv block hold a key the bias leaves (bias >
// LIVE_BIAS): bit i of live[block]; one warp per slot.
__global__ void sta_batched_live_kernel(const float* __restrict__ bias, int* __restrict__ live,
                                        int block_kv) {
  __shared__ int bits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) bits = 0;
  __syncthreads();
  const int n0 = warp * sm90::BN, nvalid = min(sm90::BN, block_kv - n0);
  const float* b = bias + static_cast<size_t>(blockIdx.x) * block_kv + n0;
  bool any = false;
  for (int c = lane; c < nvalid; c += 32) any |= b[c] > LIVE_BIAS;
  if (__any_sync(0xffffffffu, any) && lane == 0) atomicOr(&bits, 1 << warp);
  __syncthreads();
  if (threadIdx.x == 0) live[blockIdx.x] = bits;
}

// The Hopper path's dynamic shared memory for a slot list of n entries.
int batched_smem_bytes(int n) { return LIST_OFF + n * 8 + 1024; }

cudaError_t launch_sm90(int B, const BatchedParams& p, const void* q, const void* k,
                        const void* v, cudaStream_t st) {
  if (p.kv_bias != nullptr) {
    sta_batched_live_kernel<<<p.Skv / p.block_kv, 32 * p.spb, 0, st>>>(
        p.kv_bias, const_cast<int*>(p.live), p.block_kv);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  CUtensorMap tq, tk, tv;
  const uint64_t bh = static_cast<uint64_t>(B) * p.H;
  if (!sm90::make_map(&tq, q, bh * p.Sq, sm90::BM) ||
      !sm90::make_map(&tk, k, bh * p.Skv, sm90::BN) ||
      !sm90::make_map(&tv, v, bh * p.Skv, sm90::BN))
    return cudaErrorInvalidValue;
  const int smem = batched_smem_bytes(p.width * p.spb);
  cudaError_t err = cudaFuncSetAttribute(sta_batched_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq / p.block_q) * p.cpb, p.H, B);
  sta_batched_sm90_kernel<<<grid, sm90::THREADS, smem, st>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int D, bool STABLE>
cudaError_t launch(int B, int H, const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, const int* ki, const int* kc,
                   const int* bits, const float* bias, const int* active, int Sq, int Skv,
                   int width, int block_q, int block_kv, int tpt, int k_sub, float sl,
                   cudaStream_t st) {
  const int chunks = (block_q + BLOCK_M - 1) / BLOCK_M;
  const dim3 grid((Sq / block_q) * chunks, H, B);
  sta_batched_kernel<D, STABLE><<<grid, WARPS * 32, 0, st>>>(
      q, k, v, out, ki, kc, bits, bias, active, H, Sq, Skv, width, block_q, block_kv, tpt, k_sub,
      chunks, sl);
  return cudaGetLastError();
}

}  // namespace

// q (pre-scaled), k, v, out: contiguous (B, H, S, D) bf16, tile-major.
// kv_index / pair_bits (nq, width), kv_count (nq,): int32 on the device,
// shared by all heads; pair_bits null for none (then tpt / k_sub unused);
// kv_bias: (Skv,) f32 on the device, or null; active: (H,) int32.  stable:
// the stable softmax, q not pre-scaled, scores scaled by sl = scale *
// log2(e).  hopper: the wrapper's rule (ops/sta_batched.py:
// batched_wgmma_path) chose the Hopper path: the fast softmax, D = 128,
// tiles of at least 128 tokens and a multiple of 8 (or no pair bits), at
// most 32 slots of 128 keys per kv block and a slot list (width of them per
// kv block) within shared memory, q / k / v and kv_bias 16-byte aligned,
// live: (Skv / block_kv,) int32 scratch on the device where kv_bias is
// given; anything else there is an error, never a fallback.  Returns the
// CUDA error code.
extern "C" int vorta_sta_batched_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                          const void* kv_index, const void* kv_count,
                                          const void* pair_bits, const void* kv_bias,
                                          const void* active, int B, int H, int Sq, int Skv,
                                          int D, int nq, int width, int block_q, int block_kv,
                                          int tpt, int k_sub, int stable, float sl, int hopper,
                                          void* live, void* stream) {
  if (block_q < 8 || block_kv < 8 || block_q % 8 || block_kv % 8 || Sq % block_q ||
      Skv % block_kv || nq != Sq / block_q || width < 1 || (D != 64 && D != 128) ||
      (pair_bits && (tpt < 1 || k_sub < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hopper) {  // the wrapper's rule picked the Hopper path: its shapes or an error
    const int spb = (block_kv + sm90::BN - 1) / sm90::BN;
    if (stable || D != sm90::D || (pair_bits && (tpt < sm90::BN || tpt % 8)) || spb > 32 ||
        width * spb > LIST_MAX || (kv_bias && !live))
      return static_cast<int>(cudaErrorInvalidValue);
    const BatchedParams p{static_cast<__nv_bfloat16*>(out), static_cast<const int*>(kv_index),
                          static_cast<const int*>(kv_count), static_cast<const int*>(pair_bits),
                          static_cast<const float*>(kv_bias),
                          kv_bias ? static_cast<const int*>(live) : nullptr,
                          static_cast<const int*>(active), H, Sq, Skv, width, block_q, block_kv,
                          pair_bits ? tpt : 1, pair_bits ? k_sub : 1,
                          (block_q + sm90::BM - 1) / sm90::BM, spb};
    return static_cast<int>(launch_sm90(B, p, q, k, v, static_cast<cudaStream_t>(stream)));
  }
  using bf = __nv_bfloat16;
  auto run = [&](auto launcher) {
    return launcher(B, H, static_cast<const bf*>(q), static_cast<const bf*>(k),
                    static_cast<const bf*>(v), static_cast<bf*>(out),
                    static_cast<const int*>(kv_index), static_cast<const int*>(kv_count),
                    static_cast<const int*>(pair_bits), static_cast<const float*>(kv_bias),
                    static_cast<const int*>(active), Sq, Skv, width, block_q, block_kv,
                    pair_bits ? tpt : 1, pair_bits ? k_sub : 1, sl,
                    static_cast<cudaStream_t>(stream));
  };
  if (stable) return static_cast<int>(D == 128 ? run(launch<128, true>) : run(launch<64, true>));
  return static_cast<int>(D == 128 ? run(launch<128, false>) : run(launch<64, false>));
}

// The Hopper path's dynamic shared memory per CTA for a slot list of n
// entries (width x slots per kv block), in bytes (for reports).
extern "C" int vorta_sta_batched_sm90_smem_bytes(int n) { return batched_smem_bytes(n); }

// ---- the f32 mode: csrc/attn_f32.cuh's FFMA core over the pair-bit tables ---

namespace {

// PAIRS: the pair bits mask (row, key) pairs inside each visited block
template <int D, bool PAIRS>
__global__ void __launch_bounds__(vorta::f32::THREADS, 2)
sta_batched_f32_kernel(const float* __restrict__ q, float* __restrict__ out,
                       const __grid_constant__ vorta::f32::TableParams p, float mul,
                       int stable) {
  const vorta::f32::TableWalk<PAIRS> walk(p);
  vorta::f32::attend<D>(walk, q, out, mul, stable != 0);
}

}  // namespace

// The f32 mode (sta_batched.py's kernel at f32 inputs): q, k, v, out
// contiguous tile-major (B, H, S, D) f32; the head-shared tables, pair_bits
// (tpt, k_sub), kv_bias and active as for vorta_sta_batched_fwd_bf16;
// blocks multiples of 8 (8-row blocks included), D 64 or 128.  stable: q
// not pre-scaled, the scores times sl; else the fast softmax on q
// pre-scaled in f32.  P kept in f32.  Returns the CUDA error code.
extern "C" int vorta_sta_batched_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                         const void* kv_index, const void* kv_count,
                                         const void* pair_bits, const void* kv_bias,
                                         const void* active, int B, int H, int Sq, int Skv,
                                         int D, int nq, int width, int block_q, int block_kv,
                                         int tpt, int k_sub, int stable, float sl,
                                         void* stream) {
  if (block_q < 8 || block_kv < 8 || block_q % 8 || block_kv % 8 || Sq % block_q ||
      Skv % block_kv || nq != Sq / block_q || width < 1 || (D != 64 && D != 128) || !active ||
      (pair_bits && (tpt < 1 || k_sub < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const vorta::f32::TableParams p{
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(kv_index), static_cast<const int*>(kv_count),
      static_cast<const int*>(pair_bits), static_cast<const int*>(active),
      static_cast<const float*>(kv_bias), H, Sq, Skv, D, nq, width, 1, 1, block_q, block_kv,
      -1, 0, pair_bits ? tpt : 1, pair_bits ? k_sub : 1};
  const dim3 grid = vorta::f32::table_grid(B, p);
  const float mul = stable ? sl : 1.f;
  auto st = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const float*>(q);
  auto* oo = static_cast<float*>(out);
  auto run = [&](auto kern, auto d) {
    return vorta::f32::launch<decltype(d)::value>(kern, grid, st, qq, oo, p, mul, stable);
  };
  using D128 = std::integral_constant<int, 128>;
  using D64 = std::integral_constant<int, 64>;
  cudaError_t err;
  if (pair_bits)
    err = D == 128 ? run(sta_batched_f32_kernel<128, true>, D128{})
                   : run(sta_batched_f32_kernel<64, true>, D64{});
  else
    err = D == 128 ? run(sta_batched_f32_kernel<128, false>, D128{})
                   : run(sta_batched_f32_kernel<64, false>, D64{});
  return static_cast<int>(err);
}
