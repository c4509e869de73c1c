// Block-sparse flash attention forward for Hopper (sm_90a).
//
// Replaces vorta_tpu/ops/flash.py:_flash_kernel (reached through
// sparse_flash_attention_raw).  Same function: for q block i of head h, visit
// the kv blocks kv_index[th, i, :kv_count[th, i]] (th = 0 for head-shared
// tables), base-2 online softmax with scores (q.k) * scale * log2(e) in f32,
// masked entries -1e30, a kv_valid_len tail mask on the last valid kv block,
// P cast to bf16 before the PV product, rows normalised by l (l == 0 -> 0).
// With an lse pointer it also writes each row's base-2 log-sum-exp in the
// scaled domain, m + log2(l) from the running max and sum it already keeps,
// or the sentinel 1e30 where the row saw no key (l == 0), so that the
// backward's exp2(s - lse) underflows to 0 there (flash.py:237-241).
//
// Bound on this card: at Wan-1.3B self-attention (S = 9,360, d = 128,
// 12 heads) the work is 4*S^2*d*H = 5.4e11 FLOP against ~115 MB of operands,
// so the tensor cores bound it (~0.54 ms at 989 TFLOP/s bf16).
//
// Two designs, chosen per call by the wrapper's shape rule
// (ops/flash.py:wgmma_path, the same rule on both sides):
//
// - The Hopper path (D = 128, block_q and block_kv multiples of 128: every
//   served geometry, self- and cross-attention and training's FULL / LOWRES
//   with the lse): csrc/attn_sm90.cuh's mainloop with the online softmax
//   policy.  128-row CTAs of two consumer warpgroups and a producer
//   warpgroup; Q and a two-slot ring of 128-key K/V tiles loaded by TMA
//   with mbarriers; both products on wgmma (S = Q K^T from shared memory,
//   O += P V with P from registers and V MN-major), each tile's softmax
//   running while the previous tile's PV product is in flight; the running
//   max, the sums and the output accumulator stay in registers.
// - The mma.sync path (D = 64, and blocks 128 does not divide: the 96- and
//   360-token STA tiles of training, 24-token tiles, the 8-row tails), below:
//   mma.sync m16n8k16 (bf16 in, f32 accumulate); each warp owns 16 q rows
//   whose Q fragments stay in registers for the whole kv sweep; K/V
//   sub-tiles of 64 rows are staged in shared memory once per block and
//   shared by its 4 warps.  The tables stay in the caller's units (block_q,
//   block_kv): a CUDA block of 64 q rows lies in one table q block and walks
//   its kv list in 64-row sub-tiles (32 rows and 2 warps where block_q is a
//   multiple of 32 but not 64, e.g. the 96-token STA tiles; 16 rows and 1
//   warp for another multiple of 16).  A block_q that is a multiple of 8 but
//   not of 16 (the 360-token STA tiles of 720p training) takes
//   ceil(block_q / rows) CUDA blocks per table q block: the last one's last
//   busy warp holds 8 rows, any warp past the block's end none.  Rows past
//   the table block are read as zeros and never stored, so they neither see
//   the next q block's kv list nor overwrite its rows.
#include "attn_sm90.cuh"
#include "attn_f32.cuh"
#include "attn_f32_tc.cuh"

namespace {

using namespace vorta;

constexpr int BLOCK_N = 64;  // kv rows per shared-memory sub-tile

// D: head dim (multiple of 16); WARPS: warps per block, 16 q rows each.
template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ kv_index,
                 const int* __restrict__ kv_count, int H, int Sq, int Skv, int nq, int width,
                 int shared_tab, int block_q, int block_kv, int last_block, int valid_in_block,
                 float scale_log2) {
  constexpr int BLOCK_M = 16 * WARPS;
  constexpr int LDS = D + 8;  // padded row: conflict-free ldmatrix
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = BLOCK_N / 8;  // score n-tiles per sub-tile
  constexpr int NT_O = D / 8;        // output n-tiles
  constexpr int CHUNKS = D / 8;      // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 Ks[BLOCK_N * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BLOCK_N * LDS];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  // this warp's first row inside table q block qi, and which of its two
  // 8-row halves (rows g and g + 8) lie inside that block
  const int cblocks = (block_q + BLOCK_M - 1) / BLOCK_M;
  const int qi = blockIdx.x / cblocks;
  const int local = (blockIdx.x % cblocks) * BLOCK_M + warp * 16;
  const bool row_ok[2] = {local < block_q, local + 16 <= block_q};
  const int row0 = qi * block_q + local;
  const int th = shared_tab ? 0 : h;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const __nv_bfloat16* qp = q + (bh * Sq + row0) * D;
  const __nv_bfloat16* kp = k + bh * Skv * D;
  const __nv_bfloat16* vp = v + bh * Skv * D;

  // Q fragments, held in registers for the whole sweep (zeros past the block)
  uint32_t qa[KSTEPS][4];
  load_q_frags<D>(qa, row_ok[0] ? qp + g * D : nullptr, row_ok[1] ? qp + (g + 8) * D : nullptr,
                  t);

  float oacc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_part[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int tab = th * nq + qi;
  const int count = kv_count[tab];
  const int* idx = kv_index + static_cast<size_t>(tab) * width;

  for (int j = 0; j < count; ++j) {
    const int kvb = idx[j];
    const int limit_blk = (kvb == last_block) ? valid_in_block : block_kv;
    for (int n0 = 0; n0 < block_kv; n0 += BLOCK_N) {
      const int rows = min(BLOCK_N, block_kv - n0);
      const int nvalid = min(rows, limit_blk - n0);
      if (nvalid <= 0) continue;  // fully masked: exactly a no-op in the softmax
      const size_t base = static_cast<size_t>(kvb) * block_kv + n0;
      __syncthreads();  // previous sub-tile fully consumed
      for (int e = tid; e < BLOCK_N * CHUNKS; e += WARPS * 32) {
        const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
        uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
        if (r < rows) {
          kv4 = *reinterpret_cast<const uint4*>(kp + (base + r) * D + c);
          vv4 = *reinterpret_cast<const uint4*>(vp + (base + r) * D + c);
        }
        *reinterpret_cast<uint4*>(Ks + r * LDS + c) = kv4;
        *reinterpret_cast<uint4*>(Vs + r * LDS + c) = vv4;
      }
      __syncthreads();

      // S = Q K^T for this warp's 16 rows x 64 kv columns
      float s[NT_S][4];
#pragma unroll
      for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const int mi = lane / 8, mr = lane % 8;
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; kk += 2) {
          uint32_t r[4];
          ldsm_x4(r, Ks + (n * 8 + mr) * LDS + kk * 16 + mi * 8);
          mma_bf16(s[n], qa[kk], r[0], r[1]);
          mma_bf16(s[n], qa[kk + 1], r[2], r[3]);
        }
      }

      // scale, mask, online softmax (rows g and g + 8)
      float m_cur[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          float x = s[n][e] * scale_log2;
          if (col >= nvalid) x = NEG_INF;
          s[n][e] = x;
          m_cur[e >> 1] = fmaxf(m_cur[e >> 1], x);
        }
      }
      float alpha[2], m_safe[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        m_cur[hr] = fmaxf(m_cur[hr], __shfl_xor_sync(0xffffffffu, m_cur[hr], 1));
        m_cur[hr] = fmaxf(m_cur[hr], __shfl_xor_sync(0xffffffffu, m_cur[hr], 2));
        const float m_new = fmaxf(m_run[hr], m_cur[hr]);
        m_safe[hr] = (m_new <= NEG_INF) ? 0.f : m_new;
        alpha[hr] = exp2f(m_run[hr] - m_safe[hr]);
        m_run[hr] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - m_safe[e >> 1]);
          s[n][e] = p;
          psum[e >> 1] += p;
        }
      }
      l_part[0] = l_part[0] * alpha[0] + psum[0];
      l_part[1] = l_part[1] * alpha[1] + psum[1];
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        oacc[n][0] *= alpha[0];
        oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1];
        oacc[n][3] *= alpha[1];
      }

      // O += P V, with P rounded to bf16 (the accumulator layout of S is the
      // A-operand layout of the next product)
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < NT_O; n += 2) {
          uint32_t r[4];
          ldsm_x4_trans(r, Vs + (kk * 16 + (mi & 1) * 8 + mr) * LDS + n * 8 + (mi >> 1) * 8);
          mma_bf16(oacc[n], pa, r[0], r[1]);
          mma_bf16(oacc[n + 1], pa, r[2], r[3]);
        }
      }
    }
  }

  // normalise and write
  float l[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float x = quad_sum(l_part[hr]);
    l[hr] = (x == 0.f) ? 1.f : x;
    if (lse != nullptr && t == 0 && row_ok[hr])
      lse[bh * Sq + row0 + g + 8 * hr] = (x == 0.f) ? 1e30f : m_run[hr] + log2f(x);
  }
  __nv_bfloat16* op = out + (bh * Sq + row0) * D;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * t;
    if (row_ok[0])
      *reinterpret_cast<uint32_t*>(op + g * D + c) =
          pack_bf16(oacc[n][0] / l[0], oacc[n][1] / l[0]);
    if (row_ok[1])
      *reinterpret_cast<uint32_t*>(op + (g + 8) * D + c) =
          pack_bf16(oacc[n][2] / l[1], oacc[n][3] / l[1]);
  }
}

template <int D>
cudaError_t launch(int warps, dim3 grid, cudaStream_t stream, const __nv_bfloat16* q,
                   const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* out,
                   float* lse, const int* kv_index, const int* kv_count, int H, int Sq, int Skv,
                   int nq, int width, int shared_tab, int block_q, int block_kv, int last_block,
                   int valid_in_block, float scale_log2) {
  if (warps == 4)
    flash_fwd_kernel<D, 4><<<grid, 128, 0, stream>>>(q, k, v, out, lse, kv_index, kv_count, H, Sq,
                                                     Skv, nq, width, shared_tab, block_q, block_kv,
                                                     last_block, valid_in_block, scale_log2);
  else if (warps == 2)
    flash_fwd_kernel<D, 2><<<grid, 64, 0, stream>>>(q, k, v, out, lse, kv_index, kv_count, H, Sq,
                                                    Skv, nq, width, shared_tab, block_q, block_kv,
                                                    last_block, valid_in_block, scale_log2);
  else
    flash_fwd_kernel<D, 1><<<grid, 32, 0, stream>>>(q, k, v, out, lse, kv_index, kv_count, H, Sq,
                                                    Skv, nq, width, shared_tab, block_q, block_kv,
                                                    last_block, valid_in_block, scale_log2);
  return cudaGetLastError();
}


// The Hopper path (csrc/attn_sm90.cuh) with the online softmax and the lse.
__global__ void __launch_bounds__(sm90::THREADS, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ sm90::Params p) {
  sm90::attn_mainloop<sm90::Softmax::Online>(tq, tk, tv, p);
}

// Test-only probe of the Hopper path's pieces on one 128 x 128 tile (one
// CTA, the mainloop's warp roles, TMA loads and descriptors): S = Q K^T in
// f32 from the shared-memory product, and O = bf16(S) V from the register-A
// product with V MN-major.
__global__ void __launch_bounds__(sm90::THREADS, 1)
sm90_probe_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, float* s_out, float* o_out) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_smem = base, k_smem = base + Q_BYTES, v_smem = base + Q_BYTES + KV_BYTES;
  const uint32_t bar = base + BAR_OFF;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = tid / 128;
  if (wg == CONSUMERS) {
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      mbar_expect_tx(bar, Q_BYTES + STAGE_BYTES);
      for (int c = 0; c < 2; ++c) {
        tma_load(q_smem + c * BM * ROW_BYTES, &tq, bar, 64 * c, 0);
        tma_load(k_smem + c * BN * ROW_BYTES, &tk, bar, 64 * c, 0);
        tma_load(v_smem + c * BN * ROW_BYTES, &tv, bar, 64 * c, 0);
      }
    }
    return;
  }
  setmaxnreg_inc<232>();
  const int lane = tid % 32, warp = (tid % 128) / 32, g = lane / 4, t = lane % 4;
  mbar_wait(bar, 0);
  float s[64], o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128(s, kmajor_desc(q_smem, BM, wg * 64, kk), kmajor_desc(k_smem, BN, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  uint32_t pa[32];
  pack_p(pa, s);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_n128(o, &pa[4 * kk], vmajor_desc(v_smem, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = wg * 64 + warp * 16 + g + 8 * ((i >> 1) & 1);
    const int col = 8 * (i / 4) + 2 * t + (i & 1);
    s_out[row * 128 + col] = s[i];
    o_out[row * 128 + col] = o[i];
  }
}

}  // namespace

// q, k, v, out: contiguous (B, H, S, D) bf16; lse: (B, H, Sq) f32 or null.
// kv_index (h_tab, nq, width), kv_count (h_tab, nq): int32 on the device.
// hopper: the wrapper's shape rule chose the Hopper path (D = 128, block_q and
// block_kv multiples of 128; anything else there is an error, never a
// fallback).  Returns the CUDA error code.
extern "C" int vorta_flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                    void* lse, const void* kv_index, const void* kv_count, int B,
                                    int H, int Sq, int Skv, int D, int h_tab, int nq, int width,
                                    int block_q, int block_kv, int kv_valid_len,
                                    float scale_log2, int hopper, void* stream) {
  if (Sq % block_q || Skv % block_kv || block_q % 8 || block_kv % 8 || (D != 64 && D != 128) ||
      (h_tab != 1 && h_tab != H) || nq != Sq / block_q)
    return static_cast<int>(cudaErrorInvalidValue);
  // the tail mask applies to block kv_valid_len // block_kv only, as on the TPU
  const int has_tail = kv_valid_len % block_kv != 0;
  const int last_block = has_tail ? kv_valid_len / block_kv : -1;
  const int valid_in_block = kv_valid_len % block_kv;
  auto st = static_cast<cudaStream_t>(stream);
  if (hopper) {  // the wrapper's rule picked the Hopper path: its shapes or an error
    if (D != sm90::D) return static_cast<int>(cudaErrorInvalidValue);
    const sm90::Params p{static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
                         static_cast<const int*>(kv_index), static_cast<const int*>(kv_count),
                         nullptr, H, Sq, Skv, nq, width, h_tab == 1, h_tab == 1, block_q,
                         block_kv, last_block, valid_in_block, scale_log2, nullptr};
    return static_cast<int>(sm90::launch(flash_sm90_kernel, q, k, v, B, p, st));
  }
  const int warps = warps_for(block_q);
  dim3 grid(nq * ((block_q + 16 * warps - 1) / (16 * warps)), H, B);
  auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* kk = static_cast<const __nv_bfloat16*>(k);
  auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  auto* ls = static_cast<float*>(lse);
  auto* ki = static_cast<const int*>(kv_index);
  auto* kc = static_cast<const int*>(kv_count);
  cudaError_t err;
  if (D == 128)
    err = launch<128>(warps, grid, st, qq, kk, vv, oo, ls, ki, kc, H, Sq, Skv, nq, width,
                      h_tab == 1, block_q, block_kv, last_block, valid_in_block, scale_log2);
  else
    err = launch<64>(warps, grid, st, qq, kk, vv, oo, ls, ki, kc, H, Sq, Skv, nq, width,
                     h_tab == 1, block_q, block_kv, last_block, valid_in_block, scale_log2);
  return static_cast<int>(err);
}

// Test-only: the Hopper path's probe on one (128, 128) bf16 tile each of q,
// k, v (contiguous, 16-byte aligned); s, o: (128, 128) f32.
extern "C" int vorta_attn_sm90_probe(const void* q, const void* k, const void* v, void* s,
                                     void* o, void* stream) {
  using namespace vorta::sm90;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, BM, BM) || !make_map(&tk, k, BN, BN) || !make_map(&tv, v, BN, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(sm90_probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  sm90_probe_kernel<<<1, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<float*>(s), static_cast<float*>(o));
  return static_cast<int>(cudaGetLastError());
}

// The Hopper path's dynamic shared memory per CTA, in bytes (for reports).
extern "C" int vorta_attn_sm90_smem_bytes() { return vorta::sm90::SMEM_BYTES; }

// ---- the f32 mode: csrc/attn_f32.cuh's FFMA core over the block tables, and
// csrc/attn_f32_tc.cuh's tensor-core core where ops/flash.py:flash_f32_tc_path
// holds

namespace {

template <int D>
__global__ void __launch_bounds__(vorta::f32::THREADS, 2)
flash_f32_kernel(const float* __restrict__ q, float* __restrict__ out, float* __restrict__ lse,
                 const __grid_constant__ vorta::f32::TableParams p, float scale_log2) {
  const vorta::f32::TableWalk<false> walk(p);
  vorta::f32::attend<D>(walk, q, out, scale_log2, true, lse);
}

// The tensor-core f32 core (csrc/attn_f32_tc.cuh: 3xTF32 on wgmma), D = 128.
__global__ void __launch_bounds__(vorta::f32tc::THREADS, 1)
flash_f32_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ vorta::f32::TableParams p, float* __restrict__ out,
                    float* __restrict__ lse, float scale_log2) {
  vorta::f32tc::attend(tq, tk, tv, p, out, lse, scale_log2, true);
}

// Test-only: one 64-row tile's two products on the tensor-core core's pieces,
// one warpgroup, from the split pre-pass's halves (w: q's, k's, then V^T's,
// 64 keys) copied into the swizzled tiles: s = q k^T, o = s v, each 3xTF32
// with P from the S registers against V^T's permuted keys.
__global__ void __launch_bounds__(128)
f32_tc_probe_kernel(const uint4* __restrict__ w, float* __restrict__ s_out,
                    float* __restrict__ o_out) {
  using namespace vorta::f32tc;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = vorta::sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x, wp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  constexpr int C = BQ * D / 4;  // 16-byte chunks of a tile
  for (int e = tid; e < C; e += 128) {
    const int r = e / 32, c = e % 32, d = e / 16, ck = e % 16;
    *reinterpret_cast<uint4*>(smem + QB + kmajor_off(BQ, r, c)) = w[e];
    *reinterpret_cast<uint4*>(smem + QS + kmajor_off(BQ, r, c)) = w[C + e];
    *reinterpret_cast<uint4*>(smem + KB + kmajor_off(BK, r, c)) = w[2 * C + e];
    *reinterpret_cast<uint4*>(smem + KS + kmajor_off(BK, r, c)) = w[3 * C + e];
    *reinterpret_cast<uint4*>(smem + VB + kmajor_off(D, d, ck)) = w[4 * C + e];
    *reinterpret_cast<uint4*>(smem + VS + kmajor_off(D, d, ck)) = w[5 * C + e];
  }
  vorta::sm90::fence_proxy_async();
  __syncthreads();
  float s[32], o[64];
  qk_product(s, base);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s_out[(16 * wp + g + 8 * ((i >> 1) & 1)) * BK + 8 * (i / 4) + 2 * t + (i & 1)] = s[i];
  uint32_t pb[32], ps[32];
  split_p(s, pb, ps);
  pv_product(o, pb, ps, base + VB, base + VS);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    o_out[(16 * wp + g + 8 * ((i >> 1) & 1)) * D + 8 * (i / 4) + 2 * t + (i & 1)] = o[i];
}

}  // namespace

// The f32 mode (flash.py's kernel at f32 inputs): q, k, v, out contiguous
// (B, H, S, D) f32, q not pre-scaled; the tables and the tail rule as for
// vorta_flash_fwd_bf16; block_q and block_kv multiples of 8, D 64 or 128.
// lse: (B, H, Sq) f32 or null, as for vorta_flash_fwd_bf16 (the f32
// training path's forward).  The stable online softmax, P kept in f32.
// work: null, or where the wrapper's rule (ops/flash.py:flash_f32_tc_path)
// chose the tensor-core core (D = 128, blocks multiples of 8: the STA tiles
// too; anything else there is an error, never a fallback), scratch for the
// split halves of q, k and V^T: 2 B H (Sq + 2 Skv) 128 f32, 16-byte
// aligned; null: the FFMA core.  Returns the CUDA error code.
extern "C" int vorta_flash_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                   void* lse, const void* kv_index, const void* kv_count, int B,
                                   int H, int Sq, int Skv, int D, int h_tab, int nq, int width,
                                   int block_q, int block_kv, int kv_valid_len, float scale_log2,
                                   void* work, void* stream) {
  if (Sq % block_q || Skv % block_kv || block_q % 8 || block_kv % 8 ||
      (D != 64 && D != 128) || (h_tab != 1 && h_tab != H) || nq != Sq / block_q)
    return static_cast<int>(cudaErrorInvalidValue);
  const int has_tail = kv_valid_len % block_kv != 0;
  const vorta::f32::TableParams p{
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(kv_index), static_cast<const int*>(kv_count), nullptr, nullptr,
      nullptr, H, Sq, Skv, D, nq, width, h_tab == 1, h_tab == 1, block_q, block_kv,
      has_tail ? kv_valid_len / block_kv : -1, kv_valid_len % block_kv, 1, 1};
  auto st = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const float*>(q);
  auto* oo = static_cast<float*>(out);
  auto* ls = static_cast<float*>(lse);
  if (work != nullptr)
    return static_cast<int>(vorta::f32tc::launch(vorta::f32tc::flash_path_holds,
                                                 flash_f32_tc_kernel, q, k, v, work, B, p, st, p,
                                                 oo, ls, scale_log2));
  const dim3 grid = vorta::f32::table_grid(B, p);
  return static_cast<int>(
      D == 128
          ? vorta::f32::launch<128>(flash_f32_kernel<128>, grid, st, qq, oo, ls, p, scale_log2)
          : vorta::f32::launch<64>(flash_f32_kernel<64>, grid, st, qq, oo, ls, p, scale_log2));
}

// Test-only: the tensor-core f32 core's probe on one (64, 128) f32 tile each
// of q, k, v (contiguous, 16-byte aligned); work: 6 x 64 x 128 f32 for the
// split halves; s: (64, 64), o: (64, 128) f32.
extern "C" int vorta_f32_tc_probe(const void* q, const void* k, const void* v, void* work,
                                  void* s, void* o, void* stream) {
  using namespace vorta::f32tc;
  auto st = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<float*>(work);
  constexpr long long n4 = BQ * D / 4;
  f32_tc_split_rows_kernel<<<8, 256, 0, st>>>(static_cast<const float4*>(q),
                                              reinterpret_cast<uint4*>(w), n4);
  f32_tc_split_rows_kernel<<<8, 256, 0, st>>>(static_cast<const float4*>(k),
                                              reinterpret_cast<uint4*>(w + 2 * BQ * D), n4);
  f32_tc_split_t_kernel<<<dim3(1, 1), 256, 0, st>>>(static_cast<const float*>(v),
                                                    reinterpret_cast<uint32_t*>(w + 4 * BQ * D),
                                                    1, BK, BK, -1, 0);
  cudaError_t err = cudaFuncSetAttribute(f32_tc_probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  f32_tc_probe_kernel<<<1, 128, SMEM_BYTES, st>>>(
      reinterpret_cast<const uint4*>(w), static_cast<float*>(s), static_cast<float*>(o));
  return static_cast<int>(cudaGetLastError());
}
