// The FFMA f32 attention core of the port's f32 paths, for Hopper (sm_90a):
// one online softmax over a sequence of kv chunks that the caller (a
// "walk") supplies, with true f32 products on the CUDA cores (FFMA).
//
// Its users and their walks: csrc/flash.cu and csrc/flash_manual.cu where
// the tensor-core core does not run (TableWalk below: the block tables, the
// kv tail rule, kv_bias, per-head counts; head dim 64, flash_manual's blocks
// 128 does not divide, in f32 or in its int8 QK mode, and the FFMA
// yardsticks; csrc/attn_f32_tc.cuh's 3xTF32 core runs flash at head dim 128
// (ops/flash.py:flash_f32_tc_path) and flash_manual at head dim 128 with
// blocks that are multiples of 128 (ops/flash.py:f32_tc_path), and
// csrc/attn_int8_tc.cuh its int8 QK mode there), csrc/sta_batched.cu (TableWalk
// plus the pair bits), and
// csrc/sta_pipe.cu, csrc/sta_window.cu and csrc/sta_row.cu (WindowWalk of
// csrc/window_walk_f32.cuh: the window box and the text tail).  They replace
// the f32 modes of vorta_tpu/ops/flash.py:_flash_kernel,
// flash_manual.py:_kernel, sta_batched.py:_kernel, sta_pipe.py:_kernel,
// sta_window.py:_kernel and sta_row.py:_kernel: the TPU kernels take their
// input dtype, and the JAX package runs the tiny models and `--dtype fp32`
// in f32 throughout.
//
// The int8 QK mode (I8; flash_manual.py:125-133 and sta_pipe.py:197 with an
// f32 v, the JAX CLI's `--qk_int8 --dtype fp32`): q and k arrive as int8
// (per-head symmetric quantization), q not pre-scaled.  Q and K are staged
// as int8 in shared memory, each row padded by 16 bytes (so the 16 key rows
// a thread group reads fall on distinct banks), and each score is D / 4
// __dp4a over 32-bit words: the int32 sum is exact, |sum| <= D * 127^2 <
// 2^24, so its conversion to f32 is exact too, and the caller's mul (the
// head's qk_scale * scale * log2(e)) multiplies it with no FMA, as the plain
// version's f32 product of the exact sums.  Bias, masks and the softmax
// follow unchanged; P, V and the PV product stay f32.
//
// Semantics, per query row and key: s = q.k * mul + bias, mul = scale *
// log2(e) where q arrives unscaled (flash, the stable softmax of
// flash_manual / sta_batched) and 1 where the wrapper pre-scaled q in f32
// (the fast softmax, sta_pipe); a key the walk masks (the tail rule, a
// pair bit, a key past its block) is -1e30.  Fast softmax: p = exp2(s), no
// running max.  Stable: a running max m with the TPU kernels' m_safe (0
// while every score so far is -1e30), p = exp2(s - m_safe), the sums
// rescaled by exp2(m_old - m_new).  P stays f32 for the PV product (the JAX
// kernels cast P to v's dtype, which is f32 here: flash.py:222).  A row
// whose l is 0 (no visible key, a count-0 q block, an inactive head) writes
// 0 and reads no v.  With an lse pointer (flash's training forward, stable
// softmax only) the core also writes each row's base-2 log-sum-exp in the
// scaled domain, m + log2(l) from the running max and sum it keeps, or the
// sentinel 1e30 where l is 0, so that the backward's exp2(s - lse) is 0
// there (vorta_tpu/ops/flash.py:237-241, the bf16 kernels' definition).
//
// Bound on this card: operations.  A 64-row q tile against a 64-key chunk
// is 2 * 64 * 64 * D FLOP for S and as many for PV over 2 * 64 * D * 4
// bytes of K and V, 32 FLOP a byte at any D: above the f32 ridge of 20 (67
// TFLOP/s over 3.35 TB/s), so the FFMA rate bounds it.  The design: a CTA
// of 256 threads owns 64 query rows (Q staged once in shared memory); per
// chunk the walk names each key's K / V rows and bias (64 threads, into
// shared memory), the K and V rows are gathered into shared memory with
// 16-byte loads, and thread (ty, tx) of the 16 x 16 grid computes the 4 x 4
// scores of rows ty + 16 i and keys tx + 16 j (float4 reads along D, rows
// padded by 4 floats so the 16 key rows of a warp fall on distinct banks),
// the row max / sum over the 16 lanes of its half-warp, then P is written
// over the K tile and the thread's 4 rows x D / 16 output columns take
// their PV products from float4 reads of P and V.  101 KB of shared memory
// at D = 128, so two CTAs share an SM.  The 3xTF32 split products on the
// tensor cores reach a higher rate (165 TFLOP/s f32-exact): the block-table
// walk at the served shapes runs there (csrc/attn_f32_tc.cuh); a single
// TF32 product is not an f32 mode.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vorta {
namespace f32 {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per chunk
constexpr int THREADS = 256;  // a 16 x 16 grid of (rows, keys) owners
constexpr float NEG = -1e30f;

template <int D>
struct Layout {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int LDQ = D + 4;   // Q and K tile rows (floats)
  static constexpr int LDQ8 = D + 16; // Q and K tile rows in the int8 mode (bytes)
  static constexpr int LDP = BK + 4;  // P tile rows, over K's
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LDQ;
  static constexpr int V = K + BK * LDQ;
  static constexpr int META = V + BK * D;  // then BK K pointers, BK V pointers, BK biases
  static constexpr int BYTES = META * 4 + BK * (2 * 8 + 4);
  static_assert(BQ * LDP <= BK * LDQ, "P fits over K");
  static_assert(BQ * LDQ8 <= BQ * LDQ * 4, "int8 Q and K fit their f32 tiles");
  static_assert(BK * D % (16 * THREADS) == 0, "whole 16-byte loads of an int8 K tile");
  static_assert((META * 4) % 16 == 0, "pointer table aligned");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ int4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// Row `row` of a (rows, D) tensor of kb-byte elements at base.
__device__ __forceinline__ const void* row_ptr(const void* base, long long row, int D, int kb) {
  return static_cast<const char*>(base) + row * D * kb;
}

// The core: Walk gives the CTA's rows and its chunks.
//   int rows()                      query rows of this CTA (0..BQ)
//   long long q_off(int r)          element offset of row r in q and out
//   int chunks()                    kv chunks (0 for an inactive head)
//   void key(int c, int j, const void*& kp, const float*& vp, float& bias)
//                                   key j < BK of chunk c: its K row (f32, or
//                                   int8 where I8) and V row (null: masked)
//                                   and bias
//   static constexpr bool PAIRS; bool visible(int c, int r, int j) (only where PAIRS)
//                                   per (row, key) visibility (pair bits)
// q: f32, or int8 where I8.  lse: null, or (rows of q) f32 written at
// q_off(r) / D (stable softmax only).
template <int D, class Walk, bool I8 = false>
__device__ __forceinline__ void attend(const Walk& walk, const void* __restrict__ q,
                                       float* __restrict__ out, float mul, bool stable,
                                       float* __restrict__ lse = nullptr) {
  using L = Layout<D>;
  constexpr int NG = D / 64;                 // float4 column groups a thread owns
  constexpr int KV_LOADS = BK * D / 4 / THREADS;
  constexpr int K8_LOADS = BK * D / 16 / THREADS;  // int8 K: 16-byte loads
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm + L::Q;
  float* Ks = sm + L::K;
  float* Vs = sm + L::V;
  float* Ps = Ks;
  char* Q8 = reinterpret_cast<char*>(Qs);
  char* K8 = reinterpret_cast<char*>(Ks);
  const void** kptr = reinterpret_cast<const void**>(sm + L::META);
  const float** vptr = reinterpret_cast<const float**>(kptr + BK);
  float* bias = reinterpret_cast<float*>(vptr + BK);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nrows = walk.rows();
  if constexpr (I8) {
    for (int e = tid; e < BQ * D / 16; e += THREADS) {
      const int r = e / (D / 16), c = (e % (D / 16)) * 16;
      const int4 x = r < nrows ? ld16(static_cast<const char*>(q) + walk.q_off(r) + c)
                               : make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(Q8 + r * L::LDQ8 + c) = x;
    }
  } else {
    for (int e = tid; e < BQ * D / 4; e += THREADS) {
      const int r = e / (D / 4), c = (e % (D / 4)) * 4;
      const float4 x = r < nrows ? ld4(static_cast<const float*>(q) + walk.q_off(r) + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(Qs + r * L::LDQ + c) = x;
    }
  }

  float o[4][4 * NG];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) o[i][c] = 0.f;
  }

  const int nchunks = walk.chunks();
  for (int ch = 0; ch < nchunks; ++ch) {
    __syncthreads();  // the previous chunk's P and V are consumed (and Q staged)
    if (tid < BK) {
      const void* kp;
      const float* vp;
      float b;
      walk.key(ch, tid, kp, vp, b);
      kptr[tid] = kp;
      vptr[tid] = vp;
      bias[tid] = b;
    }
    __syncthreads();
    {
      float4 kx[KV_LOADS], vx[KV_LOADS];
      int4 k8[K8_LOADS];
#pragma unroll
      for (int u = 0; u < KV_LOADS; ++u) {
        const int e = tid + u * THREADS, j = e / (D / 4), c = (e % (D / 4)) * 4;
        const float* vp = vptr[j];
        vx[u] = vp ? ld4(vp + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (!I8) {
          const float* kp = static_cast<const float*>(kptr[j]);
          kx[u] = kp ? ld4(kp + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      if constexpr (I8) {
#pragma unroll
        for (int u = 0; u < K8_LOADS; ++u) {
          const int e = tid + u * THREADS, j = e / (D / 16), c = (e % (D / 16)) * 16;
          const void* kp = kptr[j];
          k8[u] = kp ? ld16(static_cast<const char*>(kp) + c) : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < K8_LOADS; ++u) {
          const int e = tid + u * THREADS, j = e / (D / 16), c = (e % (D / 16)) * 16;
          *reinterpret_cast<int4*>(K8 + j * L::LDQ8 + c) = k8[u];
        }
      }
#pragma unroll
      for (int u = 0; u < KV_LOADS; ++u) {
        const int e = tid + u * THREADS, j = e / (D / 4), c = (e % (D / 4)) * 4;
        if constexpr (!I8) *reinterpret_cast<float4*>(Ks + j * L::LDQ + c) = kx[u];
        *reinterpret_cast<float4*>(Vs + j * D + c) = vx[u];
      }
    }
    __syncthreads();

    float s[4][4];
    if constexpr (I8) {
      int acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll 2
      for (int d = 0; d < D; d += 16) {
        int4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const int4*>(Q8 + (ty + 16 * i) * L::LDQ8 + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const int4*>(K8 + (tx + 16 * j) * L::LDQ8 + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int a = acc[i][j];
            a = __dp4a(qv[i].x, kv[j].x, a);
            a = __dp4a(qv[i].y, kv[j].y, a);
            a = __dp4a(qv[i].z, kv[j].z, a);
            a = __dp4a(qv[i].w, kv[j].w, a);
            acc[i][j] = a;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = static_cast<float>(acc[i][j]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * L::LDQ + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L::LDQ + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = s[i][j];
            a = fmaf(qv[i].x, kv[j].x, a);
            a = fmaf(qv[i].y, kv[j].y, a);
            a = fmaf(qv[i].z, kv[j].z, a);
            a = fmaf(qv[i].w, kv[j].w, a);
            s[i][j] = a;
          }
      }
    }

    // scores, the running max and the rescale of this thread's rows
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        bool ok = kptr[key] != nullptr;
        if constexpr (Walk::PAIRS) ok = ok && walk.visible(ch, r, key);
        // the int8 mode's product unfused: the plain version's f32 product of the exact sum
        const float x = ok ? (I8 ? __fmul_rn(s[i][j], mul) : s[i][j] * mul) + bias[key] : NEG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      float ms = 0.f;
      alpha[i] = 1.f;
      if (stable) {
#pragma unroll
        for (int off = 1; off < 16; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = m[i] <= NEG ? 0.f : exp2f(m[i] - m_new);  // l and o are 0 until then
        m[i] = m_new;
        ms = m_new <= NEG ? 0.f : m_new;
      }
      l[i] *= alpha[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - ms);  // exp2(-1e30 - ms) = 0
        s[i][j] = p;
        l[i] += p;
      }
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) o[i][c] *= alpha[i];
    }
    __syncthreads();  // every thread is done with K: P goes over it
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * L::LDP + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * L::LDP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          vv[g] = *reinterpret_cast<const float4*>(Vs + (kk + u) * D + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            o[i][4 * g + 0] = fmaf(p, vv[g].x, o[i][4 * g + 0]);
            o[i][4 * g + 1] = fmaf(p, vv[g].y, o[i][4 * g + 1]);
            o[i][4 * g + 2] = fmaf(p, vv[g].z, o[i][4 * g + 2]);
            o[i][4 * g + 3] = fmaf(p, vv[g].w, o[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off *= 2) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int r = ty + 16 * i;
    if (r >= nrows) continue;
    const float inv = li == 0.f ? 0.f : 1.f / li;
    // m[i] is the row's max (every lane of the half-warp holds it); l > 0
    // implies it is above -1e30, so it equals the TPU kernels' m_safe
    if (lse != nullptr && tx == 0) lse[walk.q_off(r) / D] = li == 0.f ? 1e30f : m[i] + log2f(li);
    float* orow = out + walk.q_off(r);
#pragma unroll
    for (int g = 0; g < NG; ++g)
      *reinterpret_cast<float4*>(orow + g * 64 + tx * 4) =
          make_float4(o[i][4 * g] * inv, o[i][4 * g + 1] * inv, o[i][4 * g + 2] * inv,
                      o[i][4 * g + 3] * inv);
  }
}

// The block-table walk of flash, flash_manual and sta_batched: q block qi's
// CTA part (64 rows of it) visits kv_index[th, qi, :kv_count[tc, qi]], each
// kv block in ceil(block_kv / 64) chunks; the tail rule masks columns
// valid_in_block.. of block last_block (-1: none, flash.py:202-207); kv_bias
// (Skv,) or null.  PAIRS: sta_batched's pair bits, bit (row // tpt) * k_sub
// + col // tpt of the entry's word (rows and columns within their blocks).
// kb: bytes of a K element (4, or 1 for int8 K).
struct TableParams {
  const void* k;
  const float* v;
  const int *kv_index, *kv_count, *pair_bits, *active;
  const float* kv_bias;
  int H, Sq, Skv, D, nq, width, idx_shared, cnt_shared, block_q, block_kv, last_block,
      valid_in_block, tpt, k_sub;
  int kb = 4;
};

template <bool PAIRS_>
struct TableWalk {
  static constexpr bool PAIRS = PAIRS_;
  const TableParams& p;  // a __grid_constant__ kernel parameter
  int qi, part, h, b, spb;
  long long bh;

  __device__ TableWalk(const TableParams& prm) : p(prm) {
    const int parts = (p.block_q + BQ - 1) / BQ;
    qi = blockIdx.x / parts;
    part = blockIdx.x % parts;
    h = blockIdx.y;
    b = blockIdx.z;
    spb = (p.block_kv + BK - 1) / BK;
    bh = static_cast<long long>(b) * p.H + h;
  }
  __device__ int rows() const { return min(BQ, p.block_q - part * BQ); }
  __device__ long long q_off(int r) const {
    return (bh * p.Sq + static_cast<long long>(qi) * p.block_q + part * BQ + r) * p.D;
  }
  __device__ int chunks() const {
    if (p.active && p.active[h] == 0) return 0;
    return p.kv_count[(p.cnt_shared ? 0 : h) * p.nq + qi] * spb;
  }
  __device__ int entry(int c) const {
    return ((p.idx_shared ? 0 : h) * p.nq + qi) * p.width + c / spb;
  }
  __device__ void key(int c, int j, const void*& kp, const float*& vp, float& bias) const {
    const int col = (c % spb) * BK + j;
    const int kvb = p.kv_index[entry(c)];
    kp = nullptr;
    vp = nullptr;
    bias = 0.f;
    if (col >= p.block_kv || (kvb == p.last_block && col >= p.valid_in_block)) return;
    const long long row = static_cast<long long>(kvb) * p.block_kv + col;
    kp = row_ptr(p.k, bh * p.Skv + row, p.D, p.kb);
    vp = p.v + (bh * p.Skv + row) * p.D;
    if (p.kv_bias) bias = p.kv_bias[row];
  }
  __device__ bool visible(int c, int r, int j) const {
    const unsigned word = static_cast<unsigned>(p.pair_bits[entry(c)]);
    const int bit = ((part * BQ + r) / p.tpt) * p.k_sub + ((c % spb) * BK + j) / p.tpt;
    return bit < 32 && ((word >> bit) & 1u);
  }
};

// Grid of a table walk: (nq * parts, H, B).
inline dim3 table_grid(int B, const TableParams& p) {
  return dim3(p.nq * ((p.block_q + BQ - 1) / BQ), p.H, B);
}

// Launch kern<<<grid, THREADS, Layout<D>::BYTES>>>(args...), raising the
// kernel's dynamic shared memory limit first; the CUDA error code.
template <int D, class Kern, class... Args>
cudaError_t launch(Kern kern, dim3 grid, cudaStream_t st, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::BYTES);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, Layout<D>::BYTES, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace f32
}  // namespace vorta
