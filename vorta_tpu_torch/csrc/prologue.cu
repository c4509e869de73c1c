// Fused attention prologue: qk-RMSNorm + gain + contiguous-half RoPE + head
// split, one pass over q/k/v.
//
// Replaces vorta_tpu/ops/prologue.py:_prologue_kernel (reached through
// fused_qk_prologue).  Same function: RMS of q and k in f32 over the whole
// row (norm_scope "row", Wan) or per head ("head"), times the gain, ROUNDED
// through the input dtype and back to f32 (what makes it bit-compatible with
// the unfused path), then the rotation of the contiguous halves of each head
// with cos/sin (S, d/2) f32, written head-major (B, H, S, d); v is only
// transposed.  bf16 inputs (the model in bf16) or f32 (the f32 serving
// path: the tiny models, `--dtype fp32`): the same kernels instantiated on
// the element type, where rounding through f32 is the identity.
// Input rows may be strided, so the three column slices of the fused qkv
// product are read in place, without a copy.  The TPU gates (S % 16, d %
// 128) were VMEM layout limits and do not apply.
//
// Bound on this card: one read of q/k/v and of the row's cos/sin and one
// write of the three head-major outputs, so memory bandwidth bounds it
// (1,364 MB at Wan-1.3B 720p x 77f: 0.407 ms at 3.35 TB/s).  Two kernels,
// chosen per call by the wrapper's rule on (dim, heads)
// (ops/prologue.py:prologue_layout, mirrored by the C entry):
//
// - prologue_rows_kernel<CH, WPR, T>, where d = 128 and dim = 32 * E * WPR
//   * CH with CH <= 6, E = 16 / sizeof(T) the elements of a 16-byte chunk
//   (8 bf16 or 4 f32; every served width: 1,536, 3,072, 5,120): WPR warps a
//   row.  In bf16 (E = 8):  Lane l of warp w holds, for each of its CH chunks c, the 8
//   columns from 8 * ((c * WPR + w) * 32 + l), one 16-byte load each of q,
//   k and v; one head is then 16 lanes of one chunk, its sum of squares a
//   4-step shuffle (head scope), the row's a 5-step shuffle over the summed
//   chunks (and, for WPR > 1, the warps' sums through shared memory behind
//   a named barrier of the row's warps).  The rotation partner of column j
//   < 64 of a head is column j + 64, in lane l ^ 8 of the same chunk: one
//   shuffle per packed bf16 pair.  The lane's cos / sin (columns (l & 7) *
//   8 .. + 7) are two 16-byte loads each per row, shared by every head and
//   by q and k; the gains are staged once per CTA in shared memory as f32.
//   A head's output row is 256 contiguous bytes, one 16-byte store per
//   lane; v goes from its load registers to its store.  Each warp walks
//   rows gridDim.x * (8 / WPR) apart and issues the next row's q / k / v
//   loads before it computes and stores the current one, so a row's bytes
//   are in flight while the previous row is written.
// - prologue_kernel, for every other even d (the tiny test models, odd head
//   counts): one block per token row; q and k rows are read once into
//   shared memory as f32, per-head sums of squares come from one warp per
//   head, and each thread writes contiguous runs of a head's output row.
//
// In f32 (E = 4) the same design with a head across a whole warp chunk
// (32 lanes of 4 columns), its rotation partner in lane l ^ 16, and twice
// the warps a row, so a lane holds as many bytes as in bf16.
//
// Both round alike: (x * r) * g with __fmul_rn, rounded to bf16 and back;
// the rotation with separate __fmul_rn and __fsub_rn / __fadd_rn (no FMA
// contraction); rsqrt(sum / dim + eps).  Only the order of the sum of
// squares differs, so the two agree to one bf16 ulp.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_HEADS = 64;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// x rounded through the element type (the identity in f32)
template <typename T> __device__ __forceinline__ float round_through(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
prologue_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                long long q_row, long long k_row, long long v_row, const float* __restrict__ gq,
                const float* __restrict__ gk, const float* __restrict__ cosv,
                const float* __restrict__ sinv, T* __restrict__ qo, T* __restrict__ ko,
                T* __restrict__ vo, int S, int H, int d, int qk_norm, int head_scope, float eps) {
  extern __shared__ float sm[];  // [2][H * d]: q row, k row
  __shared__ float ss[2][MAX_HEADS];
  __shared__ float fac[2][MAX_HEADS];
  const int D = H * d;
  const int half = d / 2;
  const size_t r = blockIdx.x;
  const int b = static_cast<int>(r / S), s = static_cast<int>(r % S);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xq = sm;
  float* xk = sm + D;
  const T* qr = q + r * q_row;
  const T* kr = k + r * k_row;
  const T* vr = v + r * v_row;

  for (int i = threadIdx.x; i < D; i += THREADS) {
    xq[i] = to_f32(qr[i]);
    xk[i] = to_f32(kr[i]);
  }
  __syncthreads();

  if (qk_norm) {
    for (int h = warp; h < H; h += THREADS / 32) {
      float aq = 0.f, ak = 0.f;
      for (int j = lane; j < d; j += 32) {
        const float a = xq[h * d + j], c = xk[h * d + j];
        aq += a * a;
        ak += c * c;
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2) {
        aq += __shfl_xor_sync(0xffffffffu, aq, o);
        ak += __shfl_xor_sync(0xffffffffu, ak, o);
      }
      if (lane == 0) {
        ss[0][h] = aq;
        ss[1][h] = ak;
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * H) {
      const int which = threadIdx.x / H, h = threadIdx.x % H;
      float f;
      if (head_scope) {
        f = rsqrtf(ss[which][h] / d + eps);
      } else {
        float tot = 0.f;
        for (int hh = 0; hh < H; ++hh) tot += ss[which][hh];
        f = rsqrtf(tot / D + eps);
      }
      fac[which][h] = f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < D; i += THREADS) {
      const int h = i / d;
      // (x * r) * g, rounded through the input dtype as the unfused path does
      xq[i] = round_through<T>(__fmul_rn(__fmul_rn(xq[i], fac[0][h]), gq[i]));
      xk[i] = round_through<T>(__fmul_rn(__fmul_rn(xk[i], fac[1][h]), gk[i]));
    }
    __syncthreads();
  }

  const float* cr = cosv + static_cast<size_t>(s) * half;
  const float* sr = sinv + static_cast<size_t>(s) * half;
  for (int e = threadIdx.x; e < D; e += THREADS) {
    const int h = e / d, j = e % d;
    const int jj = j < half ? j : j - half;
    const int base = h * d;
    const float c = cr[jj], sn = sr[jj];
    const float q1 = xq[base + jj], q2 = xq[base + jj + half];
    const float k1 = xk[base + jj], k2 = xk[base + jj + half];
    float oq, ok;
    if (j < half) {
      oq = __fsub_rn(__fmul_rn(q1, c), __fmul_rn(q2, sn));
      ok = __fsub_rn(__fmul_rn(k1, c), __fmul_rn(k2, sn));
    } else {
      oq = __fadd_rn(__fmul_rn(q1, sn), __fmul_rn(q2, c));
      ok = __fadd_rn(__fmul_rn(k1, sn), __fmul_rn(k2, c));
    }
    const size_t o = ((static_cast<size_t>(b) * H + h) * S + s) * d + j;
    qo[o] = from_f32<T>(oq);
    ko[o] = from_f32<T>(ok);
    vo[o] = vr[e];
  }
}

// ---- the warp-per-row kernel ------------------------------------------------

constexpr int HD = 128;        // its head dim
constexpr int ROW_CHUNKS = 6;  // 16-byte chunks a lane holds at most (ops/prologue.py)

// Its arguments: the C entry's, rows = B * S.
template <typename T>
struct Rows {
  const T *q, *k, *v;
  long long q_row, k_row, v_row;
  const float *gq, *gk, *cosv, *sinv;
  T *qo, *ko, *vo;
  long long rows;
  int S, qk_norm, head_scope;
  float eps;
};

// A 16-byte chunk of a row, read once: not kept in L1.
__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 u;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "l"(p));
  return u;
}

// The E = 16 / sizeof(T) elements of a 16-byte chunk (four 32-bit words) as
// f32, and back.
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint32_t (&w)[4], float (&f)[E]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static uint4 pack(const float (&f)[E]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};
template <> struct Chunk<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint32_t (&w)[4], float (&f)[E]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  }
  __device__ static uint4 pack(const float (&f)[E]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <typename T>
__device__ __forceinline__ float sum_of_squares(const uint4& u) {
  constexpr int E = Chunk<T>::E;
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float x[E];
  Chunk<T>::unpack(w, x);
  float a = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) a += x[e] * x[e];
  return a;
}

// One chunk of q or k, its E columns (l % (HD / E)) * E.. of a head:
// normalised by f (head_scope: by its head's, from the HD / E lanes of the
// head), times the gains g (E f32 in shared memory) and rounded through T,
// then rotated against the partner columns in lane l ^ (HD / 2 / E) (lo: the
// head's first half, x1 * cos - x2 * sin; else x1 * sin + x2 * cos).
template <typename T>
__device__ __forceinline__ uint4 rotate_chunk(const uint4& u, float f, const Rows<T>& a,
                                              const float* g, const float (&cs)[Chunk<T>::E],
                                              const float (&sn)[Chunk<T>::E], bool lo) {
  constexpr int E = Chunk<T>::E;
  uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float x[E];
  Chunk<T>::unpack(w, x);
  if (a.qk_norm) {
    if (a.head_scope) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s += x[e] * x[e];
#pragma unroll
      for (int o = 1; o < HD / E; o *= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
      f = rsqrtf(s / HD + a.eps);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = round_through<T>(__fmul_rn(__fmul_rn(x[e], f), g[e]));
    const uint4 p = Chunk<T>::pack(x);
    w[0] = p.x, w[1] = p.y, w[2] = p.z, w[3] = p.w;
  }
  // the values are T whether normalised or not: the partner's move packed
  uint32_t pw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pw[i] = __shfl_xor_sync(0xffffffffu, w[i], HD / 2 / E);
  float xp[E];
  Chunk<T>::unpack(pw, xp);
  float o[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float own = __fmul_rn(x[e], cs[e]), other = __fmul_rn(xp[e], sn[e]);
    o[e] = lo ? __fsub_rn(own, other) : __fadd_rn(other, own);
  }
  return Chunk<T>::pack(o);
}

template <int E>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[E]) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p) + i);
    f[4 * i] = a.x, f[4 * i + 1] = a.y, f[4 * i + 2] = a.z, f[4 * i + 3] = a.w;
  }
}

// Rows of dim = 32 * E * WPR * CH, d = 128: WPR warps a row, 8 / WPR rows a
// block at a time; lane l of warp w holds the chunks (c * WPR + w) * 32 + l
// of E columns, c < CH.  Each row group walks rows gridDim.x * (8 / WPR)
// apart, the next row's q / k / v and cos / sin loaded before the current
// row is computed and stored.
template <int CH, int WPR, typename T>
__global__ void __launch_bounds__(THREADS, 1) prologue_rows_kernel(const Rows<T> a) {
  constexpr int E = Chunk<T>::E;
  constexpr int DIM = 32 * E * WPR * CH;
  constexpr int H = DIM / HD;
  constexpr int GROUPS = THREADS / 32 / WPR;
  constexpr int HL = HD / E;  // lanes of a head
  extern __shared__ float4 gains[];  // [2][DIM / 4]: q's gains, then k's (qk_norm)
  __shared__ float red[2][2][THREADS / 32];  // [row parity][q, k][warp] (WPR > 1)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / WPR, wir = warp % WPR;
  if (a.qk_norm) {
    for (int i = threadIdx.x; i < DIM / 4; i += THREADS) {
      gains[i] = reinterpret_cast<const float4*>(a.gq)[i];
      gains[DIM / 4 + i] = reinterpret_cast<const float4*>(a.gk)[i];
    }
    __syncthreads();
  }
  const float* sg = reinterpret_cast<const float*>(gains);
  const long long step = static_cast<long long>(gridDim.x) * GROUPS;
  long long r = static_cast<long long>(blockIdx.x) * GROUPS + grp;
  if (r >= a.rows) return;  // the whole row group together

  auto col = [&](int c) { return E * ((c * WPR + wir) * 32 + lane); };
  const int cs0 = (lane % (HL / 2)) * E;  // this lane's columns of cos / sin
  uint4 nq[CH], nk[CH], nv[CH];
  float ncs[E], nsn[E];
  auto load_row = [&](long long rr) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      nq[c] = load_stream(a.q + rr * a.q_row + col(c));
      nk[c] = load_stream(a.k + rr * a.k_row + col(c));
      nv[c] = load_stream(a.v + rr * a.v_row + col(c));
    }
    const size_t t = static_cast<size_t>(rr % a.S) * (HD / 2) + cs0;
    load_f32<E>(a.cosv + t, ncs);
    load_f32<E>(a.sinv + t, nsn);
  };
  load_row(r);
  const bool lo = (lane & (HL / 2)) == 0;
  for (int parity = 0;; parity ^= 1) {
    const int b = static_cast<int>(r / a.S), s = static_cast<int>(r % a.S);
    auto out = [&](int c) {  // this lane's E columns of its head's output row
      const int h = (c * WPR + wir) * (32 / HL) + lane / HL;
      return ((static_cast<size_t>(b) * H + h) * a.S + s) * HD + (lane % HL) * E;
    };
    uint4 xq[CH], xk[CH];
    float cs[E], sn[E];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      xq[c] = nq[c];
      xk[c] = nk[c];
      *reinterpret_cast<uint4*>(a.vo + out(c)) = nv[c];  // v only moves
    }
#pragma unroll
    for (int e = 0; e < E; ++e) cs[e] = ncs[e], sn[e] = nsn[e];
    const long long rn = r + step;
    if (rn < a.rows) load_row(rn);

    float fq = 1.f, fk = 1.f;
    if (a.qk_norm && !a.head_scope) {  // the row's RMS: chunks, then lanes, then warps
      float sq = 0.f, sk = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        sq += sum_of_squares<T>(xq[c]);
        sk += sum_of_squares<T>(xk[c]);
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2) {
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
        sk += __shfl_xor_sync(0xffffffffu, sk, o);
      }
      if constexpr (WPR > 1) {
        float* rq = &red[parity][0][grp * WPR];
        float* rk = &red[parity][1][grp * WPR];
        if (lane == 0) rq[wir] = sq, rk[wir] = sk;
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(32 * WPR) : "memory");
        sq = sk = 0.f;
#pragma unroll
        for (int w = 0; w < WPR; ++w) sq += rq[w], sk += rk[w];
      }
      fq = rsqrtf(sq / DIM + a.eps);
      fk = rsqrtf(sk / DIM + a.eps);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const size_t o = out(c);
      *reinterpret_cast<uint4*>(a.qo + o) = rotate_chunk<T>(xq[c], fq, a, sg + col(c), cs, sn, lo);
      *reinterpret_cast<uint4*>(a.ko + o) =
          rotate_chunk<T>(xk[c], fk, a, sg + DIM + col(c), cs, sn, lo);
    }
    r = rn;
    if (r >= a.rows) break;
  }
}

// The warp-per-row kernel's layout for dim = heads * d: (warps a row, chunks
// a lane), the fewest warps (1, 2 or 4; in f32 also 8) with at most
// ROW_CHUNKS chunks of 16 bytes a lane; {0, 0} where d != 128 or dim is not
// 32 * E * WPR * CH (ops/prologue.py:prologue_layout, the same rule).
struct Layout {
  int wpr, ch;
};
Layout prologue_layout(int H, int d, bool f32) {
  const int dim = H * d, lane_cols = f32 ? 128 : 256;
  if (d != HD || dim % lane_cols) return {0, 0};
  const int chunks = dim / lane_cols;
  for (int wpr = 1; wpr <= (f32 ? 8 : 4); wpr *= 2)
    if (chunks % wpr == 0 && chunks / wpr <= ROW_CHUNKS) return {wpr, chunks / wpr};
  return {0, 0};
}

template <int CH, int WPR, typename T>
cudaError_t launch_rows(const Rows<T>& a, cudaStream_t st) {
  constexpr int GROUPS = THREADS / 32 / WPR;
  constexpr int SMEM = 2 * 32 * Chunk<T>::E * WPR * CH * static_cast<int>(sizeof(float));
  auto kern = prologue_rows_kernel<CH, WPR, T>;
  // resident blocks a multiprocessor, at the largest shared memory: the
  // grid fills the card once, each row group walking its rows
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, SMEM);
    if (err != cudaSuccess || per_sm < 1) {
      per_sm = 0;
      return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
    }
  }
  const long long groups = (a.rows + GROUPS - 1) / GROUPS;
  const long long grid = groups < static_cast<long long>(sms) * per_sm
                             ? groups : static_cast<long long>(sms) * per_sm;
  kern<<<static_cast<unsigned>(grid), THREADS, a.qk_norm ? SMEM : 0, st>>>(a);
  return cudaGetLastError();
}

// CH runs over 1..ROW_CHUNKS for one warp a row, 4..ROW_CHUNKS for more
// (fewer chunks would have taken fewer warps).
template <int WPR, int CH, typename T>
cudaError_t launch_ch(int ch, const Rows<T>& a, cudaStream_t st) {
  if (ch == CH) return launch_rows<CH, WPR, T>(a, st);
  if constexpr (CH < ROW_CHUNKS)
    return launch_ch<WPR, CH + 1, T>(ch, a, st);
  else
    return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run_prologue(const void* q, const void* k, const void* v, long long q_row,
                         long long k_row, long long v_row, const void* gq, const void* gk,
                         const void* cosv, const void* sinv, void* qo, void* ko, void* vo,
                         int B, int S, int H, int d, int qk_norm, int head_scope, float eps,
                         int wpr, cudaStream_t st) {
  const size_t rows = static_cast<size_t>(B) * S;
  if (wpr) {
    const Layout lay = prologue_layout(H, d, sizeof(T) == 4);
    const long long row_align = 16 / sizeof(T);
    auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
    if (wpr != lay.wpr || q_row % row_align || k_row % row_align || v_row % row_align ||
        misaligned(q) || misaligned(k) || misaligned(v) || misaligned(cosv) ||
        misaligned(sinv) || misaligned(qo) || misaligned(ko) || misaligned(vo) ||
        (qk_norm && (misaligned(gq) || misaligned(gk))))
      return cudaErrorInvalidValue;
    if (rows == 0) return cudaSuccess;
    const Rows<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                    q_row, k_row, v_row, static_cast<const float*>(gq),
                    static_cast<const float*>(gk), static_cast<const float*>(cosv),
                    static_cast<const float*>(sinv), static_cast<T*>(qo), static_cast<T*>(ko),
                    static_cast<T*>(vo), static_cast<long long>(rows), S, qk_norm, head_scope,
                    eps};
    switch (lay.wpr) {
      case 1: return launch_ch<1, 1, T>(lay.ch, a, st);
      case 2: return launch_ch<2, 4, T>(lay.ch, a, st);
      case 4: return launch_ch<4, 4, T>(lay.ch, a, st);
      default:
        if constexpr (sizeof(T) == 4) return launch_ch<8, 4, T>(lay.ch, a, st);
        return cudaErrorInvalidValue;
    }
  }
  if (rows == 0) return cudaSuccess;
  const size_t smem = 2 * static_cast<size_t>(H) * d * sizeof(float);
  prologue_kernel<T><<<rows, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_row, k_row,
      v_row, static_cast<const float*>(gq), static_cast<const float*>(gk),
      static_cast<const float*>(cosv), static_cast<const float*>(sinv), static_cast<T*>(qo),
      static_cast<T*>(ko), static_cast<T*>(vo), S, H, d, qk_norm, head_scope, eps);
  return cudaGetLastError();
}

}  // namespace

// q/k/v: (B, S, H*d) with unit column stride and row strides q_row/k_row/v_row
// (elements); gq/gk: (H*d,) f32 (read only when qk_norm); cos/sin: (S, d/2)
// f32; qo/ko/vo: contiguous (B, H, S, d).  q/k/v and the outputs bf16
// (x_f32: f32).  wpr: the wrapper's layout rule (ops/prologue.py:
// prologue_layout), 0 for the block-per-row kernel (any shape it takes);
// else it must agree with the C side's, and every pointer must be 16-byte
// aligned and every row stride a multiple of 16 bytes: anything else is an
// error, never a fallback.  Returns the CUDA error code.
extern "C" int vorta_qk_prologue(const void* q, const void* k, const void* v, long long q_row,
                                 long long k_row, long long v_row, const void* gq, const void* gk,
                                 const void* cosv, const void* sinv, void* qo, void* ko, void* vo,
                                 int B, int S, int H, int d, int qk_norm,
                                 int head_scope, float eps, int wpr, int x_f32, void* stream) {
  if (H <= 0 || H > MAX_HEADS || d <= 0 || d % 2 ||
      2 * static_cast<size_t>(H) * d * sizeof(float) > 48 * 1024 ||
      (qk_norm && (gq == nullptr || gk == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto launcher) {
    return static_cast<int>(launcher(q, k, v, q_row, k_row, v_row, gq, gk, cosv, sinv, qo, ko,
                                     vo, B, S, H, d, qk_norm, head_scope, eps, wpr, st));
  };
  return x_f32 ? run(run_prologue<float>) : run(run_prologue<__nv_bfloat16>);
}
