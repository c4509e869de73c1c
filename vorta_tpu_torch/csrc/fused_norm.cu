// Fused LayerNorm / RMSNorm with optional affine and AdaLN modulation, and
// the residual update fused with the LayerNorm that follows it.
//
// Replaces vorta_tpu/ops/fused_norm.py:_kernel (reached through
// _norm_fwd_pallas and fused_norm): f32 statistics over the row, then
// optional gamma/beta, then optional norm(x) * (1 + scale[b]) + shift[b],
// written in x's dtype or in f32.  x is bf16 (the model in bf16) or f32 (the
// f32 serving path: the tiny models, `--dtype fp32`): the same kernels
// instantiated on the element type, the statistics and the arithmetic in
// f32 either way, as the TPU kernel computes them (fused_norm.py:53-69).
//
// Bound on this card: one read and one write of the (B, S, dim) stream, so
// memory bandwidth bounds it (57.5 MB at Wan-1.3B 480p x 21f in bf16,
// ~17 us at 3.35 TB/s).  Two kernels, chosen per call by the wrapper's rule
// on dim (ops/fused_norm.py:norm_layout, mirrored by the C entry):
//
// - fused_norm_rows_kernel, where dim = 256 * WPR * CH with CH <= 12 (every
//   served width: 1,536, 3,072, 5,120): WPR warps per row (one up to dim
//   3,072, two for 5,120), several rows per 256-thread block.  Each lane
//   reads CH chunks of 8 bf16 with 16-byte loads (neighbouring lanes on
//   neighbouring chunks) and holds them in registers (as bf16: half the
//   registers of f32, so more rows stay in flight); the mean, then the
//   centred variance (the two-pass statistics, in f32), come from warp
//   shuffles over those registers, with no shared memory and no block barrier where
//   a warp holds the row (two warps add their two partial sums through
//   shared memory behind a named barrier of their own).  gamma / beta and
//   the modulation are read as float4 (or 8 bf16), the output written with
//   16-byte stores.  In f32 a chunk of 8 is two 16-byte loads of 4 floats,
//   held as f32 (the same layout rule, twice the registers).
// - fused_norm_kernel, for other dims (the tiny test models): one block per
//   row; the row is read into shared memory as f32, the statistics come
//   from shared memory with block reductions, and the normalised,
//   modulated row is written once.
//
// Both read scale / shift in place: rows b * mod_stride of f32 or bf16
// (AdaLN's column slices of the (B, 6, dim) modulation), no copy.  Both
// take x and out as (B, S, dim) views whose S rows are dense and whose
// batches lie x_bstride / out_bstride elements apart: a range of rows of a
// longer sequence (HunyuanVideo's token-replace norm runs the first
// frame's rows and the rest as two such ranges, each with its own
// modulation), no copy.
//
// vorta_fused_residual_norm replaces vorta_tpu/ops/fused_norm.py:_res_kernel
// (reached through fused_residual_norm): x_new = bf16(f32(x) + f32(delta) *
// gate[b]) (gate optional), then the LayerNorm of the ROUNDED x_new with the
// same optional gamma / beta and AdaLN scale / shift, both outputs in bf16.
// Bound on this card: two reads and two writes of the (B, S, dim) stream
// (383 MB at Wan-1.3B 480p x 77f, dim 1536: 0.114 ms at 3.35 TB/s), against
// the three reads and two writes of the residual line and the norm run
// apart.  Same design, one block per row: x and delta are read once, x_new
// is written from the block and kept in shared memory as f32 for the
// statistics and the normalised write.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Where row r (of batch b, S rows a batch) of x and of out starts: batches
// x_bstride / out_bstride elements apart, rows dim apart within a batch.
struct Strides {
  long long x_bstride;
  long long out_bstride;

  __device__ __forceinline__ long long x_row(long long r, int b, int S, int dim) const {
    return b * x_bstride + (r - static_cast<long long>(b) * S) * dim;
  }
  __device__ __forceinline__ long long out_row(long long r, int b, int S, int dim) const {
    return b * out_bstride + (r - static_cast<long long>(b) * S) * dim;
  }
};

// Sum over the block; every thread gets the result.
__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) total += red[w];
  return total;
}

// scale / shift element i of row b: f32 or bf16 rows mod_stride apart
struct Mod {
  const void* scale;
  const void* shift;
  long long stride;
  int bf16;

  __device__ __forceinline__ float at(const void* m, int b, int i) const {
    const long long off = b * stride + i;
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(m)[off])
                : static_cast<const float*>(m)[off];
  }
  // elements i..i+7 (i % 8 == 0; rows 16-byte aligned)
  __device__ __forceinline__ void at8(const void* m, int b, int i, float (&out)[8]) const {
    const long long off = b * stride + i;
    if (bf16) {
      const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(m) + off);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
        out[2 * k] = f.x;
        out[2 * k + 1] = f.y;
      }
    } else {
      const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(m) + off);
      const float4 lo = f[0], hi = f[1];
      out[0] = lo.x, out[1] = lo.y, out[2] = lo.z, out[3] = lo.w;
      out[4] = hi.x, out[5] = hi.y, out[6] = hi.z, out[7] = hi.w;
    }
  }
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
fused_norm_kernel(const TI* __restrict__ x, TO* __restrict__ out, const Mod mod,
                  const float* __restrict__ gamma, const float* __restrict__ beta, int S, int dim,
                  int rms, float eps, const Strides st) {
  extern __shared__ float row[];
  __shared__ float red[THREADS / 32];
  const size_t r = blockIdx.x;
  const int b = static_cast<int>(r / S);
  const TI* xr = x + st.x_row(r, b, S, dim);

  float sum = 0.f;
  for (int i = threadIdx.x; i < dim; i += THREADS) {
    const float v = to_f32(xr[i]);
    row[i] = v;
    sum += v;
  }
  const float mean = rms ? 0.f : block_sum(sum, red) / dim;
  float sq = 0.f;
  for (int i = threadIdx.x; i < dim; i += THREADS) {
    const float c = row[i] - mean;
    sq += c * c;
  }
  const float inv = rsqrtf(block_sum(sq, red) / dim + eps);

  TO* orow = out + st.out_row(r, b, S, dim);
  for (int i = threadIdx.x; i < dim; i += THREADS) {
    float y = (row[i] - mean) * inv;
    if (gamma) {
      y = y * gamma[i];
      if (beta) y = y + beta[i];
    }
    if (mod.scale) y = y * (1.f + mod.at(mod.scale, b, i)) + mod.at(mod.shift, b, i);
    orow[i] = from_f32<TO>(y);
  }
}

// Sum over the WPR warps of one row group (WPR > 1): warp totals through
// shared memory (red: this group's WPR slots), behind a named barrier of
// the group's 32 * WPR threads.
template <int WPR>
__device__ __forceinline__ float group_sum(float x, float* red, int grp, int wir) {
  if ((threadIdx.x & 31) == 0) red[wir] = x;
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(32 * WPR) : "memory");
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < WPR; ++w) total += red[w];
  return total;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A 16-byte chunk of the row, read once: not kept in L1 (which then holds
// the modulation and gamma / beta every row of a batch reads).
__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 u;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "l"(p));
  return u;
}

// The 8 bf16 of a 16-byte chunk as f32.
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

// An 8-element chunk of a row as it is held: 8 bf16 in one 16-byte load,
// or 8 f32 in two.
template <typename TI> struct Chunk8;
template <> struct Chunk8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = load_stream(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void unpack(float (&f)[8]) const { unpack8(u, f); }
};
template <> struct Chunk8<float> {
  uint4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = load_stream(reinterpret_cast<const uint4*>(p));
    b = load_stream(reinterpret_cast<const uint4*>(p) + 1);
  }
  __device__ __forceinline__ void unpack(float (&f)[8]) const {
    f[0] = __uint_as_float(a.x), f[1] = __uint_as_float(a.y);
    f[2] = __uint_as_float(a.z), f[3] = __uint_as_float(a.w);
    f[4] = __uint_as_float(b.x), f[5] = __uint_as_float(b.y);
    f[6] = __uint_as_float(b.z), f[7] = __uint_as_float(b.w);
  }
};

// Rows of dim = 256 * WPR * CH elements: WPR warps a row, THREADS / 32 /
// WPR rows a block; lane l of warp w (of the row's WPR) holds the 8-element
// chunks c * 32 * WPR + w * 32 + l, c < CH, in the input type (bf16: half
// the registers of f32, so more warps stay in flight), each pass taking
// them as f32.
template <int CH, int WPR, typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
fused_norm_rows_kernel(const TI* __restrict__ x, TO* __restrict__ out, const Mod mod,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       long long rows, int S, int rms, float eps, const Strides st) {
  constexpr int DIM = 256 * WPR * CH;
  constexpr int ROWS = THREADS / 32 / WPR;  // rows per block
  __shared__ float red[2][WPR > 1 ? THREADS / 32 : 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / WPR, wir = warp % WPR;
  const long long r = static_cast<long long>(blockIdx.x) * ROWS + grp;
  if (r >= rows) return;  // the whole row group together
  const int b = static_cast<int>(r / S);
  const int c0 = wir * 32 + lane;  // this lane's first chunk

  Chunk8<TI> xv[CH];
  const TI* xr = x + st.x_row(r, b, S, DIM);
  TO* orow = out + st.out_row(r, b, S, DIM);
#pragma unroll
  for (int c = 0; c < CH; ++c) xv[c].load(xr + 8 * (c * 32 * WPR + c0));
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float f[8];
    xv[c].unpack(f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += f[e];
  }
  float mean = 0.f;
  if (!rms) {
    sum = warp_sum(sum);
    if constexpr (WPR > 1) sum = group_sum<WPR>(sum, &red[0][grp * WPR], grp, wir);
    mean = sum / DIM;
  }
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float f[8];
    xv[c].unpack(f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = f[e] - mean;
      sq += d * d;
    }
  }
  sq = warp_sum(sq);
  if constexpr (WPR > 1) sq = group_sum<WPR>(sq, &red[1][grp * WPR], grp, wir);
  const float inv = rsqrtf(sq / DIM + eps);

#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = 8 * (c * 32 * WPR + c0);
    float y[8];
    xv[c].unpack(y);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = (y[e] - mean) * inv;
    if (gamma) {
      const float4 g0 = *reinterpret_cast<const float4*>(gamma + col);
      const float4 g1 = *reinterpret_cast<const float4*>(gamma + col + 4);
      const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] *= gg[e];
      if (beta) {
        const float4 b0 = *reinterpret_cast<const float4*>(beta + col);
        const float4 b1 = *reinterpret_cast<const float4*>(beta + col + 4);
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] += bb[e];
      }
    }
    if (mod.scale) {
      float sc[8], sh[8];
      mod.at8(mod.scale, b, col, sc);
      mod.at8(mod.shift, b, col, sh);
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = y[e] * (1.f + sc[e]) + sh[e];
    }
    if constexpr (sizeof(TO) == 4) {
      float4* o = reinterpret_cast<float4*>(orow + col);
      o[0] = make_float4(y[0], y[1], y[2], y[3]);
      o[1] = make_float4(y[4], y[5], y[6], y[7]);
    } else {
      uint4 u;
      u.x = pack2(y[0], y[1]);
      u.y = pack2(y[2], y[3]);
      u.z = pack2(y[4], y[5]);
      u.w = pack2(y[6], y[7]);
      *reinterpret_cast<uint4*>(orow + col) = u;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
fused_residual_norm_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ delta,
                           __nv_bfloat16* __restrict__ x_new, __nv_bfloat16* __restrict__ y,
                           const float* __restrict__ gate, const float* __restrict__ scale,
                           const float* __restrict__ shift, const float* __restrict__ gamma,
                           const float* __restrict__ beta, int S, int dim, float eps) {
  extern __shared__ float row[];
  __shared__ float red[THREADS / 32];
  const size_t r = blockIdx.x;
  const int b = static_cast<int>(r / S);
  const __nv_bfloat16* xr = x + r * dim;
  const __nv_bfloat16* dr = delta + r * dim;
  __nv_bfloat16* nr = x_new + r * dim;
  const float* ga = gate ? gate + static_cast<size_t>(b) * dim : nullptr;

  float sum = 0.f;
  for (int i = threadIdx.x; i < dim; i += THREADS) {
    float d = __bfloat162float(dr[i]);
    if (ga) d = __fmul_rn(d, ga[i]);  // no fma: the product rounds, then the sum
    const __nv_bfloat16 xn = __float2bfloat16_rn(__fadd_rn(__bfloat162float(xr[i]), d));
    nr[i] = xn;
    const float v = __bfloat162float(xn);  // statistics on the rounded residual
    row[i] = v;
    sum += v;
  }
  const float mean = block_sum(sum, red) / dim;
  float sq = 0.f;
  for (int i = threadIdx.x; i < dim; i += THREADS) {
    const float c = row[i] - mean;
    sq += c * c;
  }
  const float inv = rsqrtf(block_sum(sq, red) / dim + eps);

  __nv_bfloat16* yr = y + r * dim;
  const float* sc = scale ? scale + static_cast<size_t>(b) * dim : nullptr;
  const float* sh = shift ? shift + static_cast<size_t>(b) * dim : nullptr;
  for (int i = threadIdx.x; i < dim; i += THREADS) {
    float v = (row[i] - mean) * inv;
    if (gamma) {
      v = v * gamma[i];
      if (beta) v = v + beta[i];
    }
    if (sc) v = v * (1.f + sc[i]) + sh[i];
    yr[i] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// x, delta, x_new, y: contiguous (B, S, dim) bf16; gate / scale / shift:
// (B, dim) f32 or null (scale and shift together); gamma / beta: (dim,) f32
// or null.  Returns the CUDA error code.
extern "C" int vorta_fused_residual_norm(const void* x, const void* delta, void* x_new, void* y,
                                         const void* gate, const void* scale, const void* shift,
                                         const void* gamma, const void* beta, int B, int S,
                                         int dim, float eps, void* stream) {
  if (dim <= 0 || dim * sizeof(float) > 48 * 1024 || (scale == nullptr) != (shift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = static_cast<size_t>(B) * S;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  using bf = __nv_bfloat16;
  fused_residual_norm_kernel<<<rows, THREADS, static_cast<size_t>(dim) * sizeof(float),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(delta), static_cast<bf*>(x_new),
      static_cast<bf*>(y), static_cast<const float*>(gate), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), S, dim, eps);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The warp-per-row kernel's layout for dim: (warps per row, chunks of 8 a
// lane), the fewest warps with at most 12 chunks a lane; {0, 0} where dim
// is not 256 * WPR * CH (ops/fused_norm.py:norm_layout, the same rule).
struct Layout {
  int wpr, ch;
};
Layout norm_layout(int dim) {
  for (int wpr = 1; wpr <= 4; wpr *= 2)
    if (dim % (256 * wpr) == 0 && dim / (256 * wpr) <= 12) return {wpr, dim / (256 * wpr)};
  return {0, 0};
}

template <int CH, int WPR, typename TI, typename TO>
cudaError_t launch_rows(const TI* x, TO* out, const Mod& mod, const float* gamma,
                        const float* beta, long long rows, int S, int rms, float eps,
                        const Strides& strides, cudaStream_t st) {
  constexpr long long per_block = THREADS / 32 / WPR;
  const long long blocks = (rows + per_block - 1) / per_block;
  fused_norm_rows_kernel<CH, WPR, TI, TO><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      x, out, mod, gamma, beta, rows, S, rms, eps, strides);
  return cudaGetLastError();
}

// CH runs over 1..12 for one warp a row, 7..12 for two or four (fewer
// chunks would have taken fewer warps).
template <int CH, typename TI, typename TO>
cudaError_t launch_ch(int wpr, int ch, const TI* x, TO* out, const Mod& mod,
                      const float* gamma, const float* beta, long long rows, int S, int rms,
                      float eps, const Strides& sd, cudaStream_t st) {
  if (ch != CH) {
    if constexpr (CH < 12)
      return launch_ch<CH + 1, TI, TO>(wpr, ch, x, out, mod, gamma, beta, rows, S, rms, eps, sd,
                                       st);
    else
      return cudaErrorInvalidValue;
  }
  if (wpr == 1) return launch_rows<CH, 1>(x, out, mod, gamma, beta, rows, S, rms, eps, sd, st);
  if constexpr (CH >= 7) {
    if (wpr == 2)
      return launch_rows<CH, 2>(x, out, mod, gamma, beta, rows, S, rms, eps, sd, st);
    if (wpr == 4)
      return launch_rows<CH, 4>(x, out, mod, gamma, beta, rows, S, rms, eps, sd, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out: (B, S, dim) with dense rows, batches x_bstride / out_bstride
// elements apart (S * dim where contiguous); x bf16 (x_f32: f32), out in x's
// dtype or (out_f32) f32.
// scale / shift: (B, dim) f32 (mod_bf16: bf16) with rows mod_stride
// elements apart and unit column stride, or null (together); gamma / beta:
// contiguous (dim,) f32 or null.  wpr: the wrapper's layout rule
// (ops/fused_norm.py:norm_layout), 0 for the block-per-row kernel; it must
// agree with the C side's.  The warp-per-row kernel needs x, gamma, beta
// and the modulation rows 16-byte aligned.  Returns the CUDA error code.
extern "C" int vorta_fused_norm(const void* x, void* out, const void* scale, const void* shift,
                                const void* gamma, const void* beta, int B, int S, int dim,
                                int out_f32, int rms, float eps, long long mod_stride,
                                int mod_bf16, int wpr, long long x_bstride,
                                long long out_bstride, int x_f32, void* stream) {
  if (dim <= 0 || dim * sizeof(float) > 48 * 1024 || (scale == nullptr) != (shift == nullptr) ||
      (B > 1 && (x_bstride < static_cast<long long>(S) * dim ||
                 out_bstride < static_cast<long long>(S) * dim)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides strides{x_bstride, out_bstride};
  const Layout lay = norm_layout(dim);
  if (wpr != lay.wpr) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * S;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  const Mod mod{scale, shift, mod_stride, mod_bf16};
  auto* ga = static_cast<const float*>(gamma);
  auto* be = static_cast<const float*>(beta);
  const size_t smem = static_cast<size_t>(dim) * sizeof(float);
  if (x_f32) {  // the output is f32 whether or not out_f32 asks for it
    auto* xx = static_cast<const float*>(x);
    auto* oo = static_cast<float*>(out);
    if (wpr)
      return static_cast<int>(launch_ch<1, float, float>(lay.wpr, lay.ch, xx, oo, mod, ga, be,
                                                         rows, S, rms, eps, strides, st));
    fused_norm_kernel<float, float><<<rows, THREADS, smem, st>>>(xx, oo, mod, ga, be, S, dim,
                                                                 rms, eps, strides);
    return static_cast<int>(cudaGetLastError());
  }
  auto* xx = static_cast<const __nv_bfloat16*>(x);
  if (wpr) {
    return static_cast<int>(
        out_f32 ? launch_ch<1, __nv_bfloat16, float>(lay.wpr, lay.ch, xx,
                                                     static_cast<float*>(out), mod, ga, be,
                                                     rows, S, rms, eps, strides, st)
                : launch_ch<1, __nv_bfloat16, __nv_bfloat16>(
                      lay.wpr, lay.ch, xx, static_cast<__nv_bfloat16*>(out), mod, ga, be, rows,
                      S, rms, eps, strides, st));
  }
  if (out_f32)
    fused_norm_kernel<__nv_bfloat16, float><<<rows, THREADS, smem, st>>>(
        xx, static_cast<float*>(out), mod, ga, be, S, dim, rms, eps, strides);
  else
    fused_norm_kernel<__nv_bfloat16, __nv_bfloat16><<<rows, THREADS, smem, st>>>(
        xx, static_cast<__nv_bfloat16*>(out), mod, ga, be, S, dim, rms, eps, strides);
  return static_cast<int>(cudaGetLastError());
}
