// Fused LayerNorm / RMSNorm with optional affine and AdaLN modulation, and
// the residual update fused with the LayerNorm that follows it.
//
// Replaces vorta_tpu/ops/fused_norm.py:_kernel (reached through
// _norm_fwd_pallas and fused_norm): f32 statistics over the row, then
// optional gamma/beta, then optional norm(x) * (1 + scale[b]) + shift[b],
// written in bf16 (x's dtype) or in f32.  bf16 inputs only: the port's
// model runs in bf16 on the card.
//
// Bound on this card: one read and one write of the (B, S, dim) stream, so
// memory bandwidth bounds it (57.5 MB at Wan-1.3B 480p x 21f in bf16,
// ~17 us at 3.35 TB/s).  Design: one block per row; the row is read from
// device memory once into shared memory as f32, the two-pass statistics
// (mean, then centred variance) come from shared memory with warp-shuffle
// reductions, and the normalised, modulated row is written once.
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

template <typename TO>
__global__ void __launch_bounds__(THREADS)
fused_norm_kernel(const __nv_bfloat16* __restrict__ x, TO* __restrict__ out, const float* __restrict__ scale,
                  const float* __restrict__ shift, const float* __restrict__ gamma,
                  const float* __restrict__ beta, int S, int dim, int rms, float eps) {
  extern __shared__ float row[];
  __shared__ float red[THREADS / 32];
  const size_t r = blockIdx.x;
  const int b = static_cast<int>(r / S);
  const __nv_bfloat16* xr = x + r * dim;

  float sum = 0.f;
  for (int i = threadIdx.x; i < dim; i += THREADS) {
    const float v = __bfloat162float(xr[i]);
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

  TO* orow = out + r * dim;
  const float* sc = scale ? scale + static_cast<size_t>(b) * dim : nullptr;
  const float* sh = shift ? shift + static_cast<size_t>(b) * dim : nullptr;
  for (int i = threadIdx.x; i < dim; i += THREADS) {
    float y = (row[i] - mean) * inv;
    if (gamma) {
      y = y * gamma[i];
      if (beta) y = y + beta[i];
    }
    if (sc) y = y * (1.f + sc[i]) + sh[i];
    orow[i] = from_f32<TO>(y);
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

// x, out: contiguous (B, S, dim); scale/shift: (B, dim) f32 or null;
// gamma/beta: (dim,) f32 or null.  x bf16; out bf16, or f32 when out_f32.
extern "C" int vorta_fused_norm(const void* x, void* out, const void* scale, const void* shift,
                                const void* gamma, const void* beta, int B, int S, int dim,
                                int out_f32, int rms, float eps, void* stream) {
  if (dim <= 0 || dim * sizeof(float) > 48 * 1024 || (scale == nullptr) != (shift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = static_cast<size_t>(B) * S;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<const float*>(scale);
  auto* sh = static_cast<const float*>(shift);
  auto* ga = static_cast<const float*>(gamma);
  auto* be = static_cast<const float*>(beta);
  auto* xx = static_cast<const __nv_bfloat16*>(x);
  const size_t smem = static_cast<size_t>(dim) * sizeof(float);
  if (out_f32)
    fused_norm_kernel<float><<<rows, THREADS, smem, st>>>(xx, static_cast<float*>(out), sc, sh, ga,
                                                          be, S, dim, rms, eps);
  else
    fused_norm_kernel<__nv_bfloat16><<<rows, THREADS, smem, st>>>(
        xx, static_cast<__nv_bfloat16*>(out), sc, sh, ga, be, S, dim, rms, eps);
  return static_cast<int>(cudaGetLastError());
}
