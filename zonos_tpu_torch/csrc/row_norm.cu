// N1: LayerNorm and RMSNorm over the rows of x [rows, d] (bf16 or fp32; bf16 scale and bias) with
// fp32 statistics, one warp a row, in a summation order that the row's width fixes and the row
// count does not.
//
// Replaces no TPU kernel: the JAX package normalises with XLA's reductions
// (zonos_tpu/ops/norms.py:16-37).  The port needs its own because PyTorch's reduction picks
// its block shape by the number of rows (few rows: many threads a row; more rows: fewer), so
// a row's mean and variance came out in another order alone (2 rows with CFG) than in a batch
// of 8, and a co-batched request's codes drifted from its solo codes.  Here every row is
// summed the same way, by row_stats.cuh: lane l of the row's warp keeps 8 partial sums of its
// elements l * 8 + i, l * 8 + i + 256, ... in increasing order, adds them in a fixed tree, and
// the 32 lanes meet by a butterfly.
//
// Most norms of the decode steps no longer run here: G1 and K8 normalise x as they stage it
// (a norm folded into the product that reads it), through the same header, so the bits are
// the same either way.  N1 keeps the final norms, the conditioner's, and the norms in front
// of products that run unfolded (kernels/gemm.py folds: a prefill's many rows).
//
// What bounds it on an H100: reading and writing each row once (4 d bytes in bf16); the
// arithmetic is a few flops an element.  A row's values are read three times (sum, squared
// deviations, output), the last two from L1/L2.  At a decode step's few rows, the launch.
//
// Numerics as the plain version (ops/norms.py): LayerNorm mean = sum / d, var = sum((x -
// mean)^2) / d, y = (x - mean) * rsqrt(var + eps) * scale + bias; RMSNorm ms = sum(x^2) / d,
// y = x * rsqrt(ms + eps) * scale (+ bias); all in fp32, cast once to x's dtype.
//
// C interface (ctypes): returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stats.cuh"

namespace {

constexpr int kWarps = 8;  // rows a CTA
constexpr int kThreads = kWarps * 32;

// grid (ceil(rows / 8)): warp w of CTA b normalises row 8 b + w; rms: RMSNorm, else
// LayerNorm; bias may be null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_norm_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ scale,
                const __nv_bfloat16* __restrict__ bias, T* __restrict__ y, int rows, int d,
                float eps, int rms) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;  // warp-uniform
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;
  // the parameters' lines into L2 while the statistics are summed
  for (int c = (threadIdx.x & 31) * row_stats::kVec; c < d; c += row_stats::kWarpStep) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(scale + c));
    if (bias != nullptr) asm volatile("prefetch.global.L2 [%0];" ::"l"(bias + c));
  }
  const float2 st = row_stats::stats(xr, d, eps, rms != 0);
#pragma unroll 4
  for (int c = (threadIdx.x & 31) * row_stats::kVec; c < d; c += row_stats::kWarpStep) {
    float v[row_stats::kVec];
    float sc[row_stats::kVec], b[row_stats::kVec];
    row_stats::load8(xr + c, v);
    row_stats::load_params(scale, bias, c, sc, b);
    row_stats::normalise8(v, st, sc, b, bias != nullptr);
    row_stats::store8(yr + c, v);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y, int rows, int d,
           float eps, int rms, cudaStream_t stream) {
  row_norm_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(bias), static_cast<T*>(y), rows, d, eps, rms);
  return cudaGetLastError();
}

}  // namespace

// x, y [rows, d] (x_f32: fp32, else bf16), contiguous, 16-byte aligned rows (d % 8 == 0);
// scale [d] and bias [d] or null, bf16, 16-byte aligned; rms: 1 RMSNorm, 0 LayerNorm.
extern "C" int zt_row_norm(const void* x, const void* scale, const void* bias, void* y, int rows,
                           int d, int x_f32, float eps, int rms, void* stream) {
  if (rows < 1 || d < 8 || d % 8 || (!rms && bias == nullptr) ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(y) & 15) ||
      (reinterpret_cast<uintptr_t>(scale) & 15) || (reinterpret_cast<uintptr_t>(bias) & 15))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_f32 ? launch<float>(x, scale, bias, y, rows, d, eps, rms, st)
               : launch<__nv_bfloat16>(x, scale, bias, y, rows, d, eps, rms, st);
}
