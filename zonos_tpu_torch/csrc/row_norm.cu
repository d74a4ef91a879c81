// N1: LayerNorm and RMSNorm over the rows of x [rows, d] (bf16 or fp32; bf16 scale and bias) with
// fp32 statistics, one CTA a row, in a summation order that the row's width fixes and the row
// count does not.
//
// Replaces no TPU kernel: the JAX package normalises with XLA's reductions
// (zonos_tpu/ops/norms.py:16-37).  The port needs its own because PyTorch's reduction picks
// its block shape by the number of rows (few rows: many threads a row; more rows: fewer), so
// a row's mean and variance came out in another order alone (2 rows with CFG) than in a batch
// of 8, and a co-batched request's codes drifted from its solo codes.  Here every row is
// summed the same way: thread t adds its elements t * V, t * V + 256 V, ... (V = 8 for bf16,
// 4 for fp32) in increasing order, the 32 lanes of a warp combine by a butterfly of shuffles,
// and the 8 warps' sums are added in warp order.
//
// What bounds it on an H100: reading and writing each row once (4 d bytes in bf16); the
// arithmetic is a few flops an element.  A row's values are read three times (sum, squared
// deviations, output), the last two from L1/L2.
//
// Numerics as the plain version (ops/norms.py): LayerNorm mean = sum / d, var = sum((x -
// mean)^2) / d, y = (x - mean) * rsqrt(var + eps) * scale + bias; RMSNorm ms = sum(x^2) / d,
// y = x * rsqrt(ms + eps) * scale (+ bias); all in fp32, cast once to x's dtype.
//
// C interface (ctypes): returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Vec;  // V elements of T in one 16-byte load
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// A bf16 parameter vector's V values at c, widened to fp32.
template <int V>
__device__ __forceinline__ void load_param(const __nv_bfloat16* p, int c, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[c + i]);
}

// The CTA's sum of one value a thread: a butterfly within each warp, then the warps in order.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red is free (a previous sum has been read)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

// grid (rows); rms: RMSNorm, else LayerNorm; bias may be null (RMSNorm).
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_norm_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ scale,
                const __nv_bfloat16* __restrict__ bias, T* __restrict__ y, int d, float eps,
                int rms) {
  constexpr int V = Vec<T>::V;
  __shared__ float red[kWarps];
  const T* xr = x + (size_t)blockIdx.x * d;
  T* yr = y + (size_t)blockIdx.x * d;
  float s = 0.f;
  for (int c = threadIdx.x * V; c < d; c += kThreads * V) {
    float v[V];
    Vec<T>::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) s += rms ? v[i] * v[i] : v[i];
  }
  const float first = block_sum(s, red) / d;  // LayerNorm: the mean; RMSNorm: mean of squares
  float mean = 0.f, r;
  if (rms) {
    r = rsqrtf(first + eps);
  } else {
    mean = first;
    float q = 0.f;
    for (int c = threadIdx.x * V; c < d; c += kThreads * V) {
      float v[V];
      Vec<T>::load(xr + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) q += (v[i] - mean) * (v[i] - mean);
    }
    r = rsqrtf(block_sum(q, red) / d + eps);
  }
  for (int c = threadIdx.x * V; c < d; c += kThreads * V) {
    float v[V], sc[V], b[V];
    Vec<T>::load(xr + c, v);
    load_param<V>(scale, c, sc);
    if (bias != nullptr) load_param<V>(bias, c, b);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float t = rms ? v[i] * r * sc[i] : (v[i] - mean) * r * sc[i];
      if (bias != nullptr) t += b[i];
      v[i] = t;
    }
    Vec<T>::store(yr + c, v);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y, int rows, int d,
           float eps, int rms, cudaStream_t stream) {
  row_norm_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(bias), static_cast<T*>(y), d, eps, rms);
  return cudaGetLastError();
}

}  // namespace

// x, y [rows, d] (x_f32: fp32, else bf16), contiguous, 16-byte aligned rows (d % 8 == 0);
// scale [d] and bias [d] or null, bf16; rms: 1 RMSNorm, 0 LayerNorm.
extern "C" int zt_row_norm(const void* x, const void* scale, const void* bias, void* y, int rows,
                           int d, int x_f32, float eps, int rms, void* stream) {
  if (rows < 1 || d < 8 || d % 8 || (!rms && bias == nullptr) ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(y) & 15))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_f32 ? launch<float>(x, scale, bias, y, rows, d, eps, rms, st)
               : launch<__nv_bfloat16>(x, scale, bias, y, rows, d, eps, rms, st);
}
