// K5: snake activation fused into a dilated, 'same'-padded 1-D convolution, fp32, for
// Hopper (sm_90a).  y = conv1d(snake(x, alpha), w, b) [+ residual], with
// snake(x) = x + sin^2(alpha * x) / (alpha + 1e-9).
//
// Replaces the Pallas TPU kernel zonos_tpu/ops/pallas_dac.py snake_conv1d_pallas (:47;
// body _snake_conv_kernel :30); two launches make snake_residual_unit_pallas (:90), whose
// residual add is fused into the second launch's epilogue here.
//
// What bounds it on an H100: the DAC decoder's residual units are large fp32 products,
// 2 * T * C_in * C_out * k FLOPs (29-58 GFLOP per k = 7 conv for one 5 s utterance)
// against ~T * (C_in + C_out) * 4 bytes, so they are bound by the fp32 CUDA-core rate
// (67 TFLOP/s), not by memory.  The DAC runs in fp32 (zonos_tpu/models/dac/codec.py:10-11),
// so this kernel does not use TF32 tensor cores.
//
// Design: each CTA computes a (64 time steps x 64 output channels) tile for one batch row.
// It walks C_in in chunks of 16: it stages the snake'd input window of 64 + (k-1)*dilation
// rows (the halo) for the chunk into shared memory once -- the snake is computed there, so
// the activated tensor never exists in device memory -- together with the chunk's k weight
// slices, then accumulates the k shifted products in fp32 registers (4 x 4 outputs per
// thread).  Zero padding at the sequence edges is applied after the snake, which is the
// same since snake(0) = 0.  Channels that are not a multiple of the tile are masked, so
// every DAC width (768/384/192/96, and small test widths) runs through the same kernel.
// Activations keep the JAX package's NWC layout [B, T, C]; weights come in [k, C_in, C_out].
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTT = 64;   // time steps per CTA
constexpr int kCT = 64;   // output channels per CTA
constexpr int kCI = 16;   // input channels per staged chunk
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
snake_conv1d_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                    const float* __restrict__ w, const float* __restrict__ bias,
                    const float* __restrict__ res, float* __restrict__ y, int T, int Cin,
                    int Cout, int K, int dil) {
  extern __shared__ float smem[];
  const int win = kTT + (K - 1) * dil;
  float* xs = smem;              // [win][kCI]   snake'd input window
  float* ws = smem + win * kCI;  // [K][kCI][kCT] weight slices

  const int t0 = blockIdx.x * kTT, co0 = blockIdx.y * kCT, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int pad = (K - 1) * dil / 2;
  const float* xb = x + (size_t)b * T * Cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kCI) {
    for (int idx = tid; idx < win * kCI; idx += kThreads) {
      const int r = idx / kCI, c = idx % kCI;
      const int t = t0 - pad + r, ci = ci0 + c;
      float v = 0.f;
      if (t >= 0 && t < T && ci < Cin) {
        const float xv = xb[(size_t)t * Cin + ci];
        const float a = alpha[ci];
        const float s = sinf(a * xv);
        v = xv + s * s / (a + 1e-9f);
      }
      xs[idx] = v;
    }
    for (int idx = tid; idx < K * kCI * kCT; idx += kThreads) {
      const int j = idx / (kCI * kCT), c = (idx / kCT) % kCI, o = idx % kCT;
      const int ci = ci0 + c, co = co0 + o;
      ws[idx] = (ci < Cin && co < Cout) ? w[((size_t)j * Cin + ci) * Cout + co] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < K; ++j) {
      const float* xr = xs + (ty + j * dil) * kCI;
      const float* wr = ws + j * kCI * kCT + tx;
#pragma unroll
      for (int c = 0; c < kCI; ++c) {
        float a[4], bw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xr[16 * i * kCI + c];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bw[jj] = wr[c * kCT + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(a[i], bw[jj], acc[i][jj]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= T) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int co = co0 + tx + 16 * jj;
      if (co >= Cout) continue;
      const size_t o = ((size_t)b * T + t) * Cout + co;
      float out = acc[i][jj] + bias[co];
      if (res != nullptr) out += res[o];
      y[o] = out;
    }
  }
}

}  // namespace

// x [B, T, C_in], w [K, C_in, C_out], alpha [C_in], bias [C_out], res/y [B, T, C_out]:
// fp32, contiguous.  res may be null.  K odd; 'same' padding (K-1)*dil/2 on both sides.
extern "C" int zt_snake_conv1d(const void* x, const void* alpha, const void* w, const void* bias,
                               const void* res, void* y, int B, int T, int Cin, int Cout, int K,
                               int dil, void* stream) {
  const size_t smem = ((size_t)(kTT + (K - 1) * dil) * kCI + (size_t)K * kCI * kCT) * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((T + kTT - 1) / kTT, (Cout + kCT - 1) / kCT, B);
  snake_conv1d_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(alpha),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(res), static_cast<float*>(y), T, Cin, Cout, K, dil);
  return cudaGetLastError();
}
