// K3: fused sampling for Hopper (sm_90a): softmax(logits / T) -> unified reshaping
// -> min-p -> Gumbel-race argmax, one token id per (batch row, codebook).
//
// Replaces the Pallas TPU kernel zonos_tpu/ops/pallas_kernels.py fused_sample_pallas
// (:232; body _sampling_kernel :196).  As there, the Gumbel noise is an operand, so the
// kernel is a pure function of (logits, noise) and its plain PyTorch twin draws the same ids.
//
// What bounds it on an H100: it reads the logits and the noise once (2 x 4 bytes per vocab
// entry: 2 x 8 x 9 x 1152 x 4 = 0.66 MB at batch 8) and writes one id per row; the few
// exp/log per element are far below the card's compute rate.  At these sizes the floor is
// the HBM read (~0.2 us), and in practice one launch's latency.
//
// Design: one CTA per row of V = 1152 logits; the whole row lives in shared memory, so every
// stage (max, sum, entropy, renormalise, argmax) is a block reduction with no traffic between
// CTAs and no intermediate in device memory.  Each thread owns the vocab entries
// i = tid, tid + 256, ... and only ever touches those, so the elementwise passes need no
// barrier; the reductions are warp shuffles plus one shared-memory step, summed in a fixed
// order (deterministic).  The argmax breaks ties toward the lowest index, like jnp.argmax.
// The vocab padding (logit -inf) gets probability 0 from the first softmax, but the unified
// stage clamps p at 1e-20 before the log, so those ids get a tiny nonzero probability after
// reshaping, exactly as the TPU kernel and the plain version do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = fmaxf(t, red[w]);
  __syncthreads();
  return t;
}

// (value, index) with the larger value winning and ties going to the lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ int block_argmax(float v, int i, float* redv, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { redv[warp] = v; redi[warp] = i; }
  __syncthreads();
  float bv = redv[0];
  int bi = redi[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    if (better(redv[w], redi[w], bv, bi)) { bv = redv[w]; bi = redi[w]; }
  return bi;
}

__global__ void __launch_bounds__(kThreads)
fused_sample_kernel(const float* __restrict__ logits, const float* __restrict__ noise,
                    int64_t* __restrict__ out, int V, float temperature, float linear,
                    float conf, float quad, float min_p) {
  extern __shared__ float p[];  // [V]
  __shared__ float red[kWarps];
  __shared__ int redi[kWarps];
  const int tid = threadIdx.x;
  const float* x = logits + (size_t)blockIdx.x * V;
  const float* g = noise + (size_t)blockIdx.x * V;

  float mx = -INFINITY;
  for (int i = tid; i < V; i += kThreads) {
    const float xi = x[i] / temperature;
    p[i] = xi;
    mx = fmaxf(mx, xi);
  }
  mx = block_max(mx, red);
  float sum = 0.f;
  for (int i = tid; i < V; i += kThreads) {
    const float e = expf(p[i] - mx);
    p[i] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int i = tid; i < V; i += kThreads) p[i] = p[i] / sum;

  if (linear > 0.f) {
    float ent = 0.f;
    for (int i = tid; i < V; i += kThreads) ent += p[i] * logf(fmaxf(p[i], 1e-20f));
    ent = -block_sum(ent, red);
    const float lin = linear + ent * conf;
    float m2 = -INFINITY;
    for (int i = tid; i < V; i += kThreads) {
      const float lp = logf(fmaxf(p[i], 1e-20f));
      const float raw = lp * lin - lp * lp * quad;
      p[i] = raw;
      m2 = fmaxf(m2, raw);
    }
    m2 = block_max(m2, red);
    float s2 = 0.f;
    for (int i = tid; i < V; i += kThreads) {
      const float e = expf(p[i] - m2);
      p[i] = e;
      s2 += e;
    }
    s2 = block_sum(s2, red);
    for (int i = tid; i < V; i += kThreads) p[i] = p[i] / s2;
  }

  if (min_p > 0.f) {
    float top = -INFINITY;
    for (int i = tid; i < V; i += kThreads) top = fmaxf(top, p[i]);
    top = block_max(top, red);
    const float cut = min_p * top;
    float s3 = 0.f;
    for (int i = tid; i < V; i += kThreads) {
      const float q = p[i] < cut ? 0.f : p[i];
      p[i] = q;
      s3 += q;
    }
    s3 = block_sum(s3, red);
    for (int i = tid; i < V; i += kThreads) p[i] = p[i] / s3;
  }

  float best = -INFINITY;
  int best_i = tid;
  for (int i = tid; i < V; i += kThreads) {
    const float score = p[i] > 0.f ? logf(p[i]) + g[i] : -INFINITY;
    if (score > best) { best = score; best_i = i; }
  }
  const int id = block_argmax(best, best_i, red, redi);
  if (tid == 0) out[blockIdx.x] = id;
}

}  // namespace

// logits, noise: [rows, V] fp32 contiguous; out: [rows] int64.
extern "C" int zt_fused_sample(const void* logits, const void* noise, void* out, int rows, int V,
                               float temperature, float linear, float conf, float quad,
                               float min_p, void* stream) {
  const size_t smem = (size_t)V * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  fused_sample_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(noise),
      static_cast<int64_t*>(out), V, temperature, linear, conf, quad, min_p);
  return cudaGetLastError();
}
