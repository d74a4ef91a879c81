// K3: fused sampling for Hopper (sm_90a): softmax(logits / T) -> unified reshaping
// -> min-p -> Gumbel-race argmax, one token id per (batch row, codebook).
//
// Replaces the Pallas TPU kernel zonos_tpu/ops/pallas_kernels.py fused_sample_pallas
// (:232; body _sampling_kernel :196).  As there, the Gumbel noise is an operand, so the
// kernel is a pure function of (logits, noise) and its plain PyTorch twin draws the same ids.
//
// What bounds it on an H100: it reads the logits and the noise once (2 x 4 bytes per vocab
// entry: 2 x 9 x 1152 x 4 = 83 KB at batch 1) and writes one id per row; the few exp per
// element are far below the card's compute rate.  The floor is the HBM read (0.025 us at
// batch 1), so in practice a launch's latency and the chain of dependent steps in a row:
// load, six reductions, store.
//
// Two routes, picked by V alone (kernels/sampling.py sample_plan):
//
// - fused_sample_warp_kernel, V <= kWarpMaxVocab = 1152 (the flagship's padded vocabulary):
//   one warp a (row, codebook) row, `warps` rows a CTA.  The row stays in registers: lane l
//   holds the entries 4 (32 j + l) + c for j < kChunks = 9, c < 4 (16-byte loads when
//   V % 4 == 0 and both rows are 16-byte aligned, else the same entries one by one): 9
//   float4 of logits and 9 of noise a lane, all loads issued before the first use, so the
//   noise's latency hides under the math.  Every reduction is a __shfl_xor_sync butterfly:
//   no shared memory, no __syncthreads.  Slots past V are masked, so a row's sums, and its
//   id, depend on V and its own operands alone: not on B, on `warps`, on the load width or
//   on the CTA it lands in.
// - fused_sample_cta_kernel, 1152 < V <= 12288: one 256-thread CTA a row, the row in
//   48 KB of shared memory, block reductions (the first form of this kernel).
//
// The algebra of the warp route, the plain version's up to rounding:
//   t = x * (1/T) (as PyTorch multiplies by a host scalar's reciprocal on the card),
//   m = max t, e = exp(t - m), s = sum e, p = e / s,
//   log p = (t - m) - log s, computed once, not as log(p) (the unified stage's
//   log(max(p, 1e-20)) is max(log p, log 1e-20)); the entropy, as -(1/s) sum e log p, and
//   the reshaped logits both use it.  The reshaped softmax's largest entry is exp(0) / s2 = 1 / s2 exactly, so
//   min-p's top needs no reduction.  The race score log p' + G of a kept entry is taken as
//   (raw - m2) + G: log p' and raw - m2 differ by a constant of the row (log s2, and min-p's
//   renormaliser), which moves no argmax.  Zero entries are decided on p = e * (1 / s)
//   itself, so an entry with p == 0 scores -inf, as in the plain version: the vocab padding
//   (logit -inf) gets p = 0 from the first softmax, but the unified stage clamps p at 1e-20
//   before the log, so those ids get a tiny nonzero probability after reshaping, exactly as
//   the TPU kernel and the plain version do.  expf and the reciprocals are IEEE (no fast
//   intrinsics): they decide which entries are zero.  Ties go to the lowest index, as
//   jnp.argmax and torch.argmax.  The warp's maxima (of t, of raw where it needs one, and
//   of the race) are redux.sync on order-preserving keys, exact; its sums butterflies.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunks = 9;  // 36 entries, and as much noise, in a lane's registers
constexpr int kN = 4 * kChunks;
constexpr int kWarpMaxVocab = 32 * kN;
constexpr int kMaxWarpsPerCta = 8;

// (value, index) with the larger value winning and ties going to the lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// fp32 -> a key whose unsigned order is the floats' order (-0 taken as +0), so that a
// warp's max is one redux.sync; exact, and the same in every lane.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float warp_max_redux(float v) {
  const unsigned k = __reduce_max_sync(kFull, order_key(v));
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A lane's entries summed in a fixed order: one partial per c, then (0 + 1) + (2 + 3).
__device__ __forceinline__ float lane_sum(const float (&a)[kN]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] += a[4 * j + c];
  return (s[0] + s[1]) + (s[2] + s[3]);
}

__device__ __forceinline__ float lane_max(const float (&a)[kN]) {
  float s[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = fmaxf(s[c], a[4 * j + c]);
  return fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
}

// The unified stage's raw = lp * lin - lp * lp * quad, rounded the same way wherever it is
// taken (quad 0: lp * lin, the same value in two fewer operations).
__device__ __forceinline__ float reshaped(float lp, float lin, float quad) {
  return quad == 0.f ? __fmul_rn(lp, lin) : __fmaf_rn(lp, lin, -__fmul_rn(__fmul_rn(lp, lp), quad));
}

// Slot (j, c) of a lane holds an entry below V: with 16-byte loads (V % 4 == 0) a chunk is
// all in or all out, so one compare a chunk.
template <bool kVec4>
__device__ __forceinline__ bool in_row(int j, int c, int lane, int V) {
  return kVec4 ? 4 * (32 * j + lane) < V : 4 * (32 * j + lane) + c < V;
}

template <bool kVec4>
__global__ void __launch_bounds__(kMaxWarpsPerCta * 32)
fused_sample_warp_kernel(const float* __restrict__ logits, const float* __restrict__ noise,
                         int64_t* __restrict__ out, int rows, int V, float inv_temperature,
                         float linear, float conf, float quad, float min_p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp: the reductions below see all 32 lanes
  // the lane's first entry; slot (j, c) is 128 j + c past it, entry 4 (32 j + lane) + c
  const float* x = logits + (size_t)row * V + 4 * lane;
  const float* gp = noise + (size_t)row * V + 4 * lane;
  float v[kN], g[kN], e[kN];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int base = 4 * (32 * j + lane);
    if (kVec4) {
      float4 a = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (base < V) {
        a = __ldg(reinterpret_cast<const float4*>(x + 128 * j));
        b = __ldg(reinterpret_cast<const float4*>(gp + 128 * j));
      }
      v[4 * j] = a.x, v[4 * j + 1] = a.y, v[4 * j + 2] = a.z, v[4 * j + 3] = a.w;
      g[4 * j] = b.x, g[4 * j + 1] = b.y, g[4 * j + 2] = b.z, g[4 * j + 3] = b.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = base + c < V;
        v[4 * j + c] = in ? __ldg(x + 128 * j + c) : -INFINITY;
        g[4 * j + c] = in ? __ldg(gp + 128 * j + c) : 0.f;
      }
    }
  }

  // softmax(x / T): v <- t - m (the log of the unnormalised p), e <- exp(t - m)
  if (inv_temperature != 1.f) {
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] *= inv_temperature;
  }
  const float m = warp_max_redux(lane_max(v));
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    v[i] -= m;
    e[i] = expf(v[i]);  // slots past V: exp(-inf) = 0
  }
  float s = warp_sum(lane_sum(e));

  if (linear > 0.f) {
    // log p = (t - m) - log s, clamped at log(1e-20); entropy -sum p log p
    const float log_s = logf(s), inv_s = __frcp_rn(s), log_floor = logf(1e-20f);
    float h[4] = {0.f, 0.f, 0.f, 0.f};  // sum e log p, a partial per c as in lane_sum
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * j + c;
        v[i] = fmaxf(v[i] - log_s, log_floor);
        h[c] = __fmaf_rn(e[i], v[i], h[c]);  // 0 where p is 0
      }
    const float ent = -inv_s * warp_sum((h[0] + h[1]) + (h[2] + h[3]));  // -sum p log p
    const float lin = linear + ent * conf;
    if (quad == 0.f) {
#pragma unroll
      for (int i = 0; i < kN; ++i) v[i] = reshaped(v[i], lin, 0.f);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) v[i] = reshaped(v[i], lin, quad);
    }
    if (V < kWarpMaxVocab) {  // slots past V (their clamped lp is finite) leave the softmax
#pragma unroll
      for (int j = 0; j < kChunks; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (!in_row<kVec4>(j, c, lane, V)) v[4 * j + c] = -INFINITY;
    }
    // raw's max: with lin > 0 and quad >= 0, raw rises with lp over lp <= 0 (and so does
    // its rounding), so it is raw at the largest entry, where t - m = 0; else a reduction
    const float m2 = lin > 0.f && quad >= 0.f
                         ? reshaped(fmaxf(0.f - log_s, log_floor), lin, quad)
                         : warp_max_redux(lane_max(v));
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      v[i] -= m2;
      e[i] = expf(v[i]);
    }
    s = warp_sum(lane_sum(e));
  }

  // p = e / s (its largest entry is exp(0) / s = 1 / s); min-p drops p < min_p / s
  // (min_p 0: none); the race scores v + G of the entries with p > 0.  One candidate per
  // c over j (rising entries: the first of equal scores stays), then the lowest entry
  // among the warp's best.
  const float inv = __frcp_rn(s), cut = min_p * inv;
  float best[4];
  int best_i[4];
  if (min_p > 0.f) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = e[4 * j + c] * inv;
        const float score = p > 0.f && !(p < cut) ? v[4 * j + c] + g[4 * j + c] : -INFINITY;
        if (j == 0 || score > best[c]) best[c] = score, best_i[c] = 4 * (32 * j + lane) + c;
      }
  } else {
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float score = e[4 * j + c] * inv > 0.f ? v[4 * j + c] + g[4 * j + c] : -INFINITY;
        if (j == 0 || score > best[c]) best[c] = score, best_i[c] = 4 * (32 * j + lane) + c;
      }
  }
#pragma unroll
  for (int c = 1; c < 4; ++c)
    if (better(best[c], best_i[c], best[0], best_i[0])) best[0] = best[c], best_i[0] = best_i[c];
  const unsigned top = __reduce_max_sync(kFull, order_key(best[0]));
  const unsigned id = __reduce_min_sync(kFull, order_key(best[0]) == top ? best_i[0] : ~0u);
  if (lane == 0) out[row] = id < (unsigned)V ? id : 0;  // every score NaN: id 0
}

// ---- the CTA route, 1152 < V <= 12288 ----------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtaMaxSmem = 48 * 1024;  // the row: V <= 12,288

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
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
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = fmaxf(t, red[w]);
  __syncthreads();
  return t;
}

__device__ __forceinline__ int block_argmax(float v, int i, float* redv, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
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

// Each thread owns the entries i = tid, tid + 256, ... and only ever touches those, so the
// elementwise passes need no barrier; the reductions are warp shuffles plus one
// shared-memory step, summed in a fixed order (deterministic).
__global__ void __launch_bounds__(kThreads)
fused_sample_cta_kernel(const float* __restrict__ logits, const float* __restrict__ noise,
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

// The warp route.  logits, noise: [rows, V] fp32 contiguous, V <= 1152; out: [rows] int64;
// `warps` the rows a CTA (1, 2, 4 or 8).
extern "C" int zt_fused_sample_warp(const void* logits, const void* noise, void* out, int rows,
                                    int V, int warps, float temperature, float linear,
                                    float conf, float quad, float min_p, void* stream) {
  if (rows <= 0 || V <= 0 || V > kWarpMaxVocab ||
      (warps != 1 && warps != 2 && warps != 4 && warps != 8))
    return cudaErrorInvalidValue;
  const float inv_t = 1.0f / temperature;  // fp32, as torch's x / T on the card
  const auto* l = static_cast<const float*>(logits);
  const auto* n = static_cast<const float*>(noise);
  auto* o = static_cast<int64_t*>(out);
  const bool vec4 = V % 4 == 0 && reinterpret_cast<uintptr_t>(l) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(n) % 16 == 0;
  const dim3 grid((rows + warps - 1) / warps), block(32 * warps);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec4)
    fused_sample_warp_kernel<true><<<grid, block, 0, s>>>(l, n, o, rows, V, inv_t, linear,
                                                          conf, quad, min_p);
  else
    fused_sample_warp_kernel<false><<<grid, block, 0, s>>>(l, n, o, rows, V, inv_t, linear,
                                                           conf, quad, min_p);
  return cudaGetLastError();
}

// Lets the CTA route's row take all of 48 KB of dynamic shared memory (12,288 entries; with
// the kernel's static 64 bytes that passes the 48 KB default); called once per device when
// the library is loaded, so never during a CUDA graph's capture.
extern "C" int zt_fused_sample_prepare() {
  return cudaFuncSetAttribute(fused_sample_cta_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kCtaMaxSmem);
}

// The CTA route.  logits, noise: [rows, V] fp32 contiguous; out: [rows] int64.
extern "C" int zt_fused_sample_cta(const void* logits, const void* noise, void* out, int rows,
                                   int V, float temperature, float linear, float conf,
                                   float quad, float min_p, void* stream) {
  const size_t smem = (size_t)V * sizeof(float);
  if (rows <= 0 || smem > kCtaMaxSmem) return cudaErrorInvalidValue;
  fused_sample_cta_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(noise),
      static_cast<int64_t*>(out), V, temperature, linear, conf, quad, min_p);
  return cudaGetLastError();
}
