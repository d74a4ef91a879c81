// K1 + K2: one-token GQA decode attention over a bf16 KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in zonos_tpu/ops/pallas_kernels.py:
//   K1 flash_decode_attention_pallas (:147; body _flash_decode_kernel :100)
//   K2 decode_attention_pallas       (:58;  body _decode_attn_kernel :37)
//
// What bounds it on an H100: each (batch row, kv head) owns G = H/H_kv query rows (4 on
// the flagship) that read the same cache rows, so every cache byte feeds ~G FLOPs, far
// below the card's ~295 FLOP/byte bf16 ridge.  The floor is reading the valid part of the
// K and V cache from HBM (3.35 TB/s): 2 * B * H_kv * length * D * 2 bytes.  At batch 1 that
// is ~2 MB at length 2000, a few microseconds, so in practice a CTA's memory latency and
// the number of loads it keeps in flight decide the time.
//
// Design:
// - The TPU kernel walks the cache blocks in order on one core and carries (m, l, acc) in
//   VMEM scratch from one grid step to the next.  On the card CTAs run in parallel and in no
//   order, and at batch 1 with CFG there are only 2 * 4 = 8 (batch row, kv head) pairs for
//   132 SMs.  So K1 splits over S: one CTA per (256-row cache block, batch row, kv head)
//   keeps its own fp32 (m, l, acc) for its G query rows, and a second small kernel combines
//   the splits with the usual log-sum-exp rescaling.  Blocks at or past `length` are never
//   launched, so the bytes read scale with the valid length, not the allocated S.
// - K2 is the same block routine run over all valid blocks inside one CTA per (batch row,
//   kv head): one launch and no combine pass.  The port's dispatcher uses it while the
//   cache holds at most one block (length <= 256), where K1 would launch a single split.
// - A CTA (256 threads) stages its whole 256-row block, K and V (2 x 64 KB), into shared
//   memory with cp.async before it computes anything: every byte it needs is in flight at
//   once, so a block costs one HBM round trip, and the V copy lands while the scores are
//   computed.  Rows at or past `length` are zero-filled, not read.  (Earlier versions
//   loaded rows into registers, 64 rows at a time, and waited for about eight round trips
//   per block: on a cold L2 that was the kernel's time, PERF.md.)
// - From shared memory, 16 lanes cover one 128-wide row with one 16-byte load each, so a
//   warp reads two neighbouring rows (512 contiguous bytes, no bank conflicts).  Scores are
//   reduced over the 16 lanes with 4 shuffles.  Softmax statistics are one row per thread.
//   The value product uses the same layout (each thread accumulates 8 output columns over
//   its rows) and the 16 row groups are summed at the end in a fixed order.
// - Scores, softmax weights and the accumulators are fp32; q, k, v are read as bf16 and
//   widened in registers; the output is rounded to bf16 once.  Rows at or past `length`
//   are neither read nor computed, so garbage there (even inf/nan) cannot leak in.  All
//   sums run in a fixed order: the result does not change from run to run.
//
// C interface (ctypes): every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kBlockS = 256;
constexpr int kThreads = 256;  // one softmax row per thread: kThreads == kBlockS
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerRow = 16;  // 16 lanes x 8 bf16 = one 128-wide row
constexpr int kRowsPerPass = kThreads / kLanesPerRow;
// dynamic shared memory: the staged K and V blocks, [kBlockS][kD] bf16 each
constexpr int kStageBytes = 2 * kBlockS * kD * 2;
static_assert(kThreads == kBlockS, "softmax statistics take one row per thread");
static_assert(kD == kLanesPerRow * 8, "a row is 16 lanes of 8 bf16");

__device__ __forceinline__ void widen8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reduces G values across the CTA; every thread gets the same results, combined in the
// same order (deterministic).
template <int G, bool kMax>
__device__ __forceinline__ void block_reduce(float (&v)[G], float (*red)[G]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) v[g] = kMax ? warp_max(v[g]) : warp_sum(v[g]);
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) red[warp][g] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float t = red[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = kMax ? fmaxf(t, red[w][g]) : t + red[w][g];
    v[g] = t;
  }
  __syncthreads();
}

// Starts the asynchronous copy of cache rows [0, kBlockS) of `src` into `dst` as one
// cp.async group; rows at or past nrows are zero-filled without reading global memory.
// Consecutive threads copy consecutive 16-byte pieces, so the reads are coalesced.
__device__ __forceinline__ void stage_block(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            int nrows) {
#pragma unroll
  for (int i = 0; i < kBlockS * kLanesPerRow / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kLanesPerRow, off = r * kD + (c % kLanesPerRow) * 8;
    const bool in = r < nrows;
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + off));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(in ? src + off : src), "r"(in ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most `n` of this thread's cp.async groups are pending, then makes every
// thread's copies visible to the CTA.
template <int n>
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
  __syncthreads();
}

// Online softmax over cache blocks [blk0, blk1) of one (batch row, kv head).
// q: [G, D]; k, v: [S, D] (bf16).  On return every thread holds the running max m and sum
// l of each query row, and threads t < D hold out[g] = sum_r p_r * v[r][t].
template <int G>
__device__ __forceinline__ void attend_blocks(const __nv_bfloat16* __restrict__ q,
                                              const __nv_bfloat16* __restrict__ k,
                                              const __nv_bfloat16* __restrict__ v,
                                              int length, int blk0, int blk1, float scale,
                                              float (&m)[G], float (&l)[G], float (&out)[G]) {
  extern __shared__ __align__(16) unsigned char stage[];  // kStageBytes
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* vs = ks + kBlockS * kD;
  __shared__ float s[G][kBlockS];
  __shared__ float red[kWarps][G];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid % kLanesPerRow;  // columns [sub * 8, sub * 8 + 8)
  const int row_in_pass = tid / kLanesPerRow;

  float qf[G][8], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    widen8(*reinterpret_cast<const uint4*>(q + g * kD + sub * 8), qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  for (int blk = blk0; blk < blk1; ++blk) {
    const int row0 = blk * kBlockS;
    const int nrows = min(kBlockS, length - row0);
    stage_block(ks, k + (size_t)row0 * kD, nrows);
    stage_block(vs, v + (size_t)row0 * kD, nrows);
    wait_staged<1>();  // K has landed; V is still in flight

    // scores s[g][r] = scale * q[g] . k[row0 + r]
    for (int r = row_in_pass; r - row_in_pass < nrows; r += kRowsPerPass) {
      float kf[8];
      widen8(*reinterpret_cast<const uint4*>(ks + r * kD + sub * 8), kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(qf[g][i], kf[i], dot);
#pragma unroll
        for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);  // stays inside the 16 lanes
        if (sub == 0 && r < nrows) s[g][r] = dot * scale;
      }
    }
    __syncthreads();

    // softmax statistics, one row per thread
    float sv[G], mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sv[g] = tid < nrows ? s[g][tid] : -INFINITY;
      mx[g] = sv[g];
    }
    block_reduce<G, true>(mx, red);
    float m_new[G], corr[G], sum[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_new[g] = fmaxf(m[g], mx[g]);
      corr[g] = expf(m[g] - m_new[g]);  // 0 on the first block (m = -inf)
      const float p = tid < nrows ? expf(sv[g] - m_new[g]) : 0.f;
      s[g][tid] = p;
      sum[g] = p;
    }
    block_reduce<G, false>(sum, red);  // its barriers also publish the p values
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] = l[g] * corr[g] + sum[g];
      m[g] = m_new[g];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= corr[g];
    }

    // value product: this thread's 8 columns over its rows (p = 0 and v = 0 past nrows)
    wait_staged<0>();
    for (int r = row_in_pass; r - row_in_pass < nrows; r += kRowsPerPass) {
      float vf[8];
      widen8(*reinterpret_cast<const uint4*>(vs + r * kD + sub * 8), vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = s[g][r];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
      }
    }
    __syncthreads();  // s and the staged blocks are rewritten by the next block
  }

  // sum the 16 row groups: two per warp (lanes xor 16), then the warps in order; the
  // partial sums [kWarps][G][kD] fp32 reuse the staging buffer, free after the last block
  float(*part)[G][kD] = reinterpret_cast<float(*)[G][kD]>(stage);
  static_assert(kWarps * 8 * kD * sizeof(float) <= kStageBytes, "partial sums fit the stage");
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], 16);
  if (lane < kLanesPerRow) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) part[warp][g][sub * 8 + i] = acc[g][i];
  }
  __syncthreads();
  if (tid < kD) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float t = part[0][g][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t += part[w][g][tid];
      out[g] = t;
    }
  }
}

// K1, pass 1: grid (n_split, B * H_kv).
template <int G>
__global__ void __launch_bounds__(kThreads)
flash_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, float* __restrict__ m_part,
                   float* __restrict__ l_part, float* __restrict__ acc_part, int S, int length,
                   int n_split, float scale) {
  const int split = blockIdx.x, bh = blockIdx.y;
  float m[G], l[G], acc[G];
  attend_blocks<G>(q + (size_t)bh * G * kD, k + (size_t)bh * S * kD, v + (size_t)bh * S * kD,
                   length, split, split + 1, scale, m, l, acc);
  const size_t base = ((size_t)bh * n_split + split) * G;
  if (threadIdx.x < kD) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (threadIdx.x == 0) {
        m_part[base + g] = m[g];
        l_part[base + g] = l[g];
      }
      acc_part[(base + g) * kD + threadIdx.x] = acc[g];
    }
  }
}

// K1, pass 2: grid (B * H_kv), kD threads; merges the splits of each query row.
template <int G>
__global__ void __launch_bounds__(kD)
flash_combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                     const float* __restrict__ acc_part, __nv_bfloat16* __restrict__ out,
                     int n_split) {
  const int bh = blockIdx.x, d = threadIdx.x;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = -INFINITY;
    for (int i = 0; i < n_split; ++i) mx = fmaxf(mx, m_part[((size_t)bh * n_split + i) * G + g]);
    float l = 0.f, o = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const size_t idx = ((size_t)bh * n_split + i) * G + g;
      const float w = expf(m_part[idx] - mx);
      l += l_part[idx] * w;
      o += acc_part[idx * kD + d] * w;
    }
    out[((size_t)bh * G + g) * kD + d] = __float2bfloat16(o / l);
  }
}

// K2: grid (B * H_kv); one CTA walks every valid block of its (batch row, kv head).
template <int G>
__global__ void __launch_bounds__(kThreads)
single_pass_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S,
                   int length, float scale) {
  const int bh = blockIdx.x;
  const int n_blocks = (length + kBlockS - 1) / kBlockS;
  float m[G], l[G], acc[G];
  attend_blocks<G>(q + (size_t)bh * G * kD, k + (size_t)bh * S * kD, v + (size_t)bh * S * kD,
                   length, 0, n_blocks, scale, m, l, acc);
  if (threadIdx.x < kD) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      out[((size_t)bh * G + g) * kD + threadIdx.x] = __float2bfloat16(acc[g] / l[g]);
  }
}

// Lets `kernel` take the kStageBytes (128 KB) of dynamic shared memory, above the 48 KB
// default; set once per kernel (a function-local static is initialised once).
template <typename Kernel>
cudaError_t allow_stage(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
}

template <int G>
int launch_flash(const void* q, const void* k, const void* v, void* out, void* m_part,
                 void* l_part, void* acc_part, int BH, int S, int length, int n_split,
                 float scale, cudaStream_t stream) {
  static const cudaError_t attr = allow_stage(flash_split_kernel<G>);
  if (attr != cudaSuccess) return attr;
  flash_split_kernel<G><<<dim3(n_split, BH), kThreads, kStageBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<float*>(acc_part), S, length, n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_combine_kernel<G><<<BH, kD, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<__nv_bfloat16*>(out), n_split);
  return cudaGetLastError();
}

template <int G>
int launch_single(const void* q, const void* k, const void* v, void* out, int BH, int S,
                  int length, float scale, cudaStream_t stream) {
  static const cudaError_t attr = allow_stage(single_pass_kernel<G>);
  if (attr != cudaSuccess) return attr;
  single_pass_kernel<G><<<BH, kThreads, kStageBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, length, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, 1, H, D], k/v [B, H_kv, S, D], out [B, 1, H, D]: bf16, contiguous, D = 128.
// Scratch: m_part/l_part [B*H_kv, n_split, G], acc_part [B*H_kv, n_split, G, D] fp32.
extern "C" int zt_flash_decode_attention(const void* q, const void* k, const void* v, void* out,
                                         void* m_part, void* l_part, void* acc_part, int B,
                                         int Hkv, int G, int S, int length, int n_split,
                                         float scale, void* stream) {
  const int BH = B * Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch_flash<1>(q, k, v, out, m_part, l_part, acc_part, BH, S, length, n_split, scale, st);
    case 2: return launch_flash<2>(q, k, v, out, m_part, l_part, acc_part, BH, S, length, n_split, scale, st);
    case 4: return launch_flash<4>(q, k, v, out, m_part, l_part, acc_part, BH, S, length, n_split, scale, st);
    case 8: return launch_flash<8>(q, k, v, out, m_part, l_part, acc_part, BH, S, length, n_split, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int zt_decode_attention_single(const void* q, const void* k, const void* v, void* out,
                                          int B, int Hkv, int G, int S, int length, float scale,
                                          void* stream) {
  const int BH = B * Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch_single<1>(q, k, v, out, BH, S, length, scale, st);
    case 2: return launch_single<2>(q, k, v, out, BH, S, length, scale, st);
    case 4: return launch_single<4>(q, k, v, out, BH, S, length, scale, st);
    case 8: return launch_single<8>(q, k, v, out, BH, S, length, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
