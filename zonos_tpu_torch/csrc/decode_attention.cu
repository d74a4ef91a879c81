// K1 + K2: one-token GQA decode attention over a bf16, f8 (e4m3) or int8 KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in zonos_tpu/ops/pallas_kernels.py:
//   K1 flash_decode_attention_pallas (:147; body _flash_decode_kernel :100)
//   K2 decode_attention_pallas       (:58;  body _decode_attn_kernel :37)
// and, for the quantized caches, the XLA read of decode_attention_split
// (zonos_tpu/ops/attention.py:119): the Pallas kernels read an f8 cache by a cast; the
// int8 cache with one fp32 scale per (row, kv head) is read only in XLA there.
//
// What bounds it on an H100: each (batch row, kv head) owns G = H/H_kv query rows (4 on
// the flagship) that read the same cache rows, so every cache byte feeds ~G FLOPs, far
// below the card's ~295 FLOP/byte bf16 ridge.  The floor is reading the valid part of the
// K and V cache from HBM (3.35 TB/s): 2 * B * H_kv * length * D bytes per element size
// (2 for bf16, 1 for f8 and int8, plus 4 bytes of scale per row and kv head for int8).  At
// batch 1 that is ~2 MB at length 2000 in bf16, a few microseconds, so in practice a CTA's
// memory latency and the number of loads it keeps in flight decide the time.
//
// Design:
// - The TPU kernel walks the cache blocks in order on one core and carries (m, l, acc) in
//   VMEM scratch from one grid step to the next.  On the card CTAs run in parallel and in no
//   order, and at batch 1 with CFG there are only 2 * 4 = 8 (batch row, kv head) pairs for
//   132 SMs.  So K1 splits over S: one CTA per (256-row cache block, batch row, kv head)
//   keeps its own fp32 (m, l, acc) for its G query rows, and a second small kernel combines
//   the splits with the usual log-sum-exp rescaling.  Blocks at or past `length` are never
//   launched, so the bytes read scale with the valid length, not the allocated S.
// - K2 is one launch with no global scratch, for the port's dispatcher's short caches
//   (length <= 256), where K1 would launch a single split.  Each (batch row, kv head) is a
//   thread-block cluster of n CTAs (kernels/decode_attention.py cluster_plan: up to 8 CTAs
//   of at least 32 rows while the grid stays within two CTAs per SM, so 8 at batch 1 with
//   CFG, where there are only 8 pairs for 132 SMs; one CTA of up to 256 rows at batch 64
//   with CFG, where one CTA a pair fills the card).  Rank r runs the same row routine over
//   its chunk, then stores its (m, l) into every rank and each slice of its acc into the
//   rank that owns those output columns, through distributed shared memory; after one
//   cluster barrier each rank combines its columns with the usual log-sum-exp rescaling,
//   in rank order.  A cluster's barriers and exchange cost more than they save up to 64
//   rows, where one CTA a pair runs.
// - A CTA (256 threads) stages its rows, up to a 256-row block of K and V (2 x 64 KB in
//   bf16, 2 x 32 KB in f8 or int8), into shared memory with cp.async before it computes
//   anything: every byte it needs is in flight at once, so a block costs one HBM round
//   trip, and the V copy lands while the scores are computed.  Rows at or past `length`
//   are zero-filled, not read.  (Earlier versions loaded rows into registers, 64 rows at a
//   time, and waited for about eight round trips per block: on a cold L2 that was the
//   kernel's time, PERF.md.)
// - From shared memory, 16 lanes cover one 128-wide row with one 16-byte (bf16) or 8-byte
//   (f8, int8) load each, so a warp reads two neighbouring rows.  Scores are reduced over
//   the 16 lanes with 4 shuffles.  Softmax statistics are one row per thread.  The value
//   product uses the same layout (each thread accumulates 8 output columns over its rows)
//   and the 16 row groups are summed at the end in a fixed order.
// - Scores, softmax weights and the accumulators are fp32; q, k, v are widened in
//   registers (an f8 or int8 value is exact in fp32); the output is rounded to bf16 once.
//   Rows at or past `length` are neither read nor computed, so garbage there (even inf/nan)
//   cannot leak in.  All sums run in a fixed order: the result does not change from run to
//   run.
// - Quantized caches (f8, int8): the current token's k and v are held out in bf16 and
//   never read back from the cache, as in decode_attention_split: the kernels attend over
//   cache rows [0, pos) plus that one row, and the caller writes the row afterwards.  K2's
//   rank 0 starts its online softmax from the held-out row (m = its score, l = 1, acc = its
//   v; at pos 0 that row is all there is); K1's combine pass adds it beside the splits.
//   For int8 the row scale multiplies the score after the 1/sqrt(D) scale and the softmax
//   weight before the value product, where decode_attention_split folds them; the scales
//   of a block are staged beside it.
//
// C interface (ctypes): every entry point returns cudaGetLastError() after its launches.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kD = 128;
constexpr int kBlockS = 256;
constexpr int kThreads = 256;  // one softmax row per thread: kThreads == kBlockS
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerRow = 16;  // 16 lanes x 8 values = one 128-wide row
constexpr int kRowsPerPass = kThreads / kLanesPerRow;
constexpr int kMaxG = 8;
constexpr int kMaxCluster = 8;  // K2's CTAs per cluster, the portable limit
static_assert(kThreads == kBlockS, "softmax statistics take one row per thread");
static_assert(kD == kLanesPerRow * 8, "a row is 16 lanes of 8 values");

using bf16 = __nv_bfloat16;
using f8 = __nv_fp8_e4m3;

template <typename T>
constexpr bool kQuantized = !std::is_same<T, bf16>::value;  // held-out current row
template <typename T>
constexpr bool kScaled = std::is_same<T, int8_t>::value;  // per-row fp32 scales
// dynamic shared memory: the staged K and V blocks, [kBlockS][kD] of T each
template <typename T>
constexpr int kStageBytes = 2 * kBlockS * kD * (int)sizeof(T);
// the row-group partial sums [kWarps][G][kD] fp32, which reuse the stage after the last block
template <int G>
constexpr int kPartBytes = kWarps * G * kD * (int)sizeof(float);
static_assert(kPartBytes<kMaxG> <= kStageBytes<int8_t>, "the partial sums fit a whole stage");

__device__ __forceinline__ void widen8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Widens the 8 values of T at p (16-byte aligned for bf16, 8-byte aligned otherwise).
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[8]) {
  if constexpr (std::is_same<T, bf16>::value) {
    widen8(*reinterpret_cast<const uint4*>(p), f);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const unsigned char* b = reinterpret_cast<const unsigned char*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (std::is_same<T, f8>::value) {
        f8 v;
        v.__x = b[i];
        f[i] = static_cast<float>(v);
      } else {
        f[i] = static_cast<float>(static_cast<int8_t>(b[i]));
      }
    }
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

// Starts the asynchronous copy of cache rows [0, stage_rows) of `src` into `dst` as one
// cp.async group; rows at or past nrows are zero-filled without reading global memory.
// Consecutive threads copy consecutive 16-byte pieces, so the reads are coalesced.  K1
// stages whole 256-row blocks (stage_rows = kBlockS); K2 stages its chunk up to the end of
// its last 16-row pass.
template <typename T>
__device__ __forceinline__ void stage_block(T* dst, const T* src, int nrows, int stage_rows) {
  constexpr int kChunksPerRow = kD * (int)sizeof(T) / 16;
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
#pragma unroll
  for (int i = 0; i < kBlockS * kChunksPerRow / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c >= stage_rows * kChunksPerRow) break;
    const bool in = c / kChunksPerRow < nrows;
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(d + c * 16));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                 "l"(in ? s + c * 16 : s), "r"(in ? 16 : 0));
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

// The cache rows of one (batch row, kv head) and, for a quantized cache, what comes with
// them: ks/vs [S] fp32 row scales (int8) and the held-out current row k_new/v_new [D] bf16.
template <typename T>
struct Rows {
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  const bf16* k_new;
  const bf16* v_new;
};

// Online softmax over cache rows [r0, r1) of one (batch row, kv head), in blocks of up to
// kBlockS rows, started from the held-out row when kHeldOut and held_out (else m = -inf,
// l = 0, and nothing at all for an empty range).  q: [G, D] bf16; the cache rows [S, D] of
// T.  kFullStage stages whole blocks (K1); otherwise a block is staged to the end of its
// last 16-row pass (K2's short chunks).  On return every thread holds the running max m and
// sum l of each query row, and threads t < D hold out[g] = sum_r p_r * v[r][t].
template <int G, typename T, bool kHeldOut, bool kFullStage>
__device__ __forceinline__ void attend_rows(const bf16* __restrict__ q, const Rows<T>& rows,
                                            int r0, int r1, bool held_out, float scale,
                                            float (&m)[G], float (&l)[G], float (&out)[G]) {
  extern __shared__ __align__(16) unsigned char stage[];  // stage_bytes<T>(stage_rows_max)
  T* ks = reinterpret_cast<T*>(stage);
  const int stage_rows_max =
      kFullStage ? kBlockS
                 : min(kBlockS, (r1 - r0 + kRowsPerPass - 1) / kRowsPerPass * kRowsPerPass);
  T* vs = ks + stage_rows_max * kD;
  __shared__ float s[G][kBlockS];
  __shared__ float red[kWarps][G];
  __shared__ float kscale[kBlockS], vscale[kBlockS];
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
  if (kHeldOut && held_out) {
    float kn[8], vn[8];
    widen8(*reinterpret_cast<const uint4*>(rows.k_new + sub * 8), kn);
    widen8(*reinterpret_cast<const uint4*>(rows.v_new + sub * 8), vn);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) dot = fmaf(qf[g][i], kn[i], dot);
#pragma unroll
      for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      m[g] = dot * scale;
      l[g] = 1.f;
      if (row_in_pass == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = vn[i];
      }
    }
  }

  for (int row0 = r0; row0 < r1; row0 += kBlockS) {
    const int nrows = min(kBlockS, r1 - row0);
    const int stage_rows =
        kFullStage ? kBlockS : (nrows + kRowsPerPass - 1) / kRowsPerPass * kRowsPerPass;
    stage_block(ks, rows.k + (size_t)row0 * kD, nrows, stage_rows);
    stage_block(vs, rows.v + (size_t)row0 * kD, nrows, stage_rows);
    if constexpr (kScaled<T>) {
      kscale[tid] = tid < nrows ? rows.ks[row0 + tid] : 0.f;
      vscale[tid] = tid < nrows ? rows.vs[row0 + tid] : 0.f;
    }
    wait_staged<1>();  // K has landed; V is still in flight

    // scores s[g][r] = scale * q[g] . k[row0 + r] (times the row's scale for int8)
    for (int r = row_in_pass; r - row_in_pass < nrows; r += kRowsPerPass) {
      float kf[8];
      load8(ks + r * kD + sub * 8, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(qf[g][i], kf[i], dot);
#pragma unroll
        for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);  // stays inside the 16 lanes
        if (sub == 0 && r < nrows) {
          float sc = dot * scale;
          if constexpr (kScaled<T>) sc *= kscale[r];
          s[g][r] = sc;
        }
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
      load8(vs + r * kD + sub * 8, vf);
      const float row_scale = kScaled<T> ? vscale[r] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = kScaled<T> ? s[g][r] * row_scale : s[g][r];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
      }
    }
    __syncthreads();  // s, the scales and the staged blocks are rewritten by the next block
  }

  // sum the 16 row groups: two per warp (lanes xor 16), then the warps in order; the
  // partial sums [kWarps][G][kD] fp32 reuse the staging buffer, free after the last block
  // (the launch gives it at least kPartBytes<G>)
  float(*part)[G][kD] = reinterpret_cast<float(*)[G][kD]>(stage);
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

// Pointers of one call; a bf16 cache has no scales and no held-out row.
template <typename T>
struct Call {
  const bf16* q;  // [B*H_kv, G, D]
  const T* k;     // [B*H_kv, S, D]
  const T* v;
  const float* ks;  // [B*H_kv, S] (int8)
  const float* vs;
  const bf16* k_new;  // [B*H_kv, D] (quantized caches)
  const bf16* v_new;
  bf16* out;  // [B*H_kv, G, D]
  int S, length;
  float scale;

  __device__ Rows<T> rows(int bh) const {
    return {k + (size_t)bh * S * kD, v + (size_t)bh * S * kD,
            kScaled<T> ? ks + (size_t)bh * S : nullptr, kScaled<T> ? vs + (size_t)bh * S : nullptr,
            kQuantized<T> ? k_new + (size_t)bh * kD : nullptr,
            kQuantized<T> ? v_new + (size_t)bh * kD : nullptr};
  }
};

// K1, pass 1: grid (n_split, B * H_kv).  The held-out row is left to the combine pass.
template <int G, typename T>
__global__ void __launch_bounds__(kThreads)
flash_split_kernel(Call<T> c, float* __restrict__ m_part, float* __restrict__ l_part,
                   float* __restrict__ acc_part, int n_split) {
  const int split = blockIdx.x, bh = blockIdx.y;
  float m[G], l[G], acc[G];
  const int r0 = split * kBlockS;
  attend_rows<G, T, false, true>(c.q + (size_t)bh * G * kD, c.rows(bh), r0,
                                 min(r0 + kBlockS, c.length), false, c.scale, m, l, acc);
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

// K1, pass 2: grid (B * H_kv), kD threads; merges the splits of each query row and, for a
// quantized cache, the held-out row.
template <int G, typename T>
__global__ void __launch_bounds__(kD)
flash_combine_kernel(Call<T> c, const float* __restrict__ m_part,
                     const float* __restrict__ l_part, const float* __restrict__ acc_part,
                     int n_split) {
  const int bh = blockIdx.x, d = threadIdx.x;
  float s_new[G] = {}, v_new = 0.f;
  if constexpr (kQuantized<T>) {
    __shared__ float red[kD / 32][G];
    const float kn = __bfloat162float(c.k_new[(size_t)bh * kD + d]);
    v_new = __bfloat162float(c.v_new[(size_t)bh * kD + d]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float t = warp_sum(__bfloat162float(c.q[((size_t)bh * G + g) * kD + d]) * kn);
      if ((d & 31) == 0) red[d >> 5][g] = t;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float t = red[0][g];
#pragma unroll
      for (int w = 1; w < kD / 32; ++w) t += red[w][g];
      s_new[g] = t * c.scale;
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = kQuantized<T> ? s_new[g] : -INFINITY;
    for (int i = 0; i < n_split; ++i) mx = fmaxf(mx, m_part[((size_t)bh * n_split + i) * G + g]);
    float l = 0.f, o = 0.f;
    if constexpr (kQuantized<T>) {
      const float w = expf(s_new[g] - mx);
      l = w;
      o = v_new * w;
    }
    for (int i = 0; i < n_split; ++i) {
      const size_t idx = ((size_t)bh * n_split + i) * G + g;
      const float w = expf(m_part[idx] - mx);
      l += l_part[idx] * w;
      o += acc_part[idx * kD + d] * w;
    }
    c.out[((size_t)bh * G + g) * kD + d] = __float2bfloat16(o / l);
  }
}

// K2: grid (n, B * H_kv), launched as clusters of n CTAs along x, one cluster per (batch
// row, kv head).  Rank r attends cache rows [r * chunk, min((r + 1) * chunk, length)) (rank
// 0 also the held-out row of a quantized cache).  Each rank owns a slice of `width` of the
// 128 output columns; rank r stores its m and l into every rank's shared memory and each
// slice of its acc into the rank that owns it (the exchange area, `xchg` bytes into the
// dynamic shared memory, past the stage), then arrives on the cluster barrier with release
// semantics and waits on it (acquire): each rank then combines the n partials of its own
// columns in rank order from its own shared memory.  An earlier relaxed barrier phase,
// waited on only just before the remote stores, makes sure every rank has started.  One
// CTA (n = 1) writes its output directly.
template <int G, typename T>
__global__ void __launch_bounds__(kThreads)
cluster_pass_kernel(Call<T> c, int chunk, int xchg) {
  const int n = gridDim.x, rank = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  if (n > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int r0 = min(rank * chunk, c.length), r1 = min(r0 + chunk, c.length);
  float m[G], l[G], acc[G];
  attend_rows<G, T, kQuantized<T>, false>(c.q + (size_t)bh * G * kD, c.rows(bh), r0, r1,
                                          rank == 0, c.scale, m, l, acc);
  bf16* out = c.out + (size_t)bh * G * kD;
  if (n == 1) {
    if (tid < kD) {
#pragma unroll
      for (int g = 0; g < G; ++g) out[g * kD + tid] = __float2bfloat16(acc[g] / l[g]);
    }
    return;
  }
  // the exchange area: m [n][G], l [n][G], acc [n][G][width] fp32 (width columns a rank)
  const int width = (kD + n - 1) / n;
  extern __shared__ __align__(16) unsigned char dyn[];
  float* xm = reinterpret_cast<float*>(dyn + xchg);
  float* xl = xm + n * G;
  float* xacc = xl + n * G;
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank has started
  if (tid < kD) {  // column tid goes to the rank that owns it
    float* dst = cluster.map_shared_rank(xacc, tid / width) + rank * G * width + tid % width;
#pragma unroll
    for (int g = 0; g < G; ++g) dst[g * width] = acc[g];
  }
  if (tid < n) {  // m and l go to every rank
    float* dm = cluster.map_shared_rank(xm, tid) + rank * G;
    float* dl = cluster.map_shared_rank(xl, tid) + rank * G;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      dm[g] = m[g];
      dl[g] = l[g];
    }
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const int cols = min(width, kD - rank * width);
  for (int i = tid; i < G * cols; i += kThreads) {
    const int g = i / cols, j = i % cols;
    float mx = -INFINITY;
    for (int r = 0; r < n; ++r) mx = fmaxf(mx, xm[r * G + g]);
    float lsum = 0.f, o = 0.f;
    for (int r = 0; r < n; ++r) {
      const float w = expf(xm[r * G + g] - mx);  // 0 for an empty rank
      lsum += xl[r * G + g] * w;
      o += xacc[(r * G + g) * width + j] * w;
    }
    out[g * kD + rank * width + j] = __float2bfloat16(o / lsum);
  }
}

// Lets `kernel` take its staging buffer (up to 128 KB) of dynamic shared memory, above the
// 48 KB default; set once per kernel (a function-local static is initialised once).
template <typename Kernel>
cudaError_t allow_stage(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int G, typename T>
int launch_flash(const Call<T>& c, void* m_part, void* l_part, void* acc_part, int BH,
                 int n_split, cudaStream_t stream) {
  static const cudaError_t attr = allow_stage(flash_split_kernel<G, T>, kStageBytes<T>);
  if (attr != cudaSuccess) return attr;
  if (n_split > 0) {  // a quantized cache at pos 0 has no cache rows: only the held-out row
    flash_split_kernel<G, T><<<dim3(n_split, BH), kThreads, kStageBytes<T>, stream>>>(
        c, static_cast<float*>(m_part), static_cast<float*>(l_part),
        static_cast<float*>(acc_part), n_split);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_combine_kernel<G, T><<<BH, kD, 0, stream>>>(
      c, static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), n_split);
  return cudaGetLastError();
}

// K2's launch: clusters of n CTAs (1 to 8, the portable limit) of `chunk` rows each
// (kernels/decode_attention.py cluster_plan); dynamic shared memory for the K and V stages of
// one chunk (at most one block) and at least the row-group partial sums.
template <int G, typename T>
int launch_single(const Call<T>& c, int BH, int n, int chunk, cudaStream_t stream) {
  if (n < 1 || n > kMaxCluster || chunk < 0 || (long long)n * chunk < c.length)
    return cudaErrorInvalidValue;
  static const cudaError_t attr = allow_stage(
      cluster_pass_kernel<G, T>, kStageBytes<T> + kMaxCluster * G * (2 + kD) * (int)sizeof(float));
  if (attr != cudaSuccess) return attr;
  const int stage_rows = min(kBlockS, (chunk + kRowsPerPass - 1) / kRowsPerPass * kRowsPerPass);
  const int xchg = max(2 * stage_rows * kD * (int)sizeof(T), kPartBytes<G>);  // 16-byte multiple
  const int width = (kD + n - 1) / n;
  const int smem = xchg + (n > 1 ? n * G * (2 + width) * (int)sizeof(float) : 0);
  cudaLaunchAttribute cluster_dim[1];
  cluster_dim[0].id = cudaLaunchAttributeClusterDimension;
  cluster_dim[0].val.clusterDim.x = n;
  cluster_dim[0].val.clusterDim.y = 1;
  cluster_dim[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n, BH);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = cluster_dim;
  config.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, cluster_pass_kernel<G, T>, c, chunk, xchg);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
int flash_by_group(const Call<T>& c, void* m_part, void* l_part, void* acc_part, int BH, int G,
                   int n_split, cudaStream_t st) {
  switch (G) {
    case 1: return launch_flash<1, T>(c, m_part, l_part, acc_part, BH, n_split, st);
    case 2: return launch_flash<2, T>(c, m_part, l_part, acc_part, BH, n_split, st);
    case 4: return launch_flash<4, T>(c, m_part, l_part, acc_part, BH, n_split, st);
    case 8: return launch_flash<8, T>(c, m_part, l_part, acc_part, BH, n_split, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int single_by_group(const Call<T>& c, int BH, int G, int n, int chunk, cudaStream_t st) {
  switch (G) {
    case 1: return launch_single<1, T>(c, BH, n, chunk, st);
    case 2: return launch_single<2, T>(c, BH, n, chunk, st);
    case 4: return launch_single<4, T>(c, BH, n, chunk, st);
    case 8: return launch_single<8, T>(c, BH, n, chunk, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
Call<T> make_call(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                  const void* k_new, const void* v_new, void* out, int S, int length,
                  float scale) {
  return {static_cast<const bf16*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const float*>(ks), static_cast<const float*>(vs),
          static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
          static_cast<bf16*>(out), S, length, scale};
}

}  // namespace

// q [B, 1, H, D], k/v [B, H_kv, S, D], out [B, 1, H, D]: bf16, contiguous, D = 128.
// Scratch: m_part/l_part [B*H_kv, n_split, G], acc_part [B*H_kv, n_split, G, D] fp32.
extern "C" int zt_flash_decode_attention(const void* q, const void* k, const void* v, void* out,
                                         void* m_part, void* l_part, void* acc_part, int B,
                                         int Hkv, int G, int S, int length, int n_split,
                                         float scale, void* stream) {
  const Call<bf16> c = make_call<bf16>(q, k, v, nullptr, nullptr, nullptr, nullptr, out, S,
                                       length, scale);
  return flash_by_group(c, m_part, l_part, acc_part, B * Hkv, G, n_split,
                        static_cast<cudaStream_t>(stream));
}

// K2: clusters of n CTAs of `chunk` rows (n * chunk >= length).
extern "C" int zt_decode_attention_single(const void* q, const void* k, const void* v, void* out,
                                          int B, int Hkv, int G, int S, int length, int n,
                                          int chunk, float scale, void* stream) {
  const Call<bf16> c = make_call<bf16>(q, k, v, nullptr, nullptr, nullptr, nullptr, out, S,
                                       length, scale);
  return single_by_group(c, B * Hkv, G, n, chunk, static_cast<cudaStream_t>(stream));
}

// Quantized caches: storage 1 = f8 e4m3, 2 = int8 with k_scale/v_scale [B, H_kv, S] fp32.
// k/v [B, H_kv, S, D] of that type; k_new/v_new [B, 1, H_kv, D] bf16, the current token's,
// held out; cache rows [0, pos) are attended (pos may be 0).  Scratch as above, n_split =
// ceil(pos / 256).
extern "C" int zt_flash_decode_attention_q(int storage, const void* q, const void* k,
                                           const void* v, const void* k_scale,
                                           const void* v_scale, const void* k_new,
                                           const void* v_new, void* out, void* m_part,
                                           void* l_part, void* acc_part, int B, int Hkv, int G,
                                           int S, int pos, int n_split, float scale,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage == 1)
    return flash_by_group(make_call<f8>(q, k, v, nullptr, nullptr, k_new, v_new, out, S, pos,
                                        scale),
                          m_part, l_part, acc_part, B * Hkv, G, n_split, st);
  if (storage == 2)
    return flash_by_group(make_call<int8_t>(q, k, v, k_scale, v_scale, k_new, v_new, out, S,
                                            pos, scale),
                          m_part, l_part, acc_part, B * Hkv, G, n_split, st);
  return cudaErrorInvalidValue;
}

extern "C" int zt_decode_attention_single_q(int storage, const void* q, const void* k,
                                            const void* v, const void* k_scale,
                                            const void* v_scale, const void* k_new,
                                            const void* v_new, void* out, int B, int Hkv, int G,
                                            int S, int pos, int n, int chunk, float scale,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage == 1)
    return single_by_group(make_call<f8>(q, k, v, nullptr, nullptr, k_new, v_new, out, S, pos,
                                         scale),
                           B * Hkv, G, n, chunk, st);
  if (storage == 2)
    return single_by_group(make_call<int8_t>(q, k, v, k_scale, v_scale, k_new, v_new, out, S,
                                             pos, scale),
                           B * Hkv, G, n, chunk, st);
  return cudaErrorInvalidValue;
}
