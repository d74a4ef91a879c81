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
//   132 SMs.  So both kernels split a pair's valid rows over the CTAs of a thread-block
//   cluster, one cluster per pair (kernels/decode_attention.py band_plan and rank_rows):
//   rank r runs the row routine over its contiguous chunk, then stores
//   its (m, l) into every rank and each slice of its acc into the rank that owns those
//   output columns, through distributed shared memory; after one cluster barrier each rank
//   combines its columns with the usual log-sum-exp rescaling, in rank order.  One launch,
//   no global scratch.  Rows at or past `length` are never read, so the bytes read scale
//   with the valid length, not the allocated S.
// - The length is read from the card, as the Pallas kernels take it as a scalar-prefetch
//   operand: a decode step is one program with no host read, replayed as a CUDA graph.  The
//   host fixes the grid per band of lengths (kernels/decode_attention.py band_plan): the
//   cluster size n and the shared memory the longest chunk of the band needs.  Every CTA
//   reads the length (clamped to the band, so a wrong value cannot reach past the cache)
//   and computes the split itself: one CTA up to 2 * min_rows rows, else ceil(length /
//   min_rows) CTAs at most n, each taking the same multiple of 16 rows.  A rank past the
//   split, or whose chunk lies past the length, contributes a neutral partial (m = -inf,
//   l = 0, acc = 0) to the combine, which rank 0's rows (or held-out row) keep finite.  When
//   the split is one CTA, rank 0 writes the output and the cluster's other CTAs exit at
//   once, with no cluster barrier on either side.
// - The split is fixed by the band alone (kernels/decode_attention.py band_plan): n ranks
//   of a pair's rows, each rank's partial computed the same way and the partials combined in
//   rank order, so a row's output is the same bits alone and in any batch.  How many CTAs
//   run a pair's ranks (the cluster's size g, a divisor of n) follows the number of pairs,
//   to fill the card: each CTA runs n / g ranks one after another, and the combine reads the
//   same partials whatever g is.
// - K2 (`cluster_pass_kernel`, the band of lengths up to 256): up to 8 ranks (the portable
//   cluster limit) of at least 32 rows; a rank stages its whole chunk (up to 256 rows)
//   before it computes.  Up to 64 rows one rank, where a split's exchange costs more than it
//   saves.  Clusters of 8 while the grid stays within two CTAs per SM, fewer beyond.
// - K1 (`flash_cluster_kernel`, the bands past 256): up to 16 ranks (clusters of 16 are a
//   non-portable size, allowed by a function attribute) of at least 64 rows, so that the 8
//   pairs of batch 1 with CFG become 128 CTAs on 132 SMs; fewer CTAs a pair once the pairs
//   fill the card.  A rank streams its chunk
//   through a ring of two 32 KB stages (64 rows of bf16 K and V, 128 of f8 or int8),
//   carrying (m, l, acc) online: the next stage's copies are in flight while the current
//   one is computed.  A CTA takes at most 64 KB of shared memory, so a 16-CTA cluster fits
//   in a GPC (zt_flash_max_active_clusters asks the card how many fit).
// - Copies go by cp.async (every byte of a stage in flight at once), K and V as two groups
//   so that V lands while the scores are computed; rows at or past `length` are
//   zero-filled, not read.  16 lanes cover one 128-wide row with one 16-byte (bf16) or
//   8-byte (f8, int8) load each, so a warp reads two neighbouring rows, and a score is
//   reduced over the 16 lanes with 4 shuffles.  Softmax statistics are one row per thread;
//   the value product uses the same layout (each thread accumulates 8 output columns over
//   its rows), and the 16 row groups are summed at the end in a fixed order.
// - Scores, softmax weights and the accumulators are fp32; q, k, v are widened in
//   registers (an f8 or int8 value is exact in fp32); the output is rounded to bf16 once.
//   Rows at or past `length` are neither read nor computed, so garbage there (even inf/nan)
//   cannot leak in.  All sums run in a fixed order: the result does not change from run to
//   run.
// - Quantized caches (f8, int8): the current token's k and v are held out in bf16 and
//   never read back from the cache, as in decode_attention_split: the kernels attend over
//   cache rows [0, pos) plus that one row, and the caller writes the row afterwards.  Rank
//   0 starts its online softmax from the held-out row (m = its score, l = 1, acc = its v;
//   at pos 0 that row is all there is).  For int8 the row scale multiplies the score after
//   the 1/sqrt(D) scale and the softmax weight before the value product, where
//   decode_attention_split folds them; the scales of a stage are copied beside it.
//
// C interface (ctypes): every entry point returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kD = 128;
constexpr int kBlockS = 256;  // K2 stages a chunk of up to this many rows whole
constexpr int kThreads = 256;  // one softmax row per thread: a stage holds at most kThreads rows
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerRow = 16;  // 16 lanes x 8 values = one 128-wide row
constexpr int kRowsPerPass = kThreads / kLanesPerRow;
constexpr int kMaxG = 8;
constexpr int kMaxCluster = 8;  // K2's CTAs per cluster, the portable limit
constexpr int kMaxFlashCluster = 16;  // K1's, the largest cluster Hopper launches
constexpr int kSlotBytes = 32 * 1024;  // one of K1's ring stages: its K and V rows
constexpr int kFlashRing = 2;
static_assert(kD == kLanesPerRow * 8, "a row is 16 lanes of 8 values");

using bf16 = __nv_bfloat16;
using f8 = __nv_fp8_e4m3;

template <typename T>
constexpr bool kQuantized = !std::is_same<T, bf16>::value;  // held-out current row
template <typename T>
constexpr bool kScaled = std::is_same<T, int8_t>::value;  // per-row fp32 scales
// K2's dynamic shared memory at most: one chunk's K and V, [kBlockS][kD] of T each
template <typename T>
constexpr int kStageBytes = 2 * kBlockS * kD * (int)sizeof(T);
// K1's stage: the rows of K and V that fill one ring slot (64 bf16, 128 f8 or int8)
template <typename T>
constexpr int kFlashStageRows = kSlotBytes / (2 * kD * (int)sizeof(T));
// the row-group partial sums [kWarps][G][kD] fp32, which reuse the stages after the last one
template <int G>
constexpr int kPartBytes = kWarps * G * kD * (int)sizeof(float);
static_assert(kPartBytes<kMaxG> <= kSlotBytes, "the partial sums fit one ring slot");

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

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

// Widens the 4 values of T at p (8-byte aligned for bf16, 4-byte aligned otherwise).
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&f)[4]) {
  if constexpr (std::is_same<T, bf16>::value) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
    const unsigned raw = *reinterpret_cast<const unsigned*>(p);
    const unsigned char* b = reinterpret_cast<const unsigned char*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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

// Starts the asynchronous copy of cache rows [0, stage_rows) of `src` into `dst` (not yet
// committed); rows at or past nrows are zero-filled without reading global memory.
// Consecutive threads copy consecutive 16-byte pieces, so the reads are coalesced.
template <typename T, int kRows>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int nrows, int stage_rows) {
  constexpr int kChunksPerRow = kD * (int)sizeof(T) / 16;
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
#pragma unroll
  for (int i = 0; i < (kRows * kChunksPerRow + kThreads - 1) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c >= stage_rows * kChunksPerRow) break;
    const bool in = c / kChunksPerRow < nrows;
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(d + c * 16));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                 "l"(in ? s + c * 16 : s), "r"(in ? 16 : 0));
  }
}

// The same for an int8 cache's row scales: [0, stage_rows), zero past nrows.
__device__ __forceinline__ void copy_scales(float* dst, const float* src, int nrows,
                                            int stage_rows) {
  const int r = threadIdx.x;
  if (r < stage_rows) {
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst + r));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa),
                 "l"(r < nrows ? src + r : src), "r"(r < nrows ? 4 : 0));
  }
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }

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

// Online softmax over cache rows [r0, r1) of one (batch row, kv head), in stages of up to
// kStageRows rows, started from the held-out row when kHeldOut and held_out (else m = -inf,
// l = 0, and nothing at all for an empty range).  q: this thread's 8 values of each of the
// G query rows [G, D] bf16, loaded by the caller; the cache rows [S, D] of T.  The stages
// go through a ring of kRing slots of the dynamic shared memory, each slot the K and then
// the V rows of one stage (a slot holds min(kStageRows, r1 - r0 rounded up to a 16-row
// pass) rows), copied as two cp.async groups so that V lands while the scores are computed;
// with kRing > 1 (K1) the copies of stage i + 1 are started before stage i is computed, and
// the first stage's before anything else.  K2 (kRing = 1) stages its chunk whole.  On
// return every thread holds the running max m and sum l of each query row, and threads
// t < D hold out[g] = sum_r p_r * v[r][t].
template <int G, typename T, bool kHeldOut, int kStageRows, int kRing>
__device__ __forceinline__ void attend_rows(const uint4 (&q)[G], const Rows<T>& rows,
                                            int r0, int r1, bool held_out, float scale,
                                            float (&m)[G], float (&l)[G], float (&out)[G]) {
  static_assert(kStageRows <= kThreads && kStageRows % kRowsPerPass == 0,
                "softmax statistics take one row per thread");
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ float s[G][kStageRows];
  __shared__ float red[kWarps][G];
  __shared__ float kscale[kRing][kScaled<T> ? kStageRows : 1];
  __shared__ float vscale[kRing][kScaled<T> ? kStageRows : 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid % kLanesPerRow;  // columns [sub * 8, sub * 8 + 8)
  const int row_in_pass = tid / kLanesPerRow;
  const int slot_rows = min(kStageRows, round_up(r1 - r0, kRowsPerPass));
  const int n_stages = (r1 - r0 + kStageRows - 1) / kStageRows;
  auto slot = [&](int i) {  // stage i's K rows; its V rows follow
    return reinterpret_cast<T*>(stage) + (size_t)(i % kRing) * 2 * slot_rows * kD;
  };
  auto issue = [&](int i) {  // stage i's copies: K (and its scales), then V, two groups
    const int row0 = r0 + i * kStageRows, nrows = min(kStageRows, r1 - row0);
    const int stage_rows = round_up(nrows, kRowsPerPass);
    T* ks = slot(i);
    copy_rows<T, kStageRows>(ks, rows.k + (size_t)row0 * kD, nrows, stage_rows);
    if constexpr (kScaled<T>) copy_scales(kscale[i % kRing], rows.ks + row0, nrows, stage_rows);
    commit_copies();
    copy_rows<T, kStageRows>(ks + slot_rows * kD, rows.v + (size_t)row0 * kD, nrows, stage_rows);
    if constexpr (kScaled<T>) copy_scales(vscale[i % kRing], rows.vs + row0, nrows, stage_rows);
    commit_copies();
  };
  if constexpr (kRing > 1) {
    if (n_stages > 0) issue(0);
  }

  float qf[G][8], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    widen8(q[g], qf[g]);
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

  for (int i = 0; i < n_stages; ++i) {
    const int nrows = min(kStageRows, r1 - r0 - i * kStageRows);
    bool more = false;  // stage i + 1's copies are in flight behind stage i's
    if constexpr (kRing == 1) {
      issue(i);
    } else {
      more = i + 1 < n_stages;
      if (more) issue(i + 1);
    }
    if (more) wait_staged<3>(); else wait_staged<1>();  // K has landed; V may be in flight
    const T* ks = slot(i);
    const T* vs = ks + slot_rows * kD;
    const float* kscl = kscale[i % kRing];
    const float* vscl = vscale[i % kRing];

    // scores s[g][r] = scale * q[g] . k[row0 + r] (times the row's scale for int8)
    for (int r = row_in_pass; r - row_in_pass < nrows; r += kRowsPerPass) {
      float kf[8];
      load8(ks + r * kD + sub * 8, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) dot = fmaf(qf[g][j], kf[j], dot);
#pragma unroll
        for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);  // stays inside the 16 lanes
        if (sub == 0 && r < nrows) {
          float sc = dot * scale;
          if constexpr (kScaled<T>) sc *= kscl[r];
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
      corr[g] = expf(m[g] - m_new[g]);  // 0 on the first stage (m = -inf)
      const float p = tid < nrows ? expf(sv[g] - m_new[g]) : 0.f;
      if (tid < kStageRows) s[g][tid] = p;
      sum[g] = p;
    }
    block_reduce<G, false>(sum, red);  // its barriers also publish the p values
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] = l[g] * corr[g] + sum[g];
      m[g] = m_new[g];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] *= corr[g];
    }

    // value product: this thread's 8 columns over its rows (p = 0 and v = 0 past nrows)
    if (more) wait_staged<2>(); else wait_staged<0>();
    for (int r = row_in_pass; r - row_in_pass < nrows; r += kRowsPerPass) {
      float vf[8];
      load8(vs + r * kD + sub * 8, vf);
      const float row_scale = kScaled<T> ? vscl[r] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = kScaled<T> ? s[g][r] * row_scale : s[g][r];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(p, vf[j], acc[g][j]);
      }
    }
    __syncthreads();  // s, the scales and this slot are rewritten by a later stage
  }

  // sum the 16 row groups: two per warp (lanes xor 16), then the warps in order; the
  // partial sums [kWarps][G][kD] fp32 reuse the staging buffer, free after the last stage
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

// Pointers of one call; a bf16 cache has no scales and no held-out row.  `rows` points at
// the number of cache rows to attend (an int32 on the card), which the kernel clamps to the
// band [lo, hi] its launch was planned for; min_rows sets the split (split_ctas).
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
  const int* rows;
  int S, lo, hi, min_rows;
  int n;  // the split's ranks (kernels/decode_attention.py band_plan), a multiple of the grid's x
  float scale;

  __device__ Rows<T> rows_of(int bh) const {
    return {k + (size_t)bh * S * kD, v + (size_t)bh * S * kD,
            kScaled<T> ? ks + (size_t)bh * S : nullptr, kScaled<T> ? vs + (size_t)bh * S : nullptr,
            kQuantized<T> ? k_new + (size_t)bh * kD : nullptr,
            kQuantized<T> ? v_new + (size_t)bh * kD : nullptr};
  }
};

// The split of `length` rows (kernels/decode_attention.py rank_rows): one CTA up to
// 2 * min_rows rows, else ceil(length / min_rows) CTAs, at most n.
__device__ __forceinline__ int split_ctas(int length, int n, int min_rows) {
  return length <= 2 * min_rows ? 1 : min(n, (length + min_rows - 1) / min_rows);
}

// One cluster per (batch row, kv head): grid (n, B * H_kv), clusters of n CTAs along x.  Of
// them the first `used` (split_ctas) attend: rank r cache rows [r * chunk, min((r + 1) *
// chunk, length)), rank 0 also the held-out row of a quantized cache.  Each used rank owns
// a slice of `width` of the 128 output columns; rank r stores its m and l into every used
// rank's shared memory and each slice of its acc into the rank that owns it (the exchange
// area, `xchg` bytes into the dynamic shared memory, past the stages), then arrives on the
// cluster barrier with release semantics and waits on it (acquire): each used rank then
// combines the partials of its own columns in rank order from its own shared memory.  An
// earlier relaxed barrier phase, waited on only just before the remote stores, makes sure
// every rank has started.  The ranks past `used` take part in both barrier phases and touch
// no shared memory.  A split of one CTA writes its output directly.
template <int G, typename T, bool kFlash>
__device__ __forceinline__ void cluster_attend(const Call<T>& c, int xchg) {
  const int n = gridDim.x, rank = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  // this thread's slice of q, in flight while the length is read (columns (tid % 16) * 8)
  uint4 q[G];
#pragma unroll
  for (int g = 0; g < G; ++g)
    q[g] = *reinterpret_cast<const uint4*>(c.q + ((size_t)bh * G + g) * kD +
                                           tid % kLanesPerRow * 8);
  const int length = min(max(*c.rows, c.lo), c.hi);
  const int used = split_ctas(length, n, c.min_rows);
  const int chunk = round_up((length + used - 1) / used, kRowsPerPass);
  if (used == 1 && rank > 0) return;  // every CTA of the cluster agrees: no barrier below
  if (used > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (rank >= used) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    return;
  }
  const int r0 = min(rank * chunk, length), r1 = min(r0 + chunk, length);
  float m[G], l[G], acc[G];
  constexpr int kStageRows = kFlash ? kFlashStageRows<T> : kBlockS;
  attend_rows<G, T, kQuantized<T>, kStageRows, kFlash ? kFlashRing : 1>(
      q, c.rows_of(bh), r0, r1, rank == 0, c.scale, m, l, acc);
  bf16* out = c.out + (size_t)bh * G * kD;
  if (used == 1) {
    if (tid < kD) {
#pragma unroll
      for (int g = 0; g < G; ++g) out[g * kD + tid] = __float2bfloat16(acc[g] / l[g]);
    }
    return;
  }
  // the exchange area: m [n][G], l [n][G] (the first `used` rows filled), acc [used][G]
  // [width] fp32 (width columns a rank), at most G * (3 * n + kD) floats
  const int width = (kD + used - 1) / used;
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
  if (tid < used) {  // m and l go to every used rank
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
    for (int r = 0; r < used; ++r) mx = fmaxf(mx, xm[r * G + g]);
    float lsum = 0.f, o = 0.f;
    for (int r = 0; r < used; ++r) {
      const float w = expf(xm[r * G + g] - mx);  // 0 for an empty rank
      lsum += xl[r * G + g] * w;
      o += xacc[(r * G + g) * width + j] * w;
    }
    out[g * kD + rank * width + j] = __float2bfloat16(o / lsum);
  }
}

// The same split run by fewer CTAs: grid (g, B * H_kv), clusters of g CTAs along x, where g
// divides the split's n ranks and CTA c runs ranks c * per ... (per = n / g) one after
// another (g = 1: one CTA runs them all).  Each rank's partial is the one its own CTA would
// compute, and the first used_ctas = ceil(used / per) CTAs own the output columns and combine
// the partials in rank order exactly as cluster_attend does, so a row's output is the same
// bits whatever g is; g follows the number of pairs, to fill the card.  After each of its
// ranks a CTA stores the rank's m and l into every owner and its acc into the owner of each
// column (through distributed shared memory when g > 1).
// - K2, whose ranks hold 32 rows (a warp's rows) each: the CTA stages all its ranks' rows at
//   once, and warp v computes rank v's statistics from its own lanes' rows (a warp's reduction
//   of the rank's rows gives the bits the CTA-wide reduction of one rank's stage gives: the
//   other warps add -inf and 0) and then its value sums, lane L for columns 4L..4L+3, with
//   attend_rows' row groups, fmaf chains and order of adding them.  Any other chunk size runs
//   rank by rank, as K1 does.
// - K1: rank by rank, each through attend_rows (the ring restarts at every rank).
template <int G, typename T, bool kFlash>
__device__ __forceinline__ void ranks_attend(const Call<T>& c, int xchg) {
  const int grid = gridDim.x, rank = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = c.n, per = n / grid;
  uint4 q[G];
#pragma unroll
  for (int g = 0; g < G; ++g)
    q[g] = *reinterpret_cast<const uint4*>(c.q + ((size_t)bh * G + g) * kD +
                                           tid % kLanesPerRow * 8);
  const int length = min(max(*c.rows, c.lo), c.hi);
  const int used = split_ctas(length, n, c.min_rows);
  const int chunk = round_up((length + used - 1) / used, kRowsPerPass);
  constexpr int kStageRows = kFlash ? kFlashStageRows<T> : kBlockS;
  constexpr int kRing = kFlash ? kFlashRing : 1;
  const Rows<T> rows = c.rows_of(bh);
  float m[G], l[G], acc[G];
  bf16* out = c.out + (size_t)bh * G * kD;
  if (used == 1) {
    if (rank > 0) return;  // every CTA of the cluster agrees: no barrier below
    attend_rows<G, T, kQuantized<T>, kStageRows, kRing>(q, rows, 0, min(chunk, length), true,
                                                        c.scale, m, l, acc);
    if (tid < kD) {
#pragma unroll
      for (int g = 0; g < G; ++g) out[g * kD + tid] = __float2bfloat16(acc[g] / l[g]);
    }
    return;
  }
  const bool clustered = grid > 1;
  const int used_ctas = (used + per - 1) / per;
  if (clustered) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (rank >= used_ctas) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    return;
  }
  // the exchange area: m [n][G], l [n][G], acc [used][G][width]: G * (3 * n + per * kD)
  // floats at most
  const int width = (kD + used_ctas - 1) / used_ctas;
  extern __shared__ __align__(16) unsigned char dyn[];
  float* xm = reinterpret_cast<float*>(dyn + xchg);
  float* xl = xm + n * G;
  float* xacc = xl + n * G;
  cg::cluster_group cluster = cg::this_cluster();
  const int r_begin = rank * per, r_end = min(r_begin + per, used);
  auto store = [&](int r, const float (&rm)[G], const float (&rl)[G], const float (&racc)[G]) {
    if (clustered && r == r_begin)
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every CTA has started
    if (tid < kD) {  // column tid goes to the CTA that owns it
      float* base = clustered ? cluster.map_shared_rank(xacc, tid / width) : xacc;
      float* dst = base + r * G * width + tid % width;
#pragma unroll
      for (int g = 0; g < G; ++g) dst[g * width] = racc[g];
    }
    if (tid < used_ctas) {  // m and l go to every owner
      float* dm = (clustered ? cluster.map_shared_rank(xm, tid) : xm) + r * G;
      float* dl = (clustered ? cluster.map_shared_rank(xl, tid) : xl) + r * G;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        dm[g] = rm[g];
        dl[g] = rl[g];
      }
    }
  };
  bool staged = false;
  if constexpr (!kFlash) {
    if (chunk == 32) {  // each rank one warp's rows
      staged = true;
      __shared__ float s[G][kBlockS];
      __shared__ float kscale[kScaled<T> ? kBlockS : 1];
      __shared__ float vscale[kScaled<T> ? kBlockS : 1];
      __shared__ float rstat[3][kWarps][G];  // each rank's m, l and correction
      const int sub = tid % kLanesPerRow, row_in_pass = tid / kLanesPerRow;
      const int row0 = r_begin * 32, nrows = min(r_end * 32, length) - row0;
      const int slot_rows = round_up(nrows, kRowsPerPass);
      T* ks = reinterpret_cast<T*>(dyn);
      T* vs = ks + slot_rows * kD;
      copy_rows<T, kBlockS>(ks, rows.k + (size_t)row0 * kD, nrows, slot_rows);
      if constexpr (kScaled<T>) copy_scales(kscale, rows.ks + row0, nrows, slot_rows);
      commit_copies();
      copy_rows<T, kBlockS>(vs, rows.v + (size_t)row0 * kD, nrows, slot_rows);
      if constexpr (kScaled<T>) copy_scales(vscale, rows.vs + row0, nrows, slot_rows);
      commit_copies();
      float qf[G][8], held_m[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        widen8(q[g], qf[g]);
        held_m[g] = -INFINITY;
      }
      const bool held = kQuantized<T> && r_begin == 0;  // rank 0 starts from the held-out row
      if (held) {
        float kn[8];
        widen8(*reinterpret_cast<const uint4*>(rows.k_new + sub * 8), kn);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) dot = fmaf(qf[g][i], kn[i], dot);
#pragma unroll
          for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          held_m[g] = dot * c.scale;
        }
      }
      wait_staged<1>();  // K has landed; V may be in flight
      for (int r = row_in_pass; r - row_in_pass < nrows; r += kRowsPerPass) {
        float kf[8];
        load8(ks + r * kD + sub * 8, kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) dot = fmaf(qf[g][j], kf[j], dot);
#pragma unroll
          for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (sub == 0 && r < nrows) {
            float sc = dot * c.scale;
            if constexpr (kScaled<T>) sc *= kscale[r];
            s[g][r] = sc;
          }
        }
      }
      __syncthreads();
      // each rank's statistics from its warp's rows (row tid of the stage)
      const bool first = held && warp == 0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float sv = tid < nrows ? s[g][tid] : -INFINITY;
        const float m0 = first ? held_m[g] : -INFINITY;
        const float m_new = fmaxf(m0, warp_max(sv));
        const float corr = expf(m0 - m_new);  // 0 without the held-out row (m0 = -inf)
        const float p = tid < nrows ? expf(sv - m_new) : 0.f;
        s[g][tid] = p;
        const float sum = warp_sum(p);
        if (lane == 0) {
          rstat[0][warp][g] = m_new;
          rstat[1][warp][g] = (first ? 1.f : 0.f) * corr + sum;
          rstat[2][warp][g] = corr;
        }
      }
      wait_staged<0>();  // V has landed; the p values and statistics are published
      if (clustered)
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every CTA has started
      // values: warp v sums rank v's rows, lane L its 4 columns 4L..4L+3, as attend_rows does
      // for the rank alone: row group rg (rows rg and 16 + rg of the rank, the second only
      // where the rank has more than 16) accumulates from its start by fmaf, the row groups
      // of a warp are added in pairs (2w, 2w + 1) and the pairs in order
      if (warp < r_end - r_begin) {
        const int v = warp, r = r_begin + v;
        const int passes = min(32, length - 32 * r) > kRowsPerPass ? 2 : 1;
        float corr[G], held_v[4] = {0.f, 0.f, 0.f, 0.f}, t[G][4];
#pragma unroll
        for (int g = 0; g < G; ++g) corr[g] = rstat[2][v][g];
        if (held && r == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) held_v[i] = __bfloat162float(rows.v_new[4 * lane + i]);
        }
#pragma unroll 1
        for (int w = 0; w < kWarps; ++w) {
          float pair[G][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rg = 2 * w + h;
            float a[G][4];
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int i = 0; i < 4; ++i) a[g][i] = (rg == 0 ? held_v[i] : 0.f) * corr[g];
            for (int k = 0; k < passes; ++k) {
              const int row = 32 * v + k * kRowsPerPass + rg;
              float vf[4];
              load4(vs + row * kD + 4 * lane, vf);
              const float row_scale = kScaled<T> ? vscale[row] : 1.f;
#pragma unroll
              for (int g = 0; g < G; ++g) {
                const float p = kScaled<T> ? s[g][row] * row_scale : s[g][row];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[g][i] = fmaf(p, vf[i], a[g][i]);
              }
            }
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int i = 0; i < 4; ++i) pair[g][i] = h == 0 ? a[g][i] : pair[g][i] + a[g][i];
          }
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int i = 0; i < 4; ++i) t[g][i] = w == 0 ? pair[g][i] : t[g][i] + pair[g][i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // column 4L + i goes to the CTA that owns it
          const int col = 4 * lane + i;
          float* base = clustered ? cluster.map_shared_rank(xacc, col / width) : xacc;
          float* dst = base + r * G * width + col % width;
#pragma unroll
          for (int g = 0; g < G; ++g) dst[g * width] = t[g][i];
        }
        if (lane < used_ctas) {  // m and l go to every owner
          float* dm = (clustered ? cluster.map_shared_rank(xm, lane) : xm) + r * G;
          float* dl = (clustered ? cluster.map_shared_rank(xl, lane) : xl) + r * G;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            dm[g] = rstat[0][v][g];
            dl[g] = rstat[1][v][g];
          }
        }
      }
    }
  }
  if (!staged) {
    for (int r = r_begin; r < r_end; ++r) {
      if (r > r_begin) __syncthreads();  // the previous rank's stages and partials are read
      const int r0 = min(r * chunk, length), r1 = min(r0 + chunk, length);
      attend_rows<G, T, kQuantized<T>, kStageRows, kRing>(q, rows, r0, r1, r == 0, c.scale, m,
                                                          l, acc);
      store(r, m, l, acc);
    }
  }
  if (clustered) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
  const int cols = min(width, kD - rank * width);
  for (int i = tid; i < G * cols; i += kThreads) {
    const int g = i / cols, j = i % cols;
    float mx = -INFINITY;
    for (int r = 0; r < used; ++r) mx = fmaxf(mx, xm[r * G + g]);
    float lsum = 0.f, o = 0.f;
    for (int r = 0; r < used; ++r) {
      const float w = expf(xm[r * G + g] - mx);  // 0 for an empty rank
      lsum += xl[r * G + g] * w;
      o += xacc[(r * G + g) * width + j] * w;
    }
    out[g * kD + rank * width + j] = __float2bfloat16(o / lsum);
  }
}

// K2: each CTA stages its chunk (at most one 256-row block) whole.
template <int G, typename T>
__global__ void __launch_bounds__(kThreads) cluster_pass_kernel(Call<T> c, int xchg) {
  cluster_attend<G, T, false>(c, xchg);
}

// K1: each CTA streams its chunk through the ring of 32 KB stages.
template <int G, typename T>
__global__ void __launch_bounds__(kThreads) flash_cluster_kernel(Call<T> c, int xchg) {
  cluster_attend<G, T, true>(c, xchg);
}

// K2 and K1 with each CTA running several ranks (ranks_attend).
template <int G, typename T>
__global__ void __launch_bounds__(kThreads) pass_ranks_kernel(Call<T> c, int xchg) {
  ranks_attend<G, T, false>(c, xchg);
}

template <int G, typename T>
__global__ void __launch_bounds__(kThreads) flash_ranks_kernel(Call<T> c, int xchg) {
  ranks_attend<G, T, true>(c, xchg);
}

// A launch of K1 (kFlash) or K2: the kernel, its stage, ring and cluster limit.
template <int G, typename T, bool kFlash>
struct Plan {
  static constexpr int kStageRows = kFlash ? kFlashStageRows<T> : kBlockS;
  static constexpr int kRing = kFlash ? kFlashRing : 1;
  static constexpr int kMaxN = kFlash ? kMaxFlashCluster : kMaxCluster;
  // the exchange area of n ranks, at most G * (3 * n + kD) floats (n * width <= kD + n) with
  // one rank a CTA; with per = n / g ranks a CTA, G * (3 * n + per * kD) floats (the partials
  // of used ranks in used_ctas >= used / per slices of width <= kD / used_ctas + 1)
  static constexpr int kBase = kFlash ? kRing * kSlotBytes : kStageBytes<T>;
  static constexpr int kMaxSmem = kBase + G * (3 * kMaxN + kD) * (int)sizeof(float);
  static constexpr int kMaxRanksSmem = kBase + G * (3 * kMaxN + kMaxN * kD) * (int)sizeof(float);

  static void (*kernel(bool ranks))(Call<T>, int) {
    if constexpr (kFlash) return ranks ? flash_ranks_kernel<G, T> : flash_cluster_kernel<G, T>;
    else return ranks ? pass_ranks_kernel<G, T> : cluster_pass_kernel<G, T>;
  }

  // Where the exchange area starts: past the ring slots one rank of `chunk` rows uses, and
  // at least the row-group partial sums (16-byte multiples).
  static int xchg(int chunk) {
    const int slot_rows = std::min(kStageRows, round_up(chunk, kRowsPerPass));
    const int slots = std::min(kRing, (chunk + kStageRows - 1) / kStageRows);
    return std::max(slots * 2 * slot_rows * kD * (int)sizeof(T), kPartBytes<G>);
  }

  // Lets the kernel take its stages above the 48 KB default and (K1) clusters above the
  // portable 8 CTAs; set once per kernel (a function-local static is initialised once), by
  // zt_decode_attention_prepare when the library is loaded, so never during a capture.
  static cudaError_t allow() {
    static const cudaError_t err = [] {
      cudaError_t e = cudaSuccess;
      for (const bool ranks : {false, true}) {
        if (e == cudaSuccess)
          e = cudaFuncSetAttribute(kernel(ranks), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   ranks ? kMaxRanksSmem : kMaxSmem);
        if (e == cudaSuccess && kFlash)
          e = cudaFuncSetAttribute(kernel(ranks), cudaFuncAttributeNonPortableClusterSizeAllowed,
                                   1);
      }
      return e;
    }();
    return err;
  }

  // The launch of clusters of `grid` CTAs (a divisor of the split's n ranks) over BH pairs
  // whose longest chunk is chunk_max rows; refuses a band outside [0, S] and a cluster past the
  // limit.
  static cudaError_t config(int BH, int S, int lo, int hi, int n, int grid, int chunk_max,
                            cudaStream_t stream, cudaLaunchConfig_t& cfg,
                            cudaLaunchAttribute& cluster_dim, int& xchg_bytes) {
    if (n < 1 || n > kMaxN || grid < 1 || n % grid || chunk_max < 0 || BH < 1 || lo < 0 ||
        lo > hi || hi > S)
      return cudaErrorInvalidValue;
    const cudaError_t attr = allow();
    if (attr != cudaSuccess) return attr;
    const bool ranks = grid < n;  // K2's several ranks a CTA are staged whole
    xchg_bytes = ranks && !kFlash ? kStageBytes<T> : xchg(chunk_max);
    cluster_dim.id = cudaLaunchAttributeClusterDimension;
    cluster_dim.val.clusterDim.x = grid;
    cluster_dim.val.clusterDim.y = 1;
    cluster_dim.val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(grid, BH);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes =
        xchg_bytes + (ranks ? G * (3 * n + n / grid * kD) * (int)sizeof(float)
                            : n > 1 ? G * (3 * n + kD) * (int)sizeof(float) : 0);
    cfg.stream = stream;
    cfg.attrs = &cluster_dim;
    cfg.numAttrs = 1;
    return cudaSuccess;
  }

  static int launch(const Call<T>& c, int BH, int grid, int chunk_max, cudaStream_t stream) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute cluster_dim;
    int xchg_bytes;
    if (c.min_rows < 1) return cudaErrorInvalidValue;
    cudaError_t err =
        config(BH, c.S, c.lo, c.hi, c.n, grid, chunk_max, stream, cfg, cluster_dim, xchg_bytes);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kernel(grid < c.n), c, xchg_bytes);
    return err != cudaSuccess ? err : cudaGetLastError();
  }

  // How many clusters of this plan the card holds at once (0: it cannot launch them).
  static int max_active(int n, int chunk, int* clusters) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute cluster_dim;
    int xchg_bytes;
    const cudaError_t err =
        config(1, 0, 0, 0, n, n, chunk, nullptr, cfg, cluster_dim, xchg_bytes);
    if (err != cudaSuccess) return err;
    cfg.gridDim = dim3(n, 1);
    return cudaOccupancyMaxActiveClusters(clusters, kernel(false), &cfg);
  }
};

template <bool kFlash, typename T>
int launch_by_group(const Call<T>& c, int BH, int G, int grid, int chunk_max, cudaStream_t st) {
  switch (G) {
    case 1: return Plan<1, T, kFlash>::launch(c, BH, grid, chunk_max, st);
    case 2: return Plan<2, T, kFlash>::launch(c, BH, grid, chunk_max, st);
    case 4: return Plan<4, T, kFlash>::launch(c, BH, grid, chunk_max, st);
    case 8: return Plan<8, T, kFlash>::launch(c, BH, grid, chunk_max, st);
    default: return cudaErrorInvalidValue;
  }
}

// The band's launch parameters, as the entry points take them.
struct Band {
  const int* rows;  // int32 on the card: the cache rows to attend
  int lo, hi;       // the band the launch is planned for (cache rows)
  int n, grid, chunk_max, min_rows;  // the split's ranks, the CTAs a pair running them
};

template <typename T>
Call<T> make_call(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                  const void* k_new, const void* v_new, void* out, int S, const Band& b,
                  float scale) {
  return {static_cast<const bf16*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const float*>(ks), static_cast<const float*>(vs),
          static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
          static_cast<bf16*>(out), b.rows, S, b.lo, b.hi, b.min_rows, b.n, scale};
}

// Every instantiation's attributes (and with them its module), before any capture; the
// first error, if any.
template <bool kFlash, typename T>
cudaError_t allow_groups() {
  const cudaError_t errs[] = {Plan<1, T, kFlash>::allow(), Plan<2, T, kFlash>::allow(),
                              Plan<4, T, kFlash>::allow(), Plan<8, T, kFlash>::allow()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

template <bool kFlash>
cudaError_t allow_all() {
  const cudaError_t errs[] = {allow_groups<kFlash, bf16>(), allow_groups<kFlash, f8>(),
                              allow_groups<kFlash, int8_t>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

// Quantized caches: storage 1 = f8 e4m3, 2 = int8 with k_scale/v_scale [B, H_kv, S] fp32.
template <bool kFlash>
int launch_quantized(int storage, const void* q, const void* k, const void* v,
                     const void* k_scale, const void* v_scale, const void* k_new,
                     const void* v_new, void* out, int B, int Hkv, int G, int S, const Band& b,
                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage == 1)
    return launch_by_group<kFlash>(make_call<f8>(q, k, v, nullptr, nullptr, k_new, v_new, out, S,
                                                 b, scale),
                                   B * Hkv, G, b.grid, b.chunk_max, st);
  if (storage == 2)
    return launch_by_group<kFlash>(make_call<int8_t>(q, k, v, k_scale, v_scale, k_new, v_new,
                                                     out, S, b, scale),
                                   B * Hkv, G, b.grid, b.chunk_max, st);
  return cudaErrorInvalidValue;
}

template <typename T>
int max_active_by_group(int G, int n, int chunk, int* clusters) {
  switch (G) {
    case 1: return Plan<1, T, true>::max_active(n, chunk, clusters);
    case 2: return Plan<2, T, true>::max_active(n, chunk, clusters);
    case 4: return Plan<4, T, true>::max_active(n, chunk, clusters);
    case 8: return Plan<8, T, true>::max_active(n, chunk, clusters);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, 1, H, D], k/v [B, H_kv, S, D], out [B, 1, H, D]: bf16, contiguous, D = 128.
// `rows` points at an int32 on the card: the cache rows to attend, clamped to [lo, hi]
// (0 <= lo <= hi <= S).  K1: a split of up to n ranks (n up to 16) of at least min_rows rows,
// run by clusters of `grid` CTAs (a divisor of n), the longest chunk of the band chunk_max rows
// (it sizes the shared memory).
extern "C" int zt_flash_decode_attention(const void* q, const void* k, const void* v, void* out,
                                         int B, int Hkv, int G, int S, const int* rows, int lo,
                                         int hi, int n, int grid, int chunk_max, int min_rows,
                                         float scale, void* stream) {
  const Band b{rows, lo, hi, n, grid, chunk_max, min_rows};
  return launch_by_group<true>(make_call<bf16>(q, k, v, nullptr, nullptr, nullptr, nullptr, out,
                                               S, b, scale),
                               B * Hkv, G, grid, chunk_max, static_cast<cudaStream_t>(stream));
}

// K2: a split of up to n ranks (n up to 8), run by clusters of `grid` CTAs.
extern "C" int zt_decode_attention_single(const void* q, const void* k, const void* v, void* out,
                                          int B, int Hkv, int G, int S, const int* rows, int lo,
                                          int hi, int n, int grid, int chunk_max, int min_rows,
                                          float scale, void* stream) {
  const Band b{rows, lo, hi, n, grid, chunk_max, min_rows};
  return launch_by_group<false>(make_call<bf16>(q, k, v, nullptr, nullptr, nullptr, nullptr,
                                                out, S, b, scale),
                                B * Hkv, G, grid, chunk_max, static_cast<cudaStream_t>(stream));
}

// Quantized caches: storage 1 = f8 e4m3, 2 = int8 with k_scale/v_scale [B, H_kv, S] fp32.
// k/v [B, H_kv, S, D] of that type; k_new/v_new [B, 1, H_kv, D] bf16, the current token's,
// held out; `rows` (the current position) cache rows are attended (it may be 0).
extern "C" int zt_flash_decode_attention_q(int storage, const void* q, const void* k,
                                           const void* v, const void* k_scale,
                                           const void* v_scale, const void* k_new,
                                           const void* v_new, void* out, int B, int Hkv, int G,
                                           int S, const int* rows, int lo, int hi, int n,
                                           int grid, int chunk_max, int min_rows, float scale,
                                           void* stream) {
  return launch_quantized<true>(storage, q, k, v, k_scale, v_scale, k_new, v_new, out, B, Hkv, G,
                                S, Band{rows, lo, hi, n, grid, chunk_max, min_rows}, scale,
                                stream);
}

extern "C" int zt_decode_attention_single_q(int storage, const void* q, const void* k,
                                            const void* v, const void* k_scale,
                                            const void* v_scale, const void* k_new,
                                            const void* v_new, void* out, int B, int Hkv, int G,
                                            int S, const int* rows, int lo, int hi, int n,
                                            int grid, int chunk_max, int min_rows, float scale,
                                            void* stream) {
  return launch_quantized<false>(storage, q, k, v, k_scale, v_scale, k_new, v_new, out, B, Hkv,
                                 G, S, Band{rows, lo, hi, n, grid, chunk_max, min_rows}, scale,
                                 stream);
}

// Sets every kernel's attributes (and so loads its module) once, before anything is
// captured into a CUDA graph; the wrapper calls it when it loads the library.
extern "C" int zt_decode_attention_prepare() {
  const cudaError_t err = allow_all<true>();
  return err != cudaSuccess ? err : allow_all<false>();
}

// K1's plan check: how many clusters of n CTAs of `chunk` rows (storage 0 = bf16, 1 = f8,
// 2 = int8; G query rows a kv head) the card holds at once, into *clusters.
extern "C" int zt_flash_max_active_clusters(int storage, int G, int n, int chunk, int* clusters) {
  if (storage == 0) return max_active_by_group<bf16>(G, n, chunk, clusters);
  if (storage == 1) return max_active_by_group<f8>(G, n, chunk, clusters);
  if (storage == 2) return max_active_by_group<int8_t>(G, n, chunk, clusters);
  return cudaErrorInvalidValue;
}
