// K4: the int8 transformer layer tail of one decode step, for Hopper (sm_90a):
//   x2  = resid + attn @ dequant(wo)                    (fp32)
//   h   = LayerNorm(x2) * ln_s + ln_b                   (bf16)
//   act = u * sigmoid(g) * g,  [u | g] = h @ w1         (bf16)
//   out = x2 + act @ dequant(w2)                        (bf16)
// with int8 weights and one bf16 scale per output column.
//
// Replaces the Pallas TPU kernel fused_layer_tail_pallas (zonos_tpu/ops/pallas_decode.py:94;
// body _tail_kernel :49) and keeps its arithmetic: wo and w2 are dequantized as the bf16
// product q * s before their dots, w1's scales multiply the fp32 dot afterwards, x2 stays
// fp32, the LayerNorm runs in fp32 and h is rounded to bf16, the SwiGLU product runs in fp32
// and is rounded to bf16 before w2, and the output is rounded once.
//
// What bounds it on an H100: at B2 <= 128 rows each int8 weight feeds at most 128 FMAs, far
// below the card's ridge, so the floor is reading wo, w1 and w2 once from HBM (3.35 TB/s):
// 4.2 + 33.6 + 16.8 = 54.6 MB at the flagship's width, ~16.3 us a layer.
//
// Design:
// - The TPU kernel is one sequential grid: wo tiles, then the LayerNorm at step nwo, then
//   the MLP tiles, carrying x2, h and the accumulator in VMEM.  CTAs on the card run in no
//   order and share nothing, and every MLP column needs all of x2, so the tail is three
//   launches on the stream (not one cooperative launch):
//     1. wo + residual -> x2 (fp32, [B2, d] in device memory);
//     2. the LayerNorm folded into the w1 pass's prologue (each CTA recomputes its rows'
//        mean and variance over d from x2, read once from L2), then w1 and SwiGLU -> act;
//     3. w2 + x2 -> out.
//   x2 and act are a few KB a row; the weights are the traffic.
// - One kernel template serves the three passes.  A CTA (256 threads) owns a 32-column tile
//   (the w1 pass: 32 up and the matching 32 gate columns), MT <= 8 rows of the input and a
//   slice of the contraction dimension; a thread reads 4 int8 columns (one 32-bit load) of
//   a weight row, and the CTA's 32 row lanes walk its slice interleaved, each issuing the
//   loads of 8 rows before it uses any, so a warp reads 4 rows x 32 contiguous bytes a
//   load.  Its input rows (its slice of them) are staged in shared memory as bf16, and the
//   row lanes' sums are added through shared memory in lane order.
// - A 32-column tile alone gives 64 CTAs for wo and w2 (d = 2048), too few to keep enough
//   loads in flight on 132 SMs, so each pass also splits the contraction over the grid's y
//   dimension (about one CTA per SM in all, the fastest in chip_smoke.py --sweep,
//   PERF.md).  The splits write fp32 partial sums; the last CTA of a tile to finish (an
//   atomic counter per tile) adds them in split order and applies the pass's epilogue, so
//   the result does not depend on the order the CTAs ran in, and no further launch is
//   needed.  The counters are the call's own (one region per pass), zeroed on its stream
//   before the first pass, so calls on other streams never share them.
// - Dequantization stays off the card's conversion units (16 results per SM and clock, one
//   per weight would cost as much as reading the weights): a byte is widened to fp32 by
//   building 2^23 + (b ^ 0x80) from its bits and subtracting, and q * s is rounded to bf16
//   with integer operations.
// - Any B2: rows beyond 8 take further CTAs on the grid's z dimension, each rereading the
//   weights (from L2 after the first).  The batch-1 path with CFG has 2 rows, batch 4 has 8.
//
// C interface (ctypes): returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 4;                       // one 32-bit load of int8
constexpr int kTile = 32;                               // columns per CTA
constexpr int kThreadsPerRow = kTile / kColsPerThread;  // 8
constexpr int kLanes = kThreads / kThreadsPerRow;       // 32 row lanes
constexpr int kMaxK = 8192;
constexpr int kBatch = 8;  // weight rows whose loads a thread has in flight at once
constexpr int kMaxMT = 8;
constexpr int kMaxSmem = kMaxMT * kMaxK * 2 + kLanes * kMaxMT * 2 * kTile * 4;
static_assert(kMaxMT * kTile <= kThreads, "one output of a tile per thread");

enum Pass { kWo = 0, kUp = 1, kDown = 2 };

struct Args {
  const __nv_bfloat16* a;      // kWo: attn [B2, K]; kDown: act [B2, K]
  const __nv_bfloat16* resid;  // kWo: [B2, N]
  const float* x2;             // kUp: the LayerNorm's input [B2, K]; kDown: residual [B2, N]
  const int8_t* wq;            // [K, ldw]
  const __nv_bfloat16* ws;     // [ldw]
  const __nv_bfloat16* ln_s;   // kUp: [K]
  const __nv_bfloat16* ln_b;
  float* x2_out;               // kWo: [B2, N]
  __nv_bfloat16* act_out;      // kUp: [B2, N]
  __nv_bfloat16* out;          // kDown: [B2, N]
  float* partial;              // [n_split, H, B2, N] fp32 when n_split > 1
  unsigned* counters;          // one per (column tile, row tile), zero on entry
  int B2, K, N, ldw, n_split, k_split;  // k_split: contraction rows per split
  float eps;
};

// v rounded to bf16 (nearest, ties to even) and widened back, for finite v, in integer
// operations: the card's float conversions run at 16 results per SM and clock, and the
// weight loop needs one per weight.
__device__ __forceinline__ float bf16_round(float v) {
  const unsigned u = __float_as_uint(v);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// Signed byte j of `flipped` (a word of int8 values with 0x80 xor-ed into each byte) as fp32,
// exactly and without a conversion instruction: 2^23 + (b ^ 0x80) is built from its bits,
// then 2^23 + 128 is subtracted.
__device__ __forceinline__ float byte_as_float(unsigned flipped, int j) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540 + j)) - 8388736.0f;
}

// Sum over the CTA, added in a fixed order; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

// The pass's epilogue for output (row m, column c) from its H sums.
template <int P>
__device__ __forceinline__ void epilogue(const Args& args, int m, int c, const float* t) {
  const size_t o = (size_t)m * args.N + c;
  if (P == kWo) {
    args.x2_out[o] = __bfloat162float(args.resid[o]) + t[0];
  } else if (P == kUp) {
    const float u = t[0] * __bfloat162float(args.ws[c]);
    const float g = t[1] * __bfloat162float(args.ws[args.N + c]);
    const float sig = 1.0f / (1.0f + expf(-g));
    args.act_out[o] = __float2bfloat16_rn(u * sig * g);
  } else {
    args.out[o] = __float2bfloat16_rn(args.x2[o] + t[0]);
  }
}

// grid (N / kTile, n_split, ceil(B2 / MT)); dynamic shared memory: MT * k_split bf16 inputs,
// then the row lanes' sums [kLanes][MT][H * kTile] fp32 (H = 2 for the w1 pass).
template <int MT, int P>
__global__ void __launch_bounds__(kThreads) tail_pass_kernel(Args args) {
  constexpr int H = P == kUp ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red8[kWarps];
  __shared__ bool is_last;
  const int K = args.K, N = args.N, Kc = args.k_split;
  const int tid = threadIdx.x;
  const int split = blockIdx.y, m0 = blockIdx.z * MT;
  const int rows = min(MT, args.B2 - m0);
  const int k0 = split * Kc, nk = min(K, k0 + Kc) - k0;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);           // [MT][Kc]
  float* part = reinterpret_cast<float*>(smem + (size_t)MT * Kc * 2);  // [kLanes][MT][H*kTile]

  // stage this split's slice of the MT input rows (zeros past B2)
  if (P == kUp) {
    for (int m = 0; m < MT; ++m) {
      if (m >= rows) {  // uniform across the CTA
        for (int k = tid; k < nk; k += kThreads) xs[m * Kc + k] = __float2bfloat16_rn(0.f);
        continue;
      }
      // the whole row is read once (from L2) into registers: K / kThreads <= 32 a thread
      const float* xr = args.x2 + (size_t)(m0 + m) * K;
      float xv[kMaxK / kThreads];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxK / kThreads; ++i) {
        const int k = tid + i * kThreads;
        xv[i] = k < K ? xr[k] : 0.f;
        s += xv[i];
      }
      const float mu = block_sum(s, red8) / K;
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxK / kThreads; ++i) {
        const float dv = tid + i * kThreads < K ? xv[i] - mu : 0.f;
        v += dv * dv;
      }
      const float var = block_sum(v, red8) / K;
      const float rstd = 1.0f / sqrtf(var + args.eps);
#pragma unroll
      for (int i = 0; i < kMaxK / kThreads; ++i) {
        const int k = tid + i * kThreads;
        if (k >= k0 && k < k0 + nk) {
          const float hn = (xv[i] - mu) * rstd;
          xs[m * Kc + (k - k0)] = __float2bfloat16_rn(hn * __bfloat162float(args.ln_s[k]) +
                                                      __bfloat162float(args.ln_b[k]));
        }
      }
    }
  } else {
    for (int m = 0; m < MT; ++m)
      for (int k = tid; k < nk; k += kThreads)
        xs[m * Kc + k] = m < rows ? args.a[(size_t)(m0 + m) * K + k0 + k]
                                  : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  const int lane = tid / kThreadsPerRow;  // row lane
  const int cc = (tid % kThreadsPerRow) * kColsPerThread;
  const int c = blockIdx.x * kTile + cc;
  float sc[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) sc[j] = __bfloat162float(args.ws[c + j]);

  float acc[H][MT][kColsPerThread];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[h][m][j] = 0.f;

  // explicit batches: all kBatch rows' loads are issued before any is used (left to itself
  // the compiler interleaves each load with its use, one round trip per row)
  for (int kb = lane; kb < nk; kb += kBatch * kLanes) {
    unsigned raw[kBatch][H];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int k = kb + i * kLanes;
      const int8_t* wrow = args.wq + (size_t)(k0 + k) * args.ldw + c;
#pragma unroll
      for (int h = 0; h < H; ++h)
        raw[i][h] = k < nk ? __ldg(reinterpret_cast<const unsigned*>(wrow + h * N)) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int k = kb + i * kLanes;
      if (k >= nk) break;
      float xv[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) xv[m] = __bfloat162float(xs[m * Kc + k]);
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const float q = byte_as_float(raw[i][h] ^ 0x80808080u, j);
          const float w = P == kUp ? q : bf16_round(q * sc[j]);  // w1 scales after the dot
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[h][m][j] = fmaf(xv[m], w, acc[h][m][j]);
        }
    }
  }

  // add the row lanes' sums in lane order: thread tid < MT * kTile owns output (m, col)
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        part[((size_t)lane * MT + m) * H * kTile + h * kTile + cc + j] = acc[h][m][j];
  __syncthreads();
  const int m = tid / kTile, col = tid % kTile;
  const int gc = blockIdx.x * kTile + col;
  const bool mine = tid < MT * kTile && m < rows;
  float t[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    t[h] = 0.f;
    if (mine)
      for (int l = 0; l < kLanes; ++l)
        t[h] += part[((size_t)l * MT + m) * H * kTile + h * kTile + col];
  }
  if (args.n_split == 1) {
    if (mine) epilogue<P>(args, m0 + m, gc, t);
    return;
  }

  // split contraction: publish this split's sums; the tile's last CTA adds all splits in
  // split order and applies the epilogue
  const size_t plane = (size_t)args.B2 * N;
  if (mine) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      args.partial[((size_t)split * H + h) * plane + (size_t)(m0 + m) * N + gc] = t[h];
  }
  __threadfence();
  __syncthreads();
  unsigned* counter = args.counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(counter, 1u) == (unsigned)args.n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (mine) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float s = 0.f;
      for (int sp = 0; sp < args.n_split; ++sp)
        s += __ldcg(args.partial + ((size_t)sp * H + h) * plane + (size_t)(m0 + m) * N + gc);
      t[h] = s;
    }
    epilogue<P>(args, m0 + m, gc, t);
  }
}

template <int MT, int P>
cudaError_t launch_pass(const Args& args, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      tail_pass_kernel<MT, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  constexpr int H = P == kUp ? 2 : 1;
  const size_t smem = (size_t)MT * args.k_split * 2 + (size_t)kLanes * MT * H * kTile * 4;
  const dim3 grid(args.N / kTile, args.n_split, (args.B2 + MT - 1) / MT);
  tail_pass_kernel<MT, P><<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int MT>
int launch_tail(const Args& wo, const Args& up, const Args& down, cudaStream_t stream) {
  cudaError_t err = launch_pass<MT, kWo>(wo, stream);
  if (err != cudaSuccess) return err;
  err = launch_pass<MT, kUp>(up, stream);
  if (err != cudaSuccess) return err;
  return launch_pass<MT, kDown>(down, stream);
}

bool valid_split(int K, int n_split) {
  if (n_split < 1) return false;
  const int k_split = (K + n_split - 1) / n_split;
  return (n_split - 1) * k_split < K;  // no empty split
}

}  // namespace

// attn [B2, dk] bf16; resid [B2, d] bf16; woq [dk, d] int8, wos [d] bf16; ln_s, ln_b [d]
// bf16; w1q [d, 2I] int8 (up columns, then gate), w1s [2I] bf16; w2q [I, d] int8, w2s [d]
// bf16.  Scratch: x2 [B2, d] fp32, act [B2, I] bf16, partial fp32 (the largest of the
// passes' n_split * H * B2 * N, when a pass splits), counters (3 x one per column tile and
// row tile of the widest pass, zeroed here on the stream); out [B2, d] bf16.  All contiguous; d % 32 == 0,
// I % 32 == 0, dk, d, I <= 8192; splits_* are the passes' contraction splits.
extern "C" int zt_fused_layer_tail(const void* attn, const void* resid, const void* woq,
                                   const void* wos, const void* ln_s, const void* ln_b,
                                   const void* w1q, const void* w1s, const void* w2q,
                                   const void* w2s, void* x2, void* act, void* out,
                                   void* partial, void* counters, int B2, int dk, int d, int I,
                                   int splits_wo, int splits_up, int splits_down, float eps,
                                   void* stream) {
  if (B2 < 1 || d % kTile || I % kTile || dk < 1 || dk > kMaxK || d > kMaxK || I > kMaxK ||
      !valid_split(dk, splits_wo) || !valid_split(d, splits_up) || !valid_split(I, splits_down))
    return cudaErrorInvalidValue;
  Args base{};
  base.partial = static_cast<float*>(partial);
  base.counters = static_cast<unsigned*>(counters);
  base.B2 = B2;
  Args wo = base;
  wo.a = static_cast<const __nv_bfloat16*>(attn);
  wo.resid = static_cast<const __nv_bfloat16*>(resid);
  wo.wq = static_cast<const int8_t*>(woq);
  wo.ws = static_cast<const __nv_bfloat16*>(wos);
  wo.x2_out = static_cast<float*>(x2);
  wo.K = dk, wo.N = d, wo.ldw = d, wo.n_split = splits_wo;
  Args up = base;
  up.x2 = static_cast<const float*>(x2);
  up.wq = static_cast<const int8_t*>(w1q);
  up.ws = static_cast<const __nv_bfloat16*>(w1s);
  up.ln_s = static_cast<const __nv_bfloat16*>(ln_s);
  up.ln_b = static_cast<const __nv_bfloat16*>(ln_b);
  up.act_out = static_cast<__nv_bfloat16*>(act);
  up.K = d, up.N = I, up.ldw = 2 * I, up.n_split = splits_up, up.eps = eps;
  Args down = base;
  down.a = static_cast<const __nv_bfloat16*>(act);
  down.x2 = static_cast<const float*>(x2);
  down.wq = static_cast<const int8_t*>(w2q);
  down.ws = static_cast<const __nv_bfloat16*>(w2s);
  down.out = static_cast<__nv_bfloat16*>(out);
  down.K = I, down.N = d, down.ldw = d, down.n_split = splits_down;
  wo.k_split = (dk + splits_wo - 1) / splits_wo;
  up.k_split = (d + splits_up - 1) / splits_up;
  down.k_split = (I + splits_down - 1) / splits_down;
  // each pass its own counters: ceil(B2 / MT) row tiles x the widest pass's column tiles
  const int mt = B2 <= 2 ? B2 : B2 <= 4 ? 4 : 8;
  const size_t per_pass = (size_t)((d > I ? d : I) / kTile) * ((B2 + mt - 1) / mt);
  up.counters = base.counters + per_pass;
  down.counters = base.counters + 2 * per_pass;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(counters, 0, 3 * per_pass * sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  if (B2 == 1) return launch_tail<1>(wo, up, down, st);
  if (B2 == 2) return launch_tail<2>(wo, up, down, st);
  if (B2 <= 4) return launch_tail<4>(wo, up, down, st);
  return launch_tail<8>(wo, up, down, st);
}
