// K8: x [M, din] @ dequant(int4 q [din/2, dout], bf16 s [G, dout]) -> fp32 [M, dout],
// for the few rows (M <= 64) of a decode step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel int4_matmul_pallas (zonos_tpu/ops/pallas_kernels.py:294;
// body _int4_matmul_kernel :272).  q holds two weights per byte in the "halves" layout:
// packed row r carries weight row r in its low nibble and row r + din/2 in its high one.
//
// What bounds it on an H100: each weight feeds at most M <= 64 FMAs, far below the card's
// ridge, so the floor is reading the packed weights (din * dout / 2 bytes) and the group
// scales once from HBM (3.35 TB/s): 17.3 MB and ~5.2 us for the flagship's w1.
//
// Design:
// - The TPU kernel unpacks a whole [din, TN] column tile into VMEM and runs one MXU dot.  On
//   the card a lane owns 16 consecutive columns and reads 16 packed bytes per packed row (a
//   warp reads 512 contiguous bytes of a row), which gives it 32 weights: 16 of row r and 16
//   of row r + din/2.  It dequantizes them in registers and accumulates x * w in fp32 for
//   MT <= 4 rows of x at once.  No weight is written back in bf16: HBM sees 0.5 byte per
//   weight.
// - Dequantization stays off the card's slow conversion units (16 results per SM and clock,
//   which at one conversion per weight cost more than reading the weights): a nibble n is
//   placed in the mantissa of the bf16 128 + (n ^ 8), two per 32-bit word with one logic
//   operation, and 136 is subtracted in bf16x2 (exact), which gives the signed value.  It is
//   then multiplied by its group scale in bf16x2, which rounds q * s to bf16 as the Pallas
//   body's bf16 product does, and widened to fp32 by a shift.
// - A CTA (8 warps) owns a 512-column tile and a range of packed rows, which its warps cut
//   into eight contiguous slices; a lane issues the loads of 8 rows (128 bytes) before it
//   uses any of them, and the other warps of the SM compute meanwhile.  The slices are
//   summed through shared memory in warp order.  The scales are loaded once per group of
//   rows.
// - A 512-column tile alone gives too few CTAs for 132 SMs (wo and w2 have 4 tiles, the heads
//   21), so the packed rows are also split over the grid's y dimension, up to one CTA per
//   SM in all (a second, partial wave measured slower: chip_smoke.py --sweep).  Each
//   split writes its fp32 partial sums; the last CTA of a column tile to finish (an atomic
//   counter per tile) adds them in split order, so the result does not depend on the order
//   the CTAs ran in.  The counters are the call's own, zeroed on its stream before the
//   launch, so calls on other streams never share them.  One launch.
// - The CTA's slice of x (its MT rows at its low and high row ranges, at most 2 x 1024
//   values a row) is staged once in shared memory as fp32 and read by all lanes as a
//   broadcast.  More than 4 rows take further CTAs on the grid's z dimension, each rereading
//   the weights (from L2 after the first).
// - Columns need not fill the last tile (dout % 16 == 0 suffices): the hybrid's in_proj has
//   dout 8512.  The TPU kernel's dout % 128 was its lane width.
//
// C interface (ctypes): returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 16;          // columns (packed bytes) per lane
constexpr int kTile = 32 * kCols;  // columns per CTA
constexpr int kMaxRowsPerSplit = 1024;
constexpr int kBatch = 8;  // packed rows whose loads a lane has in flight at once
constexpr int kMaxMT = 4;
constexpr int kMaxSmem = (kMaxMT * 2 * kMaxRowsPerSplit + kMaxMT * kTile) * 4;

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned bits) {
  __nv_bfloat162 v;
  *reinterpret_cast<unsigned*>(&v) = bits;
  return v;
}

// The 16 scales of a lane's columns as bf16 pairs: p[t][k] = (s[4t + k], s[4t + k + 2]),
// matching the nibble pairs of dequant4.
__device__ __forceinline__ void load_scale_pairs(const __nv_bfloat16* p,
                                                 __nv_bfloat162 (&pairs)[4][2]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(p + 8));
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};  // w[i]: columns 2i, 2i + 1
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    // columns 4t, 4t+1 in w[2t]; 4t+2, 4t+3 in w[2t+1]
    pairs[t][0] = as_bf162(__byte_perm(w[2 * t], w[2 * t + 1], 0x5410));  // (4t, 4t+2)
    pairs[t][1] = as_bf162(__byte_perm(w[2 * t], w[2 * t + 1], 0x7632));  // (4t+1, 4t+3)
  }
}

// One 32-bit word of packed bytes (columns 4t..4t+3) -> the dequantized bf16 weights widened
// to fp32: lo[k] = (row r, columns 4t+k and 4t+k+2), hi[k] likewise for row r + din/2.
__device__ __forceinline__ void dequant4(unsigned word, const __nv_bfloat162 (&s_lo)[2],
                                         const __nv_bfloat162 (&s_hi)[2], float2 (&lo)[2],
                                         float2 (&hi)[2]) {
  const __nv_bfloat162 k136 = as_bf162(0x43084308u);  // bf16 136.0 twice
  const unsigned w = word ^ 0x88888888u;              // n -> n ^ 8 in every nibble
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const unsigned l = ((w >> (8 * k)) & 0x000F000Fu) | 0x43004300u;      // 128 + (n ^ 8)
    const unsigned h = ((w >> (8 * k + 4)) & 0x000F000Fu) | 0x43004300u;
    lo[k] = __bfloat1622float2(__hmul2(__hsub2(as_bf162(l), k136), s_lo[k]));
    hi[k] = __bfloat1622float2(__hmul2(__hsub2(as_bf162(h), k136), s_hi[k]));
  }
}

// grid (ceil(dout / kTile), n_split, ceil(M / MT)); dynamic shared memory
// (MT * 2 * rows_per_split + MT * kTile) floats.  out is [M, dout]; part [n_split, M, dout]
// and counters (one per column and row tile, zero on entry) serve a split contraction.
template <int MT>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                   const __nv_bfloat16* __restrict__ s, float* __restrict__ out,
                   float* __restrict__ part, unsigned* __restrict__ counters, int M, int din,
                   int dout, int gs, int rows_per_split) {
  __shared__ bool is_last;
  extern __shared__ __align__(16) float smem[];
  const int half = din / 2;
  const int tile = blockIdx.x, split = blockIdx.y, m0 = blockIdx.z * MT;
  const int n_split = gridDim.y;
  const int r0 = split * rows_per_split;
  const int nr = min(half, r0 + rows_per_split) - r0;
  const int ld = 2 * rows_per_split;
  float* xs = smem;            // [MT][ld]: low rows at [0, nr), high rows at [rows_per_split, +nr)
  float* red = smem + MT * ld;  // [MT][kTile]

  for (int i = threadIdx.x; i < MT * 2 * nr; i += kThreads) {
    const int m = i / (2 * nr), j = i % (2 * nr);
    const bool low = j < nr;
    const int k = low ? r0 + j : half + r0 + (j - nr);
    const int slot = low ? j : rows_per_split + (j - nr);
    xs[m * ld + slot] = m0 + m < M ? __bfloat162float(x[(size_t)(m0 + m) * din + k]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = tile * kTile + lane * kCols;
  const bool ok = col0 < dout;  // dout % kCols == 0: a lane's columns are all in or all out
  const int per_warp = (nr + kWarps - 1) / kWarps;
  const int wr0 = r0 + min(nr, warp * per_warp);
  const int wr1 = r0 + min(nr, (warp + 1) * per_warp);
  const int g_high = half / gs;  // group offset of the high rows

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  if (ok) {
    for (int seg = wr0; seg < wr1;) {
      const int g = seg / gs;
      const int seg_end = min(wr1, (g + 1) * gs);
      __nv_bfloat162 slo[4][2], shi[4][2];
      load_scale_pairs(s + (size_t)g * dout + col0, slo);
      load_scale_pairs(s + (size_t)(g + g_high) * dout + col0, shi);
      // explicit batches: all kBatch rows' loads are issued before any is used (left to
      // itself the compiler interleaves each load with its use, one round trip per row)
      for (int rb = seg; rb < seg_end; rb += kBatch) {
        uint4 raw[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          raw[i] = rb + i < seg_end
                       ? __ldg(reinterpret_cast<const uint4*>(q + (size_t)(rb + i) * dout + col0))
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int r = rb + i;
          if (r >= seg_end) break;
          const unsigned words[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
          float xl[MT], xh[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            xl[m] = xs[m * ld + (r - r0)];
            xh[m] = xs[m * ld + rows_per_split + (r - r0)];
          }
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            float2 lo[2], hi[2];
            dequant4(words[t], slo[t], shi[t], lo, hi);
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int ca = 4 * t + k, cb = ca + 2;  // the pair's two columns
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                acc[m][ca] = fmaf(xh[m], hi[k].x, fmaf(xl[m], lo[k].x, acc[m][ca]));
                acc[m][cb] = fmaf(xh[m], hi[k].y, fmaf(xl[m], lo[k].y, acc[m][cb]));
              }
            }
          }
        }
      }
      seg = seg_end;
    }
  }

  // sum the warps' slices in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float* p = red + m * kTile + lane * kCols + j;
          *p = w == 0 ? acc[m][j] : *p + acc[m][j];
        }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < MT * kTile; i += kThreads) {
    const int m = i / kTile, c = tile * kTile + i % kTile;
    if (m0 + m < M && c < dout) {
      if (n_split == 1) {
        out[(size_t)(m0 + m) * dout + c] = red[i];
      } else {
        part[((size_t)split * M + m0 + m) * dout + c] = red[i];
      }
    }
  }
  if (n_split == 1) return;

  // the tile's last CTA adds the splits in split order, eight loads in flight at a time
  __threadfence();
  __syncthreads();
  unsigned* counter = counters + blockIdx.z * gridDim.x + tile;
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1u) == (unsigned)n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < MT * kTile; i += kThreads) {
    const int m = i / kTile, c = tile * kTile + i % kTile;
    if (m0 + m < M && c < dout) {
      const float* p = part + (size_t)(m0 + m) * dout + c;
      const size_t stride = (size_t)M * dout;
      float t = 0.f;
      for (int k0 = 0; k0 < n_split; k0 += 8) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = k0 + k < n_split ? __ldcg(p + (k0 + k) * stride) : 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) t += v[k];
      }
      out[(size_t)(m0 + m) * dout + c] = t;
    }
  }
}

template <int MT>
int launch(const void* x, const void* q, const void* s, void* out, void* part, void* counters,
           int M, int din, int dout, int gs, int n_split, int rows_per_split,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      int4_matmul_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((dout + kTile - 1) / kTile, n_split, (M + MT - 1) / MT);
  const size_t smem = (size_t)(MT * 2 * rows_per_split + MT * kTile) * sizeof(float);
  int4_matmul_kernel<MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const __nv_bfloat16*>(s), static_cast<float*>(out), static_cast<float*>(part),
      static_cast<unsigned*>(counters), M, din, dout, gs, rows_per_split);
  return cudaGetLastError();
}

}  // namespace

// x [M, din] bf16, q [din/2, dout] int8, s [G, dout] bf16, out [M, dout] fp32; part
// [n_split, M, dout] fp32 scratch and counters (ceil(dout / 512) * ceil(M / MT) unsigned,
// zeroed here on the stream) when n_split > 1.  All contiguous; 1 <= M <= 64,
// din % (2 * gs) == 0, dout % 16 == 0, every split non-empty and at most 1024 packed rows.
extern "C" int zt_int4_matmul(const void* x, const void* q, const void* s, void* out, void* part,
                              void* counters, int M, int din, int dout, int gs, int n_split,
                              void* stream) {
  const int half = din / 2;
  if (M < 1 || M > 64 || n_split < 1 || gs < 1 || din % (2 * gs) || dout % kCols)
    return cudaErrorInvalidValue;
  const int rows_per_split = (half + n_split - 1) / n_split;
  if (rows_per_split > kMaxRowsPerSplit || (n_split - 1) * rows_per_split >= half)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rps = rows_per_split;
  if (n_split > 1) {
    const int mt = M <= 2 ? M : kMaxMT;
    const size_t n = (size_t)((dout + kTile - 1) / kTile) * ((M + mt - 1) / mt);
    const cudaError_t err = cudaMemsetAsync(counters, 0, n * sizeof(unsigned), st);
    if (err != cudaSuccess) return err;
  }
  if (M == 1) return launch<1>(x, q, s, out, part, counters, M, din, dout, gs, n_split, rps, st);
  if (M == 2) return launch<2>(x, q, s, out, part, counters, M, din, dout, gs, n_split, rps, st);
  return launch<4>(x, q, s, out, part, counters, M, din, dout, gs, n_split, rps, st);
}
