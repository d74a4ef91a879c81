// K8: x [M, din] @ dequant(int4 q [din/2, dout], bf16 s [G, dout]) -> fp32 [M, dout],
// for the few rows (M <= 64) of a decode step, on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel int4_matmul_pallas (zonos_tpu/ops/pallas_kernels.py:294;
// body _int4_matmul_kernel :272).  q holds two weights per byte in the "halves" layout:
// packed row p carries weight row p in its low nibble and row p + din/2 in its high one;
// s holds one scale per gs = din / G rows and column.  As in the Pallas body, each weight
// is q * s rounded to bf16, and the products with bf16 x are summed in fp32.
//
// What bounds it on an H100: at M <= 64 each weight feeds at most 64 multiply-adds, far
// below the card's ridge, so the floor is reading the packed weights (din * dout / 2 bytes)
// and the scales once from HBM (3.35 TB/s): 17.3 MB and ~5.2 us for the flagship's w1.
//
// Design.
// - Operand roles.  Each mma.sync.m16n8k16 (bf16 in, fp32 accumulate) takes the weights as
//   A (16 output columns x 16 k) and x as B (16 k x 8 rows of x), so it computes a 16 x 8
//   tile of out^T.  M <= 8 takes one n-tile; up to 64 rows take up to eight (NT), which
//   share every dequantized A fragment: each packed byte is read from HBM and dequantized
//   once, whatever M.  (The CUDA-core loop this replaces did 2 * M fp32 FMAs a weight and
//   read the weights again for every further 4 rows.)
// - The k permutation.  The contraction does not care about the order of k as long as A
//   and B use the same.  An A register holds an adjacent k-pair of one A row; here the pair
//   is the two nibbles of one packed byte: k = 2i is weight row p (low nibble, group p / gs)
//   and k = 2i + 1 is row p + din/2 (high nibble, group p / gs + G/2).  A k-step of 16 k
//   therefore covers 8 packed rows p0..p0+7, k-pair i <-> packed row p0 + i (gs % 8 == 0,
//   so a k-step never straddles a group).  x is staged in shared memory as the matching
//   bf16 pairs xs[n][p] = (x[n][p], x[n][p + din/2]), one 32-bit word each, so a B register
//   is one shared load; the scales likewise as pairs (s[g][c], s[g + G/2][c]).
// - Dequantizing a byte into an A register, off the card's slow conversion units: one byte
//   permute puts the byte's low nibble in bits 0-3 and its high nibble in bits 16-19, one
//   logic op makes the bf16 pair (128 + (lo ^ 8), 128 + (hi ^ 8)), a bf16x2 subtract of 136
//   (exact) gives the signed values, and a bf16x2 multiply by the column's scale pair
//   rounds q * s to bf16 as the Pallas body does.
// - The column permutation.  A lane (gid = lane / 4, tig = lane % 4) needs, per m-tile, A
//   rows gid and gid + 8 at k-pairs tig and tig + 4, i.e. bytes of packed rows p0 + tig and
//   p0 + tig + 4.  So a lane loads V = 2 * MTI contiguous packed bytes of each of those two
//   rows (one 16-, 8- or 4-byte load each; the 8 lanes of one tig read 8 * V contiguous
//   bytes), and the warp's 16 * MTI columns are dealt out so that byte 2j of a lane's chunk
//   is A row gid of m-tile j and byte 2j + 1 is A row gid + 8: m-tile j's A row gid is
//   column c0 + V * gid + 2j and its row gid + 8 is column c0 + V * gid + 2j + 1.  The
//   epilogue writes each accumulator back to its true column.
// - Worked example (M <= 8: MTI = 8, V = 16; a warp whose columns start at c0 = 0 and a
//   k-step at packed row 64; din 2048, groups of 128 rows).  Lane 9 (gid 2, tig 1) loads
//   q[65][32..47] and q[69][32..47].  Byte q[65][38] (chunk byte 6) becomes register a0 of
//   m-tile 3: A row 2 = column 38 at k-pair 1 = weights w[65][38] and w[1089][38], times
//   scales s[0][38] and s[8][38].  q[65][39] becomes a1 (A row 10 = column 39), q[69][38]
//   a2 and q[69][39] a3.  The lane's B registers are (x[2][65], x[2][1089]) and
//   (x[2][69], x[2][1093]).  Its m-tile 3 accumulators hold out[2][38], out[3][38],
//   out[2][39] and out[3][39].
// - Loads in flight: a lane issues the loads of a batch of KB k-steps (128 bytes of packed
//   rows: 8 rows of 16 bytes at MTI = 8) before it uses any of them, and issues the next
//   batch before it consumes the current one (two register buffers), so up to 256 bytes a
//   lane are in flight.  Registers, not a cp.async ring: the bytes are used once, by the
//   lane that loaded them, so a trip through shared memory would only add traffic.  The
//   first batch is issued before x and the scales are staged, whose loads are all issued
//   before any is stored, so a CTA's prologue costs about one memory latency.
// - Tiles and splits.  A CTA (8 warps) owns 16 * MTI columns (MTI = 8 up to 16 rows of x,
//   4 up to 32, 2 up to 64, which keeps the accumulators at 32-64 registers), one warp's
//   width, and its 8 warps lie one above the other, each a contiguous slice of every chunk
//   of 512 packed rows the CTA stages (x's pairs and the scales, restaged a chunk).  The
//   chunk size and the 8 slices are the same for every M, so a row's sums run through the
//   same k-steps in the same order alone and in a batch: more rows take narrower column
//   tiles (more CTAs), never other slices.  The 8 slices are summed in one pass through
//   shared memory, in warp order (columns swizzled by c ^ ((c / V) & 7) so that neither the
//   fragment stores nor the row-order reads conflict on banks).  The packed rows are also
//   split over the grid's y dimension, up to one CTA per SM at 128 columns a tile
//   (kernels/int4_matmul.py split_count: from din, dout and the SM count, not M); each split
//   writes its fp32 partial sums and the last CTA of a column tile to finish (an atomic
//   counter per tile) adds them in split order, so the result depends neither on the order
//   the CTAs ran in nor on M.  The counters are the call's own, zeroed on its stream before
//   the launch.  One launch.
// - Columns need not fill the last tile (dout % 16 == 0 suffices, so that a lane's chunk is
//   all in or all out): the hybrid's in_proj has dout 8512.  Rows of x past M and scales
//   past dout are not staged: they only reach accumulators that are never stored.
// - mma.sync rather than wgmma: at the decode steps' M <= 8 the tensor-core work at
//   mma.sync's rate is a small part of the time to read the weights, and mma.sync takes A
//   straight from the registers the dequantization fills, per warp, with no warpgroup-wide
//   fences or shared-memory layout for B.  wgmma with A from registers (64 columns a
//   warpgroup) and x in shared memory as B is the natural next step (it also lifts the
//   M = 64 case, where mma.sync's rate matters), with TMA loads of the packed rows, a
//   thread-block-cluster reduction through distributed shared memory in place of the
//   partials, the counters and the memset, and a persistent kernel.
//
// - A norm folded in (XN 1: bf16 x, 2: fp32 x; zt_int4_matmul_norm): the product of a
//   LayerNorm's or RMSNorm's output rounded to bf16, with no launch for the norm.  After
//   issuing its first batch of weight loads, warp w computes the statistics of rows w, w + 8,
//   ... over all of din (row_stats.cuh, N1's code), into shared memory; the staging then
//   normalises each x element of a pair with its own column's scale and bias (x[n][c0 + j]
//   at column c0 + j, x[n][half + c0 + j] at half + c0 + j) and rounds it to bf16 before it
//   pairs them: the bits N1 would have written.
//
// C interface (ctypes): returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_stats.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStep = 8;               // packed rows per k-step of 16 k
constexpr int kLaneBytes = 128;        // packed bytes of one batch of a lane
constexpr int kColAlign = 16;
constexpr int kMaxRowsPerSplit = 1024;
constexpr int kChunkRows = 512;        // packed rows a CTA stages at once, for every M
constexpr int kStageUnroll = 4;        // staging items whose loads a thread has in flight

constexpr int n_tiles(int M) { return M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8; }
// m-tiles of a warp at NT n-tiles (the CTA's columns: 16 * MTI)
constexpr int mt_of(int nt) { return nt <= 2 ? 8 : nt == 4 ? 4 : 2; }

// Shared memory words: x pairs for a chunk of rows (row stride rows + 4, which is 4 mod 8,
// so the lanes' B loads hit 32 banks), the scale pairs of the groups they span (at most
// ceil(rows / gs) + 1), or the reduction buffer of the 8 warps' slices, whichever is larger.
constexpr int smem_words(int nt, int mti, int rows, int gs) {
  const int tile = 16 * mti;
  const int stage = 8 * nt * (rows + 4) + ((rows + gs - 1) / gs + 1) * tile;
  const int red = kWarps * 8 * nt * (tile + 4);
  return stage > red ? stage : red;
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned bits) {
  __nv_bfloat162 v;
  *reinterpret_cast<unsigned*>(&v) = bits;
  return v;
}

__device__ __forceinline__ unsigned bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// N 32-bit words of packed weights from global memory aligned to min(16, 4 * N) bytes: the
// read-only path, not allocated in L1: each byte is read once, by the lane that uses it.
template <int N>
__device__ __forceinline__ void load_words(const void* p, unsigned* w) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(w[4 * i]), "=r"(w[4 * i + 1]), "=r"(w[4 * i + 2]), "=r"(w[4 * i + 3])
                   : "l"(static_cast<const uint4*>(p) + i));
    }
  } else if constexpr (N == 2) {
    asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
                 : "=r"(w[0]), "=r"(w[1])
                 : "l"(p));
  } else {
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(w[0]) : "l"(p));
  }
}

template <int N>
__device__ __forceinline__ void zero_words(unsigned* w) {
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = 0u;
}

// Issues the loads of the batch of k-steps at packed row r: at most KB k-steps, all in the
// group of row r and below row end; qp points at the lane's chunk of packed row tig, and a
// lane past dout (ok false) takes zeros.  Returns the batch's k-steps.
template <int KB, int W>
__device__ __forceinline__ int issue_loads(const int8_t* qp, int r, int end, int gs, int dout,
                                           bool ok, unsigned (&raw)[KB][2][W]) {
  const int steps = min(KB, (min(end, (r / gs + 1) * gs) - r) / kStep);
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    const int8_t* p = qp + (size_t)(r + i * kStep) * dout;
    if (ok && i < steps) {
      load_words<W>(p, raw[i][0]);
      load_words<W>(p + (size_t)4 * dout, raw[i][1]);
    } else {
      zero_words<W>(raw[i][0]);
      zero_words<W>(raw[i][1]);
    }
  }
  return steps;
}

// One word of packed bytes (4 columns of one packed row) -> four A registers: a[k] =
// (w[p][c + k], w[p + din/2][c + k]) * (s_lo, s_hi) as bf16x2, with sp[k] the scale pair of
// column c + k.
__device__ __forceinline__ void dequant_word(unsigned word, const __nv_bfloat162* sp,
                                             unsigned (&a)[4]) {
  const __nv_bfloat162 k136 = as_bf162(0x43084308u);  // bf16 136.0 twice
  const unsigned high = word >> 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // byte k's low nibble to bits 0-3, its high nibble to bits 16-19
    const unsigned p = __byte_perm(word, high, k | ((k + 4) << 8));
    const unsigned v = ((p ^ 0x00080008u) & 0x000F000Fu) | 0x43004300u;  // 128 + (n ^ 8)
    a[k] = bits_of(__hmul2(__hsub2(as_bf162(v), k136), sp[k]));
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The MMAs of one batch: `steps` k-steps from raw, whose first packed row is row j0 of the
// staged x pairs xs (row stride ld); spw points at the lane's V staged scale pairs of the
// batch's group.
template <int NT, int MTI, int KB>
__device__ __forceinline__ void consume(const unsigned (&raw)[KB][2][MTI / 2], int steps,
                                        const unsigned* xs, int ld, int j0,
                                        const unsigned* spw, float (&acc)[MTI][NT][4]) {
  constexpr int V = 2 * MTI, W = MTI / 2;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  __nv_bfloat162 sp[V];
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const uint4 v = reinterpret_cast<const uint4*>(spw)[i];
    sp[4 * i] = as_bf162(v.x);
    sp[4 * i + 1] = as_bf162(v.y);
    sp[4 * i + 2] = as_bf162(v.z);
    sp[4 * i + 3] = as_bf162(v.w);
  }
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    if (i >= steps) break;  // warp-uniform
    unsigned b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const unsigned* xr = xs + (nt * 8 + gid) * ld + j0 + i * kStep + tig;
      b[nt][0] = xr[0];
      b[nt][1] = xr[4];
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      unsigned a[2][4];  // [row p0 + tig, p0 + tig + 4][byte 4w + k of the chunk]
      dequant_word(raw[i][0][w], sp + 4 * w, a[0]);
      dequant_word(raw[i][1][w], sp + 4 * w, a[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h)  // m-tile 2w + h: chunk bytes 4w + 2h and 4w + 2h + 1
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[2 * w + h][nt], a[0][2 * h], a[0][2 * h + 1], a[1][2 * h],
                   a[1][2 * h + 1], b[nt][0], b[nt][1]);
    }
  }
}

// A folded norm (XN != 0): x [M, din] bf16 (XN 1) or fp32 (2), its bf16 scale and bias
// [din] (bias null: none), eps, rms; the rows' (mean, r) in shared memory.
struct FoldedNorm {
  const void* x;
  const __nv_bfloat16* scale;
  const __nv_bfloat16* bias;
  float eps;
  int rms;
  const float2* stats;
};

// The normalised x[n][c..c + 7] rounded to bf16, as one 16-byte word.
template <int XN>
__device__ __forceinline__ uint4 normalised8(const FoldedNorm& f, int n, int din, int c) {
  float v[8], sc[8], b[8];
  if constexpr (XN == 1)
    row_stats::load8(static_cast<const __nv_bfloat16*>(f.x) + (size_t)n * din + c, v);
  else
    row_stats::load8(static_cast<const float*>(f.x) + (size_t)n * din + c, v);
  row_stats::load_params(f.scale, f.bias, c, sc, b);
  row_stats::normalise8(v, f.stats[n], sc, b, f.bias != nullptr);
  return row_stats::pack8(v);
}

// Stages packed rows [c0, c0 + cn) of a CTA: xs[n][j] = (x[n][c0 + j], x[n][half + c0 + j])
// for n < M (row stride ld), and ss[g - g0][c] = (s[g][c], s[g + G/2][c]) for the groups g0..
// of those rows and the tile's columns below dout.  Each item is two 16-byte loads (8
// values each) and two 16-byte stores of 8 pairs; a thread issues the loads of
// kStageUnroll items before it stores any.  A folded norm (XN) normalises x's two 8-value
// halves of an item as it loads them.
template <int kTile, int XN>
__device__ __forceinline__ void stage(const __nv_bfloat16* x, const __nv_bfloat16* s,
                                      unsigned* xs, unsigned* ss, int M, int din, int dout,
                                      int gs, int tile, int c0, int cn, int ld,
                                      const FoldedNorm& f) {
  const int half = din / 2;
  const int blocks = cn / 8;  // items of a row of x
  const int g0 = c0 / gs, ng = (c0 + cn - 1) / gs - g0 + 1;
  const int nx = M * blocks, n_items = nx + ng * (kTile / 8);
  for (int i0 = threadIdx.x; i0 < n_items; i0 += kStageUnroll * kThreads) {
    uint4 lo[kStageUnroll], hi[kStageUnroll];
    unsigned* dst[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * kThreads;
      const __nv_bfloat16 *src_lo = nullptr, *src_hi = nullptr;
      dst[u] = nullptr;
      if (i < nx) {
        const int n = i / blocks, j = (i % blocks) * 8;
        dst[u] = xs + n * ld + j;
        if constexpr (XN != 0) {
          lo[u] = normalised8<XN>(f, n, din, c0 + j);
          hi[u] = normalised8<XN>(f, n, din, half + c0 + j);
        } else {
          src_lo = x + (size_t)n * din + c0 + j;
          src_hi = src_lo + half;
        }
      } else if (i < n_items) {
        const int g = (i - nx) / (kTile / 8), c = ((i - nx) % (kTile / 8)) * 8;
        if (tile * kTile + c < dout) {
          src_lo = s + (size_t)(g0 + g) * dout + tile * kTile + c;
          src_hi = src_lo + (size_t)(half / gs) * dout;
          dst[u] = ss + g * kTile + c;
        }
      }
      if (src_lo != nullptr) {
        lo[u] = __ldg(reinterpret_cast<const uint4*>(src_lo));
        hi[u] = __ldg(reinterpret_cast<const uint4*>(src_hi));
      }
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      if (dst[u] == nullptr) continue;
      uint4* d = reinterpret_cast<uint4*>(dst[u]);
      d[0] = make_uint4(__byte_perm(lo[u].x, hi[u].x, 0x5410), __byte_perm(lo[u].x, hi[u].x, 0x7632),
                        __byte_perm(lo[u].y, hi[u].y, 0x5410), __byte_perm(lo[u].y, hi[u].y, 0x7632));
      d[1] = make_uint4(__byte_perm(lo[u].z, hi[u].z, 0x5410), __byte_perm(lo[u].z, hi[u].z, 0x7632),
                        __byte_perm(lo[u].w, hi[u].w, 0x5410), __byte_perm(lo[u].w, hi[u].w, 0x7632));
    }
  }
}

// grid (ceil(dout / (16 * MTI)), n_split); dynamic shared memory smem_words(NT, MTI, rows,
// gs) words, rows = min(rows_per_split, kChunkRows).  out is [M, dout]; part
// [n_split, M, dout] and counters (one per column tile, zero on entry) serve a split
// contraction.  XN: 0 bf16 x; 1 or 2 a folded norm over bf16 or fp32 x (norm.x; x unused).
template <int NT, int MTI, int XN>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                   const __nv_bfloat16* __restrict__ s, float* __restrict__ out,
                   float* __restrict__ part, unsigned* __restrict__ counters, int M, int din,
                   int dout, int gs, int rows_per_split, FoldedNorm norm) {
  constexpr int V = 2 * MTI;                // packed bytes (columns) a lane loads per row
  constexpr int W = V / 4;                  // their 32-bit words
  constexpr int kTile = 16 * MTI;           // the CTA's columns: one warp's
  constexpr int kRedLd = kTile + 4;         // row stride (floats) of the reduction buffer
  constexpr int WC = 1;                     // warps across the tile's columns
  constexpr int WR = kWarps;                // warps over the split's rows: 8 for every M
  constexpr int KB = kLaneBytes / (2 * V);  // k-steps of one batch
  constexpr int NR = 8 * NT;                // rows of x the n-tiles hold
  __shared__ bool is_last;
  __shared__ float2 xstats[XN ? 8 * NT : 1];  // a folded norm's (mean, r) of each row
  extern __shared__ __align__(16) unsigned smem[];

  const int half = din / 2;
  const int tile = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int r0 = split * rows_per_split;
  const int nr = min(half, r0 + rows_per_split) - r0;  // a multiple of kStep
  const int crows = min(rows_per_split, kChunkRows);
  const int ld = crows + 4;  // words a staged row of x; 4 mod 8: conflict-free B loads
  unsigned* xs = smem;
  unsigned* ss = smem + NR * ld;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wc = warp % WC, wr = warp / WC;
  const int wcol = tile * kTile + wc * 16 * MTI;  // the warp's first column
  const int col = wcol + V * gid;                 // the lane's first column
  const bool active = wcol < dout;                // warp-uniform
  const bool ok = col < dout;                     // dout % 16 == 0: all V columns in or out
  const int8_t* qp = q + (size_t)tig * dout + col;  // the lane's chunk of packed row tig
  const unsigned* spl = ss + wc * 16 * MTI + V * gid;  // its scale pairs in a staged group

  float acc[MTI][NT][4];
#pragma unroll
  for (int j = 0; j < MTI; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;

  for (int c0 = r0; c0 < r0 + nr; c0 += crows) {
    const int cn = min(crows, r0 + nr - c0);
    const int per = ((cn + WR - 1) / WR + kStep - 1) / kStep * kStep;
    const int w1 = c0 + min(cn, (wr + 1) * per);
    const int g0 = c0 / gs;
    int r = c0 + min(cn, wr * per);
    unsigned raw_a[KB][2][W], raw_b[KB][2][W];  // two batches: [k-step][rows tig, tig + 4][word]
    int sa = 0, sb = 0;
    if (active && r < w1) sa = issue_loads(qp, r, w1, gs, dout, ok, raw_a);
    if (c0 > r0) {
      __syncthreads();  // every warp is done with the previous chunk's stage
    } else if constexpr (XN != 0) {  // the rows' statistics, the first batch's loads in flight
      using T = typename std::conditional<XN == 1, __nv_bfloat16, float>::type;
      for (int n = warp; n < M; n += 2 * kWarps) {
        const T* x0 = static_cast<const T*>(norm.x) + (size_t)n * din;
        // (4 steps of loads in flight: the first batch's weight words hold registers too)
        if (M <= kWarps) {  // a row a warp
          const T* rows[1] = {x0};
          float2 st[1];
          row_stats::stats_rows<1, 4>(rows, din, norm.eps, norm.rms != 0, st);
          if (lane == 0) xstats[n] = st[0];
          continue;
        }
        // rows n and n + 8, their loads in flight together
        const T* rows[2] = {x0, n + kWarps < M ? x0 + (size_t)kWarps * din : x0};
        float2 st[2];
        row_stats::stats_rows<2, 2>(rows, din, norm.eps, norm.rms != 0, st);
        if (lane == 0) {
          xstats[n] = st[0];
          if (n + kWarps < M) xstats[n + kWarps] = st[1];
        }
      }
      norm.stats = xstats;
      __syncthreads();
    }
    stage<kTile, XN>(x, s, xs, ss, M, din, dout, gs, tile, c0, cn, ld, norm);
    __syncthreads();
    if (!active) continue;
    while (r < w1) {
      const int ra = r + sa * kStep;
      if (ra < w1) sb = issue_loads(qp, ra, w1, gs, dout, ok, raw_b);
      consume<NT, MTI, KB>(raw_a, sa, xs, ld, r - c0, spl + (r / gs - g0) * kTile, acc);
      if (ra >= w1) break;
      const int rb = ra + sb * kStep;
      if (rb < w1) sa = issue_loads(qp, rb, w1, gs, dout, ok, raw_a);
      consume<NT, MTI, KB>(raw_b, sb, xs, ld, ra - c0, spl + (ra / gs - g0) * kTile, acc);
      r = rb;
    }
  }

  // sum the WR row slices in warp order, through shared memory (the stage is done with)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [WR][NR][kRedLd], columns swizzled
#pragma unroll
  for (int j = 0; j < MTI; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // accumulator e: row n = 2 tig + (e & 1) of the n-tile, A row gid (e < 2) or gid + 8
        const int n = nt * 8 + 2 * tig + (e & 1);
        const int c = wc * 16 * MTI + V * gid + 2 * j + (e >> 1);
        if (n < M) red[(wr * NR + n) * kRedLd + (c ^ ((c / V) & 7))] = acc[j][nt][e];
      }
  __syncthreads();
  float* dst = n_split == 1 ? out : part + (size_t)split * M * dout;
  for (int i = threadIdx.x; i < M * kTile; i += kThreads) {
    const int n = i / kTile, c = i % kTile;
    if (tile * kTile + c >= dout) continue;
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < WR; ++k) t += red[(k * NR + n) * kRedLd + (c ^ ((c / V) & 7))];
    dst[(size_t)n * dout + tile * kTile + c] = t;
  }
  if (n_split == 1) return;

  // the tile's last CTA adds the splits in split order, eight loads in flight at a time
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counters + tile, 1u) == (unsigned)n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < M * kTile; i += kThreads) {
    const int n = i / kTile, c = tile * kTile + i % kTile;
    if (c < dout) {
      const float* p = part + (size_t)n * dout + c;
      const size_t stride = (size_t)M * dout;
      float t = 0.f;
      for (int k0 = 0; k0 < n_split; k0 += 8) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = k0 + k < n_split ? __ldcg(p + (k0 + k) * stride) : 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) t += v[k];
      }
      out[(size_t)n * dout + c] = t;
    }
  }
}

template <int NT, int MTI, int XN>
int launch(const void* x, const void* q, const void* s, void* out, void* part, void* counters,
           int M, int din, int dout, int gs, int n_split, int rows_per_split, const FoldedNorm& f,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      int4_matmul_kernel<NT, MTI, XN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_words(NT, MTI, kChunkRows, kStep) * (int)sizeof(unsigned));
  if (attr != cudaSuccess) return attr;
  const int rows = rows_per_split < kChunkRows ? rows_per_split : kChunkRows;
  const int tile = 16 * MTI;
  const dim3 grid((dout + tile - 1) / tile, n_split);
  const size_t smem = (size_t)smem_words(NT, MTI, rows, gs) * sizeof(unsigned);
  int4_matmul_kernel<NT, MTI, XN><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const __nv_bfloat16*>(s), static_cast<float*>(out), static_cast<float*>(part),
      static_cast<unsigned*>(counters), M, din, dout, gs, rows_per_split, f);
  return cudaGetLastError();
}

template <int XN>
int run(const void* x, const void* q, const void* s, void* out, void* part, void* counters,
        int M, int din, int dout, int gs, int n_split, const FoldedNorm& f, void* stream) {
  const int half = din / 2;
  if (M < 1 || M > 64 || n_split < 1 || gs < 1 || gs % kStep || din % (2 * gs) ||
      dout % kColAlign)
    return cudaErrorInvalidValue;
  const int rows_per_split = ((half + n_split - 1) / n_split + kStep - 1) / kStep * kStep;
  if (rows_per_split > kMaxRowsPerSplit || (n_split - 1) * rows_per_split >= half)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split > 1) {
    const int tile = 16 * mt_of(n_tiles(M));
    const size_t n = (size_t)(dout + tile - 1) / tile;
    const cudaError_t err = cudaMemsetAsync(counters, 0, n * sizeof(unsigned), st);
    if (err != cudaSuccess) return err;
  }
  const int rps = rows_per_split;
  switch (n_tiles(M)) {
    case 1:
      return launch<1, 8, XN>(x, q, s, out, part, counters, M, din, dout, gs, n_split, rps, f,
                              st);
    case 2:
      return launch<2, 8, XN>(x, q, s, out, part, counters, M, din, dout, gs, n_split, rps, f,
                              st);
    case 4:
      return launch<4, 4, XN>(x, q, s, out, part, counters, M, din, dout, gs, n_split, rps, f,
                              st);
    default:
      return launch<8, 2, XN>(x, q, s, out, part, counters, M, din, dout, gs, n_split, rps, f,
                              st);
  }
}

}  // namespace

// x [M, din] bf16, q [din/2, dout] int8, s [G, dout] bf16, out [M, dout] fp32; part
// [n_split, M, dout] fp32 scratch and counters (ceil(dout / 128) unsigned, zeroed here on the
// stream) when n_split > 1.  All contiguous and 16-byte aligned; 1 <= M <= 64, gs % 8 == 0,
// din % (2 * gs) == 0, dout % 16 == 0; each split holds ceil(din / 2 / n_split) packed rows
// rounded up to 8, at most 1024, and none is empty.
extern "C" int zt_int4_matmul(const void* x, const void* q, const void* s, void* out, void* part,
                              void* counters, int M, int din, int dout, int gs, int n_split,
                              void* stream) {
  return run<0>(x, q, s, out, part, counters, M, din, dout, gs, n_split, FoldedNorm{}, stream);
}

// The same product of norm(x) rounded to bf16: x [M, din] bf16 (x_f32 = 0) or fp32 (1), 16-byte
// aligned; scale [din] bf16 and bias [din] bf16 or null (allowed with rms only), both 16-byte
// aligned; rms: 1 RMSNorm, 0 LayerNorm.  The rest as zt_int4_matmul.
extern "C" int zt_int4_matmul_norm(const void* x, const void* scale, const void* bias,
                                   const void* q, const void* s, void* out, void* part,
                                   void* counters, int M, int din, int dout, int gs, int n_split,
                                   int x_f32, float eps, int rms, void* stream) {
  if (scale == nullptr || (!rms && bias == nullptr) || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(scale) & 15) || (reinterpret_cast<uintptr_t>(bias) & 15))
    return cudaErrorInvalidValue;
  const FoldedNorm f{x, static_cast<const __nv_bfloat16*>(scale),
                     static_cast<const __nv_bfloat16*>(bias), eps, rms, nullptr};
  return x_f32 ? run<2>(nullptr, q, s, out, part, counters, M, din, dout, gs, n_split, f, stream)
               : run<1>(nullptr, q, s, out, part, counters, M, din, dout, gs, n_split, f, stream);
}
