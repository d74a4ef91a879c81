// G1: y [M, N] = x [M, K] @ w [K, N] with bf16 x and a bf16 or int8 weight, on Hopper's tensor
// cores (sm_90a: wgmma, TMA, clusters), in a summation order that the weight's shape fixes and
// the row count does not.
//
// Replaces no TPU kernel: the JAX package computes these products with XLA's dot
// (zonos_tpu/models/backbone.py:46-79 matmul_w).  The port needs its own because a library
// product (cuBLAS) picks its kernel and its split of the contraction by the row count M, so a
// request's rows summed in a batch of 8 differ in the last bit from the same rows alone, and
// a served request's codes then change with its co-batched peers.  Here the order is fixed:
//
//   - the contraction is cut into n_split splits of rows_per_split rows (a multiple of 64;
//     the last split may be shorter), where n_split comes from (K, N, the card's SM count)
//     only (kernels/gemm.py split_count);
//   - inside a split, one wgmma.m64n128k16 (bf16 in, fp32 accumulators) per 16 k in
//     increasing k, the first of the split starting from 0;
//   - the splits' sums are added in split order into an fp32 total that starts at 0;
//   - the total is rounded to bf16 once (int8: then multiplied by the column's bf16 scale and
//     rounded again, as the JAX package and the plain version compute (x @ q) * s).
//
// Rows never share an accumulator, and the instruction, its operands' layout and the order
// are the same for every M and every row's place in a tile: a row's result is the same bits
// alone and in any batch.  What M chooses (one or two consumer warpgroups, whether the splits
// run as the CTAs of a cluster or one after another in one CTA) moves no bit; chip_smoke.py's
// G1 check holds every choice against the others bit for bit.
//
// What bounds it on an H100: at the decode steps' few rows every weight element feeds 2 M
// flops, far below the card's ridge (~295 flop/byte in bf16), so the floor is reading the
// weight once (2 K N bytes, or K N for int8): ~10 us for the flagship's w2 [8192, 2048].  At
// a batch-64 prefill (M = 9088) the products are bound by the tensor cores (2 M K N flops at
// 989 TFLOP/s, ~0.31 ms for w2).  wgmma pads a decode step's 2 rows to 64, which the weight's
// bytes still bound (w1 at M = 2: ~4.3 padded GFLOP, ~5 us, against a 20 us byte bound).
//
// Design.
// - A CTA owns 128 columns and 64 rows a consumer warpgroup: one (M <= 64) or two.  One
//   producer warp (its warpgroup's registers lowered with setmaxnreg where two consume)
//   keeps a ring of stages in flight, each a 64-k slice: x [64 NC rows][64 k] and the weight
//   [64 k][128 columns], loaded by TMA (cp.async.bulk.tensor.2d, tensor maps built on the
//   host with cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so no -lcuda,
//   passed as __grid_constant__ parameters so a CUDA graph captures them by value), each
//   stage guarded by a full and an empty mbarrier.  TMA zero-fills k past K and columns past
//   N.  x's box holds M rounded up to 8 rows (at most the tile's): the rows of the 64 a
//   warpgroup multiplies that lie past it hold stale shared memory, and their outputs,
//   which no other row's sums touch, are never stored (M = 2: 1 KB a stage, not 8).
// - Operands straight from shared memory with 128-byte swizzle: x as A, K-major, one box of
//   128-byte rows (descriptor SBO 1024 bytes: 8 rows; a 16-k step moves 32 bytes); the
//   weight as B, N-major (the transpose bit; bf16 allows it), two boxes of 64 columns
//   (descriptor SBO 1024 bytes: 8 k rows, LBO 8192 bytes: the next box; a 16-k step moves
//   2048 bytes).  The consumers keep one wgmma group in flight and free a stage when the
//   group before it has completed.
// - int8 weights: wgmma has no bf16 x s8 form.  The stage's int8 tile lands unswizzled
//   [64 k][128 bytes]; the consumers widen it exactly (|q| <= 127) into the stage's bf16
//   tile in the swizzled layout TMA would have written, fence the async proxy and meet at a
//   named barrier before the wgmmas read it; the scales are applied in the epilogue.
// - The splits: while the row and column tiles leave the card short of one CTA an SM, each
//   split is a CTA of a cluster of n_split (at most 8, the portable size) along grid.x;
//   each writes its fp32 partial to its own shared memory, and after a cluster barrier
//   rank r adds a 1/n_split share of the tile's outputs, four columns a thread step: it
//   loads every rank's partial through distributed shared memory (16 bytes each, all
//   issued before the first add) and adds them in split order.  Otherwise one CTA runs its tile's
//   splits in turn, adding each into a register total.  Both add the same numbers in the
//   same order.  No scratch, no counter, no launch beside the kernel's one.
//
// - A norm folded in (XN 1: bf16 x, 2: fp32 x up to 16 rows; zt_gemm_norm): the product of a
//   LayerNorm's or RMSNorm's output, rounded to bf16, with no launch and no buffer for the
//   norm.  Before a tile's k-loop the consumer warps compute its rows' statistics from global
//   memory, one warp a row over all of K (row_stats.cuh, N1's code: the same bits as N1), into
//   shared memory, while the producer already fills the ring; every CTA of a split cluster
//   computes them for its rows (2 rows of 2048: 8 KB from L2).  The accumulators are zeroed
//   only after that, so that their registers are the statistics' own.  The producer adds to
//   each stage the norm's scale and bias for its 64 k (two bulk copies of 128 bytes) and x's
//   box as before: bf16 in the stage's swizzled x tile, fp32 unswizzled (a tensor map of its
//   own) into rows 16-47 of the x tile, whose outputs are never stored (M <= 16: x_rows <= 16
//   rows of 256 bytes).  The consumers normalise x's rows below M chunk by chunk (16 bytes of
//   8 k), round to bf16 and write each chunk c of row m at chunk c ^ (m % 8) of the x tile,
//   where TMA's 128-byte swizzle would have put the normalised rows (bf16 x: in place); then
//   fence the async proxy and meet at the named barrier (with the int8 widening) before the
//   wgmmas.  Everything a stage needs comes with the stage, so the ring hides it as it hides
//   the weight.  The product's order is untouched, so the output is the bits of N1 followed by
//   the plain-x G1.
//
// C interface (ctypes): returns the first error of the tensor maps' encoding or the launch.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_stats.cuh"

namespace {

constexpr int kTileN = 128;    // columns of a CTA: the wgmma's N
constexpr int kWgRows = 64;    // rows of a consumer warpgroup: the wgmma's M
constexpr int kBK = 64;        // k rows of a stage: one 128-byte swizzle row of x
constexpr int kKStep = 16;     // k of one wgmma
constexpr int kBoxN = 64;      // columns of a bf16 weight box (128 bytes)
constexpr int kBoxBytes = kBK * kBoxN * 2;  // 8 KB: one swizzled box, x's per warpgroup too
constexpr int kPartPitch = kTileN + 8;      // floats of a row of a split's partial
constexpr int kMaxSplits = 8;               // a cluster's CTAs: the portable limit
constexpr int kSmemBudget = 200 * 1024;     // two consumer warpgroups' share of 227 KB
constexpr int kGroupRows = 16;  // row tiles a group of the persistent walk (8 and 32 time alike)
constexpr int kChunks = kBK / row_stats::kVec;  // 16-byte chunks of 8 k in a row of x's stage
constexpr int kF32Rows = 16;  // the most rows of fp32 x under a folded norm

// Shared memory: a ring of stages, each x [64 NC][64] bf16 and the weight's 64 k rows (bf16 in
// two swizzled boxes, or int8 [64][128]), and under a folded norm (XN) the norm's scale and
// bias for the stage's k (128 bytes each), each stage rounded up to 1024 bytes (fp32 x's raw
// box lies in the x tile's rows 16-47); for int8, the bf16 tiles the consumers widen into, in
// turn; with two consumer warpgroups, a staging tile for the TMA stores.  One consumer
// warpgroup (M <= 64) keeps to 4 stages and one producer warp, so that two CTAs share an SM
// and a cluster of 8 fits on 4 SMs of a GPC.
template <int NC, bool I8, int XN = 0>
struct Layout {
  static constexpr int kThreads = NC * 128 + (NC == 1 ? 32 : 128);  // + the producer
  static constexpr int kWOff = NC * kBoxBytes;                       // the weight in a stage
  static constexpr int kWBytes = I8 ? kBK * kTileN : 2 * kBoxBytes;
  static constexpr int kRawOff = kF32Rows * 2 * kBK;  // fp32 x's box (XN 2): x tile rows 16-47
  static constexpr int kParOff = kWOff + kWBytes;
  static constexpr int kStage = (kParOff + (XN ? 2 * 2 * kBK : 0) + 1023) / 1024 * 1024;
  static constexpr int kBf = I8 ? (NC == 1 ? 2 : 3) : 0;  // widened tiles (see the consumers)
  static constexpr int kStaging = NC == 2 ? NC * kWgRows * kTileN * 2 : 0;
  static constexpr int kStages =
      NC == 1 ? 4 : (kSmemBudget - kBf * 2 * kBoxBytes - kStaging) / kStage;
  static constexpr int kBfOff = kStages * kStage;
  static constexpr int kStagingOff = kBfOff + kBf * 2 * kBoxBytes;
  static constexpr int kPart = NC * kWgRows * kPartPitch * 4;  // a split's partial (clusters)
  static constexpr int kSmem =
      (kStagingOff + kStaging > kPart ? kStagingOff + kStaging : kPart) + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from src (16-byte aligned) into shared memory at dst, completing on
// bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The box at coordinates (c0 innermost, c1) of `map` into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor with 128-byte swizzle (byte offsets; encoded in 16s).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A [64 rows][16 k] (K-major) @ B [16 k][128 columns] (N-major: the transpose bit);
// scale_d 0 starts the sums from 0.
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The 16 k of step kk of a stage: warpgroup wg's 64 rows of x against the weight's 128 columns.
__device__ __forceinline__ void mma_step(float (&acc)[64], uint32_t x_tile, uint32_t w_tile,
                                         int kk, int scale_d) {
  wgmma128(acc, desc(x_tile + kk * 2 * kKStep, 16, 1024),
           desc(w_tile + kk * kKStep * 2 * kBoxN, kBoxBytes, 1024), scale_d);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// Named barrier 1 over the NC consumer warpgroups.
template <int NC>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC * 128) : "memory");
}

// Four int8 values (a 32-bit word, the first in the low byte) -> two bf16 pairs, exactly: each
// byte biased to u = q + 128 becomes the fp32 2^23 + u (one byte permute), less 2^23 + 128 is
// q, and an integer of at most 8 bits is its fp32's top 16 bits (a second permute).  No
// integer-to-float conversion, which runs at a sixteenth of the adds' rate.
__device__ __forceinline__ uint2 widen4(uint32_t q) {
  const uint32_t u = q ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | i)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// The int8 tile q [64 k][128] (unswizzled) -> the bf16 tile w: two boxes [64 k][64] with the
// 16-byte chunk c of row k at chunk c ^ (k % 8), as TMA's 128-byte swizzle lays them out.
template <int NC>
__device__ __forceinline__ void widen(const unsigned char* __restrict__ q,
                                      unsigned char* __restrict__ w) {
  constexpr int kPieces = kBK * kTileN / 16, kEach = kPieces / (NC * 128);  // 16 columns a piece
  uint4 v[kEach];
#pragma unroll
  for (int e = 0; e < kEach; ++e)
    v[e] = *reinterpret_cast<const uint4*>(q + (e * NC * 128 + threadIdx.x) * 16);
#pragma unroll
  for (int e = 0; e < kEach; ++e) {
    const int i = e * NC * 128 + threadIdx.x;
    const int k = i / (kTileN / 16), c16 = i % (kTileN / 16);
    const uint2 a = widen4(v[e].x), b = widen4(v[e].y), c = widen4(v[e].z), d = widen4(v[e].w);
    unsigned char* row = w + c16 / 4 * kBoxBytes + k * 2 * kBoxN;  // box c16 / 4
    const int chunk = c16 % 4 * 2;  // two 16-byte chunks of 8 columns
    *reinterpret_cast<uint4*>(row + ((chunk ^ (k & 7)) << 4)) = make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(row + (((chunk + 1) ^ (k & 7)) << 4)) =
        make_uint4(c.x, c.y, d.x, d.y);
  }
}

struct Args {
  const __nv_bfloat16* s;  // [N] (int8)
  __nv_bfloat16* out;      // [M, N]
  int M, K, N, rows_per_split;
  int clustered;           // 1: grid (n_split, column tiles, row tiles), a split a CTA
  int x_rows;              // rows of x's box: M rounded up to 8, at most 64 NC
  // a folded norm (XN != 0): x [M, K] (bf16 or fp32), its bf16 scale [K], bias [K] or null
  const void* x;
  const __nv_bfloat16* scale;
  const __nv_bfloat16* bias;
  float eps;
  int rms;
};

// The folded norm's statistics of rows m, m + step, ... (R of them; rows at or past `end`
// repeat row m and are not kept) into xs[row - m0].
template <int R, typename T>
__device__ __forceinline__ void rows_stats(const Args& a, int m0, int m, int step, int end,
                                           float2* xs) {
  const T* rows[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    rows[r] = static_cast<const T*>(a.x) +
              (size_t)(m0 + (m + r * step < end ? m + r * step : m)) * a.K;
  float2 st[R];
  // 4 steps of one row's loads in flight, or 2 of two or four rows' (more held the
  // registers a decode step's fold could not spare: 8 of one row took 0.15 ms a step more)
  row_stats::stats_rows<R, R == 1 ? 4 : 2>(rows, a.K, a.eps, a.rms != 0, st);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (m + r * step < end) xs[m + r * step] = st[r];
}

// The bf16 pair of output (m, n..n+1) from its fp32 total: rounded once; int8: times the
// column's scale, rounded again.
template <bool I8>
__device__ __forceinline__ __nv_bfloat162 out_pair(const Args& a, int n, float t0, float t1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(t0, t1);
  if constexpr (I8) {
    const __nv_bfloat162 sc = *reinterpret_cast<const __nv_bfloat162*>(a.s + n);
    v = __floats2bfloat162_rn(__low2float(v) * __low2float(sc), __high2float(v) * __high2float(sc));
  }
  return v;
}

// Tile t of a persistent CTA's walk -> its first row and column.  Tiles go in groups of
// kGroupRows row tiles, column by column inside a group, so that the CTAs running at once
// share the x rows and weight columns they read in the L2 cache.
__device__ __forceinline__ void tile_origin(int t, int row_tiles, int col_tiles, int rows,
                                            int& m0, int& n0) {
  const int per_group = kGroupRows * col_tiles, group = t / per_group;
  const int first = group * kGroupRows, in_group = min(kGroupRows, row_tiles - first);
  m0 = (first + t % per_group % in_group) * rows;
  n0 = t % per_group / in_group * kTileN;
}

// Clustered (small M): grid (n_split, ceil(N / 128), ceil(M / (64 NC))), clusters of n_split
// CTAs along x, one split a CTA.  Otherwise a persistent grid of at most one CTA an SM
// walking the tiles (tile_origin), each running its tile's splits in turn.  (NC + 1)
// warpgroups, the last the producer; dynamic shared memory Layout<NC, I8, XN>::kSmem.  tx: x
// [M][K] bf16, box {64, 64 NC}, 128-byte swizzle; tw: the weight [K][N], box {64, 64} bf16
// with 128-byte swizzle or {128, 64} int8 unswizzled; to: out [M][N] bf16, box {64, 64 NC},
// 128-byte swizzle (the persistent walk's stores).  XN: 0 plain x; 1 or 2 a folded norm over
// bf16 x (tx as above) or fp32 x (tx: box {64, x_rows} fp32, unswizzled).
template <int NC, bool I8, int XN>
__global__ void __launch_bounds__(Layout<NC, I8, XN>::kThreads, NC == 1 ? 2 : 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap to, const Args a) {
  using L = Layout<NC, I8, XN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[L::kStages], empty_bar[L::kStages];
  __shared__ float2 xstats[XN ? NC * kWgRows : 1];  // the folded norm's (mean, r) of a row
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles sit on 1024-byte boundaries
  unsigned char* const base_ptr = smem_raw + (base - raw);

  constexpr int kRows = NC * kWgRows;
  const bool clustered = a.clustered;
  const int row_tiles = (a.M + kRows - 1) / kRows, col_tiles = (a.N + kTileN - 1) / kTileN;
  const int t_first = clustered ? 0 : blockIdx.x, t_step = clustered ? 1 : gridDim.x;
  const int t_end = clustered ? 1 : row_tiles * col_tiles;
  const int k0 = clustered ? blockIdx.x * a.rows_per_split : 0;
  const int k1 = clustered ? min(a.K, k0 + a.rows_per_split) : a.K;
  auto origin = [&](int t, int& m0, int& n0) {
    if (clustered) {
      m0 = blockIdx.z * kRows;
      n0 = blockIdx.y * kTileN;
    } else {
      tile_origin(t, row_tiles, col_tiles, kRows, m0, n0);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(smem_addr(&full_bar[s]), 1);
      mbar_init(smem_addr(&empty_bar[s]), NC);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NC * 128) {  // the producer warpgroup: one thread issues every load
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NC * 128) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tw)) : "memory");
      int g = 0;  // stages issued, over every tile of the walk
      for (int t = t_first; t < t_end; t += t_step) {
        int m0, n0;
        origin(t, m0, n0);
        for (int k = k0; k < k1; k += kBK, ++g) {
          const int st = g % L::kStages;
          mbar_wait(smem_addr(&empty_bar[st]), ((g / L::kStages) & 1) ^ 1);
          const uint32_t full = smem_addr(&full_bar[st]), stage = base + st * L::kStage;
          // the weight's bytes, x's box (x_rows rows) and the norm's parameters for k (XN)
          const uint32_t par = XN ? min(kBK, a.K - k) * 2 : 0;
          mbar_expect_tx(full, L::kWBytes + a.x_rows * kBK * (XN == 2 ? 4 : 2) +
                                   (a.bias != nullptr ? 2 : 1) * par);
          tma_load(stage + (XN == 2 ? L::kRawOff : 0), &tx, full, k, m0);
          if constexpr (XN != 0) {
            bulk_load(stage + L::kParOff, a.scale + k, par, full);
            if (a.bias != nullptr) bulk_load(stage + L::kParOff + 2 * kBK, a.bias + k, par, full);
          }
          if constexpr (I8) {
            tma_load(stage + L::kWOff, &tw, full, n0, k);
          } else {
            tma_load(stage + L::kWOff, &tw, full, n0, k);
            tma_load(stage + L::kWOff + kBoxBytes, &tw, full, n0 + kBoxN, k);
          }
        }
      }
    }
    __syncwarp();
    if (clustered) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // the consumer warpgroups
  if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  // accumulator 4 j + 2 h + e: row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
  const int r = wg * kWgRows + warp * 16 + lane / 4, c = 2 * (lane % 4);
  float acc[64], total[64];
  // the folded norm: this thread's chunks of x's tile, items threadIdx.x + e NC 128 (row
  // item / 8, chunk item % 8: the same chunk, so the same scale and bias, for every e)
  constexpr int kXEach = XN ? kRows * kChunks / (NC * 128) : 1;
  const int xc = threadIdx.x % kChunks;
  int valid = 0;  // the tile's rows below M that x's box holds
  int g = 0;  // stages consumed, over every tile of the walk
  for (int t = t_first; t < t_end; t += t_step) {
    int m0, n0;
    origin(t, m0, n0);
    if constexpr (XN != 0) {
      // the tile's rows' statistics, a warp's rows (up to four) at a time, their loads in
      // flight together; every consumer has passed the previous tile's last stage barrier,
      // after which no one reads xstats
      using T = typename std::conditional<XN == 1, __nv_bfloat16, float>::type;
      valid = min(a.x_rows, a.M - m0);
      const int step = NC * 4, each = (valid + step - 1) / step;  // rows a warp computes
      for (int m = threadIdx.x / 32; m < valid; m += 4 * step) {
        if (each == 1)
          rows_stats<1, T>(a, m0, m, step, valid, xstats);
        else if (each == 2)
          rows_stats<2, T>(a, m0, m, step, valid, xstats);
        else
          rows_stats<4, T>(a, m0, m, step, valid, xstats);
      }
      consumers_sync<NC>();
    }
    // zeroed after the statistics, so that no accumulator is live while they run (their
    // registers are the statistics' own); a split's first wgmma ignores them (scale-d 0)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = total[i] = 0.f;
    int pending = -1;  // the stage whose wgmma group may still be running
    for (int k = k0; k < k1; k += kBK, ++g) {
      const int st = g % L::kStages;
      const uint32_t stage = base + st * L::kStage;
      mbar_wait(smem_addr(&full_bar[st]), (g / L::kStages) & 1);
      uint32_t w_tile = stage + L::kWOff;
      if constexpr (XN != 0) {
        // the stage's x tile: written by its TMA load (bf16) or by no one since the wgmmas of
        // stage g - kStages read it (the producer waited for their empty arrivals)
        unsigned char* const xt = base_ptr + st * L::kStage;
        if (k + xc * 8 < a.K) {
          float sc[8], b[8];
          row_stats::load8(reinterpret_cast<const __nv_bfloat16*>(xt + L::kParOff) + xc * 8, sc);
          if (a.bias != nullptr)
            row_stats::load8(
                reinterpret_cast<const __nv_bfloat16*>(xt + L::kParOff + 2 * kBK) + xc * 8, b);
#pragma unroll
          for (int e = 0; e < kXEach; ++e) {
            const int m = (threadIdx.x + e * NC * 128) / kChunks;
            if (m < valid) {
              uint4* const chunk =
                  reinterpret_cast<uint4*>(xt + m * 2 * kBK + ((xc ^ (m & 7)) << 4));
              float v[8];
              if constexpr (XN == 1)
                row_stats::load8(reinterpret_cast<const __nv_bfloat16*>(chunk), v);
              else
                row_stats::load8(reinterpret_cast<const float*>(xt + L::kRawOff + m * 4 * kBK) +
                                     xc * 8, v);
              row_stats::normalise8(v, xstats[m], sc, b, a.bias != nullptr);
              *chunk = row_stats::pack8(v);
            }
          }
        }
      }
      if constexpr (I8) {
        // widened tile g % kBf: its last readers, the wgmmas of stage g - kBf, are done (one
        // warpgroup: its own wait below at g - 1; two: both passed the barrier at g - 1, so
        // each has waited at g - 2 for the groups up to g - 3)
        const int bf = L::kBfOff + g % L::kBf * 2 * kBoxBytes;
        widen<NC>(base_ptr + st * L::kStage + L::kWOff, base_ptr + bf);
        w_tile = base + bf;
      }
      if constexpr (I8 || XN != 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by the wgmmas
        consumers_sync<NC>();
      }
      const uint32_t x_tile = stage + wg * kBoxBytes;
      const int first = k % a.rows_per_split == 0 ? 0 : 1;  // 0: a split starts here
      wgmma_fence();
      if (k1 - k >= kBK) {
#pragma unroll
        for (int kk = 0; kk < kBK / kKStep; ++kk)
          mma_step(acc, x_tile, w_tile, kk, kk ? 1 : first);
      } else {  // the contraction's ragged end
        for (int kk = 0; kk < (k1 - k + kKStep - 1) / kKStep; ++kk)
          mma_step(acc, x_tile, w_tile, kk, kk ? 1 : first);
      }
      wgmma_commit();
      // bf16: the group before this one has read its stage.  int8: this one has (the widening
      // already holds a stage while the ring refills; freeing it at once keeps one more in
      // flight)
      wgmma_wait<I8 ? 0 : 1>();
      if (pending >= 0 && threadIdx.x % 128 == 0) mbar_arrive(smem_addr(&empty_bar[pending]));
      pending = st;
      if constexpr (I8) {
        if (threadIdx.x % 128 == 0) mbar_arrive(smem_addr(&empty_bar[pending]));
        pending = -1;
      }
      if (k + kBK >= k1 || (k + kBK) % a.rows_per_split == 0) {  // the split's last stage
        wgmma_wait<0>();
        if (pending >= 0 && threadIdx.x % 128 == 0) mbar_arrive(smem_addr(&empty_bar[pending]));
        pending = -1;
#pragma unroll
        for (int i = 0; i < 64; ++i) total[i] += acc[i];
      }
    }
    if (clustered) break;

    if constexpr (NC == 1) {  // a few rows: straight from the accumulators
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + r + 8 * h, n = n0 + 8 * j + c;
          if (m < a.M && n < a.N)
            *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)m * a.N + n) =
                out_pair<I8>(a, n, total[4 * j + 2 * h], total[4 * j + 2 * h + 1]);
        }
      continue;
    }
    // the tile through the staging buffer (two swizzled boxes of 64 columns) and two TMA
    // stores, which skip what lies past M and N; the previous tile's stores have read it
    unsigned char* const stg = base_ptr + L::kStagingOff;
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    consumers_sync<NC>();
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h, chunk = j % 8;
        *reinterpret_cast<__nv_bfloat162*>(stg + j / 8 * kRows * 128 + row * 128 +
                                           ((chunk ^ (row & 7)) << 4) + 2 * c) =
            out_pair<I8>(a, min(n0 + 8 * j + c, a.N - 2), total[4 * j + 2 * h],
                         total[4 * j + 2 * h + 1]);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by the stores
    consumers_sync<NC>();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int b = 0; b < kTileN / kBoxN; ++b)
        asm volatile(
            "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                reinterpret_cast<uint64_t>(&to)),
            "r"(smem_addr(stg + b * kRows * 128)), "r"(n0 + b * kBoxN), "r"(m0)
            : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (!clustered) {
    if (NC == 2 && threadIdx.x == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    return;
  }

  // this split's partial into shared memory (the ring is done with once every consumer's
  // last group has completed), then a share of the tile's outputs summed over the cluster's
  // partials in split order from 0
  int m0, n0;
  origin(0, m0, n0);
  consumers_sync<NC>();
  float* part = reinterpret_cast<float*>(base_ptr);
  const int rows = min(kRows, a.M - m0);  // the tile's rows below M: the only ones read
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < rows)
        *reinterpret_cast<float2*>(part + (r + 8 * h) * kPartPitch + 8 * j + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  cluster_sync();
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int n_split = gridDim.x;
  const int quads = rows * (kTileN / 4);  // 4 columns a thread step: one 16-byte load a rank
  const int share = (quads + n_split - 1) / n_split;
  const int hi = min(quads, (int)(rank + 1) * share);
  for (int p = rank * share + threadIdx.x; p < hi; p += NC * 128) {
    const int pr = p / (kTileN / 4), pc = 4 * (p % (kTileN / 4));
    const uint32_t local = smem_addr(part + pr * kPartPitch + pc);
    float4 v[kMaxSplits];  // every rank's partial loaded first, then added in split order
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < n_split) {
        uint32_t remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(s));
        asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                     : "=f"(v[s].x), "=f"(v[s].y), "=f"(v[s].z), "=f"(v[s].w)
                     : "r"(remote)
                     : "memory");
      }
    }
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < n_split) {
        t.x += v[s].x;
        t.y += v[s].y;
        t.z += v[s].z;
        t.w += v[s].w;
      }
    }
    if (n0 + pc < a.N) {  // N is a multiple of 16: a quad lies wholly inside or past it
      __nv_bfloat162* o =
          reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)(m0 + pr) * a.N + n0 + pc);
      o[0] = out_pair<I8>(a, n0 + pc, t.x, t.y);
      o[1] = out_pair<I8>(a, n0 + pc + 2, t.z, t.w);
    }
  }
  cluster_sync();  // no CTA leaves while another reads its partial
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime (no link against libcuda), once.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D map over rows of `inner` elements (row pitch row_bytes), `outer` rows, boxes of
// box_inner x box_outer, out-of-bounds elements read as zero.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* p, uint64_t inner,
            uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer}, strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer}, steps[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(p), dims, strides, box, steps,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lets the kernel take its ring above the 48 KB default; set once per instantiation (a
// function-local static is initialised once), by zt_gemm_prepare when the library is loaded,
// so never during a CUDA graph's capture.
template <int NC, bool I8, int XN>
cudaError_t allow() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(gemm_kernel<NC, I8, XN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Layout<NC, I8, XN>::kSmem);
  return attr;
}

template <int NC, bool I8, int XN>
int launch(const void* x, const void* w, const Args& a, int n_split, cudaStream_t stream) {
  const cudaError_t attr = allow<NC, I8, XN>();
  if (attr != cudaSuccess) return attr;
  CUtensorMap tx, tw, to;
  const bool maps =
      (XN == 2 ? encode(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, a.K, a.M, (uint64_t)a.K * 4, kBK,
                        a.x_rows, CU_TENSOR_MAP_SWIZZLE_NONE)
               : encode(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, a.K, a.M, (uint64_t)a.K * 2,
                        kBK, a.x_rows, CU_TENSOR_MAP_SWIZZLE_128B)) &&
      encode(&to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.out, a.N, a.M, (uint64_t)a.N * 2, kBoxN,
             NC * kWgRows, CU_TENSOR_MAP_SWIZZLE_128B) &&
      (I8 ? encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, a.N, a.K, (uint64_t)a.N, kTileN, kBK,
                   CU_TENSOR_MAP_SWIZZLE_NONE)
          : encode(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, a.N, a.K, (uint64_t)a.N * 2, kBoxN,
                   kBK, CU_TENSOR_MAP_SWIZZLE_128B));
  if (!maps) return cudaErrorInvalidValue;
  const int col_tiles = (a.N + kTileN - 1) / kTileN;
  const int row_tiles = (a.M + NC * kWgRows - 1) / (NC * kWgRows);
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int cluster = a.clustered ? n_split : 1;
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = cluster;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  // the persistent walk: as many CTAs as the SMs hold at once, at most one a tile
  cfg.gridDim = a.clustered ? dim3(n_split, col_tiles, row_tiles)
                            : dim3(min(sms * (NC == 1 ? 2 : 1), col_tiles * row_tiles), 1, 1);
  cfg.blockDim = dim3(Layout<NC, I8, XN>::kThreads);
  cfg.dynamicSmemBytes = Layout<NC, I8, XN>::kSmem;
  cfg.stream = stream;
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gemm_kernel<NC, I8, XN>, tx, tw, to, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int XN>
int dispatch(const void* x, const void* w, const Args& a, int int8, int n_split, int bm,
             cudaStream_t st) {
  if (bm == 64)
    return int8 ? launch<1, true, XN>(x, w, a, n_split, st)
                : launch<1, false, XN>(x, w, a, n_split, st);
  return int8 ? launch<2, true, XN>(x, w, a, n_split, st)
              : launch<2, false, XN>(x, w, a, n_split, st);
}

bool plan_ok(int M, int K, int N, int n_split, int rows_per_split, int bm) {
  return M >= 1 && K >= kKStep && K % kKStep == 0 && N >= 16 && N % 16 == 0 && n_split >= 1 &&
         n_split <= kMaxSplits && rows_per_split >= kBK && rows_per_split % kBK == 0 &&
         (n_split - 1) * rows_per_split < K && n_split * rows_per_split >= K &&
         (bm == 64 || bm == 128);
}

}  // namespace

// x [M, K] bf16; w [K, N] bf16 (int8 = 0) or int8 (int8 = 1) with s [N] bf16; out [M, N]
// bf16.  All contiguous and 16-byte aligned; K % 16 == 0, N % 16 == 0.  The contraction is cut
// into n_split splits (at most 8) of rows_per_split rows (a multiple of 64; none empty).
// parallel = 1: each split a CTA of a cluster of n_split; parallel = 0: one CTA runs a tile's
// splits in turn.  bm: the rows of a CTA, 64 (one consumer warpgroup) or 128 (two).
extern "C" int zt_gemm(const void* x, const void* w, const void* s, void* out, int M, int K,
                       int N, int int8, int n_split, int rows_per_split, int parallel, int bm,
                       void* stream) {
  if (!plan_ok(M, K, N, n_split, rows_per_split, bm) || !aligned(x) || !aligned(w) ||
      !aligned(out) || (int8 && (s == nullptr || !aligned(s))))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(out), M, K, N,
               rows_per_split, parallel && n_split > 1, min(bm, (M + 7) / 8 * 8)};
  return dispatch<0>(x, w, a, int8, n_split, bm, static_cast<cudaStream_t>(stream));
}

// The same product of norm(x) rounded to bf16: x [M, K] bf16 (x_f32 = 0) or fp32 (1; M <= 16),
// scale [K] bf16, bias [K] bf16 or null (allowed with rms only), eps; rms: 1 RMSNorm, 0
// LayerNorm.  scale and bias 16-byte aligned; the rest as zt_gemm.
extern "C" int zt_gemm_norm(const void* x, const void* scale, const void* bias, const void* w,
                            const void* s, void* out, int M, int K, int N, int x_f32, float eps,
                            int rms, int int8, int n_split, int rows_per_split, int parallel,
                            int bm, void* stream) {
  if (!plan_ok(M, K, N, n_split, rows_per_split, bm) || (x_f32 && M > kF32Rows) || !aligned(x) ||
      !aligned(w) || !aligned(out) || !aligned(scale) || scale == nullptr || !aligned(bias) ||
      (!rms && bias == nullptr) || (int8 && (s == nullptr || !aligned(s))))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(s),
               static_cast<__nv_bfloat16*>(out),
               M, K, N, rows_per_split, parallel && n_split > 1, min(bm, (M + 7) / 8 * 8), x,
               static_cast<const __nv_bfloat16*>(scale),
               static_cast<const __nv_bfloat16*>(bias), eps, rms};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_f32 ? dispatch<2>(x, w, a, int8, n_split, bm, st)
               : dispatch<1>(x, w, a, int8, n_split, bm, st);
}

// Every instantiation's attributes and the tensor-map encoder, before any capture; the first
// error, if any.
extern "C" int zt_gemm_prepare() {
  const cudaError_t errs[] = {
      allow<1, false, 0>(), allow<1, true, 0>(), allow<2, false, 0>(), allow<2, true, 0>(),
      allow<1, false, 1>(), allow<1, true, 1>(), allow<2, false, 1>(), allow<2, true, 1>(),
      allow<1, false, 2>(), allow<1, true, 2>(), allow<2, false, 2>(), allow<2, true, 2>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return encoder() != nullptr ? cudaSuccess : cudaErrorNotSupported;
}
