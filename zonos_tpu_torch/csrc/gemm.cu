// G1: y [M, N] = x [M, K] @ w [K, N] with bf16 x and a bf16 or int8 weight, on Hopper's tensor
// cores (sm_90a), in a summation order that the weight's shape fixes and the row count does
// not.
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
//   - inside a split, one fp32 accumulator per output runs the split's k-steps of 16 in
//     increasing k, one mma.sync.m16n8k16 each, starting from 0;
//   - the splits' sums are added in split order into an fp32 total that starts at 0;
//   - the total is rounded to bf16 once (int8: then multiplied by the column's bf16 scale and
//     rounded again, as the JAX package and the plain version compute (x @ q) * s).
//
// Rows never share an accumulator, and nothing of the order depends on M or on where a row
// lies among the rows: a row's result is the same bits alone and in any batch.  How the work
// is laid out on the card (the row tile, whether the splits run in parallel CTAs or one after
// another in one CTA) is chosen by M for speed and changes no bit.
//
// What bounds it on an H100: at the decode steps' few rows every weight element feeds 2 M
// flops, far below the card's ridge (~295 flop/byte in bf16), so the floor is reading the
// weight once (2 K N bytes, or K N for int8): ~10 us for the flagship's w2 [8192, 2048].  At
// a batch-64 prefill (M = 9088) the products are bound by the tensor cores (2 M K N flops at
// 989 TFLOP/s, ~0.31 ms for w2).
//
// Design.
// - Operands: x as A (16 rows x 16 k a fragment, ldmatrix from a [rows][k] stage), the weight
//   as B (16 k x 8 columns, ldmatrix.trans from a [k][columns] stage: the weight's rows are k,
//   so the transposing load gives each lane its (k, k + 1) pairs).  int8 weights are read
//   from their stage a byte at a time and widened to bf16 exactly (|q| <= 127).
// - Tiles: a CTA owns 128 columns and BM rows: BM = 16 (8 warps side by side, 16 columns
//   each) for M <= 16, else 64 (2 x 4 warps of 32 x 32).  Stages of 64 k rows stream x and
//   the weight through a 4-slot cp.async ring (16-byte copies, zero-filled past M, N and the
//   split's end), three slots ahead of the MMAs; row pitches of 144 and 272 bytes make the
//   ldmatrix reads conflict-free.
// - The splits: with few tiles (small M) each split is a CTA of its own (grid.y), writes its
//   fp32 sums to a partial plane, and the last CTA of a tile to finish (an atomic counter,
//   zeroed on the stream before the launch) adds the planes in split order; with enough
//   tiles to fill the card one CTA runs every split of its tile in turn, adding each split's
//   accumulators into its total in registers.  Both add the same numbers in the same order.
// - Left for later: wgmma with TMA loads and a warp-specialised producer, a cluster
//   reduction through distributed shared memory in place of the partial planes.
//
// C interface (ctypes): returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 128;   // columns of a CTA
constexpr int kBK = 64;       // k rows of a stage
constexpr int kKStep = 16;    // k of one mma
constexpr int kStages = 4;    // slots of the ring
constexpr int kXPitch = (kBK + 8) * 2;         // bytes of a staged row of x (144)
constexpr int kWPitch16 = (kTileN + 8) * 2;    // bytes of a staged bf16 weight row (272)
constexpr int kWPitch8 = kTileN + 16;          // bytes of a staged int8 weight row (144)

// Warp layouts: WM x WN warps, each MT m-tiles (16 rows) by NT n-tiles (8 columns).
template <int BM>
struct Layout;
template <>
struct Layout<16> {
  static constexpr int WM = 1, WN = 8, MT = 1, NT = 2;
};
template <>
struct Layout<64> {
  static constexpr int WM = 2, WN = 4, MT = 2, NT = 4;
};

__host__ __device__ constexpr int w_pitch(bool i8) { return i8 ? kWPitch8 : kWPitch16; }
__host__ __device__ constexpr int stage_bytes(int bm, bool i8) {
  return bm * kXPitch + kBK * w_pitch(i8);
}
__host__ __device__ constexpr int smem_bytes(int bm, bool i8) {
  return kStages * stage_bytes(bm, i8);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `bytes` 16 or 0 (0: zero-fill, nothing read).
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two int8 weights -> a bf16 pair (low half the first), exactly.
__device__ __forceinline__ unsigned int8_pair(int8_t lo, int8_t hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<const unsigned*>(&v);
}

struct Args {
  const __nv_bfloat16* x;  // [M, K]
  const void* w;           // [K, N] bf16 or int8
  const __nv_bfloat16* s;  // [N] (int8)
  __nv_bfloat16* out;      // [M, N]
  float* part;             // [n_split, M, N] (splits in parallel CTAs)
  unsigned* counters;      // one per (row tile, column tile), zero on entry
  int M, K, N, n_split, rows_per_split;
};

// Issues the copies of the stage of k rows [k, k + kBK) (those below k_end) into `slot`.
template <int BM, bool I8>
__device__ __forceinline__ void load_stage(const Args& a, unsigned char* slot, int m0, int n0,
                                           int k, int k_end) {
  const unsigned xs = smem_addr(slot), ws = smem_addr(slot + BM * kXPitch);
  // x: BM rows x 8 chunks of 8 values
  for (int i = threadIdx.x; i < BM * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    const bool ok = m0 + r < a.M && k + c < k_end;
    const __nv_bfloat16* src = ok ? a.x + (size_t)(m0 + r) * a.K + k + c : a.x;
    cp_async16(xs + r * kXPitch + c * 2, src, ok ? 16 : 0);
  }
  // the weight: kBK rows x 128 columns, 16 bytes a copy
  constexpr int kEsz = I8 ? 1 : 2;
  constexpr int kPerRow = kTileN * kEsz / 16;
  const unsigned char* w = static_cast<const unsigned char*>(a.w);
  for (int i = threadIdx.x; i < kBK * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * (16 / kEsz);
    const bool ok = k + r < k_end && n0 + c < a.N;
    const unsigned char* src = ok ? w + ((size_t)(k + r) * a.N + n0 + c) * kEsz : w;
    cp_async16(ws + r * w_pitch(I8) + c * kEsz, src, ok ? 16 : 0);
  }
}

// The MMAs of one stage: `ksteps` k-steps of 16 (all below the split's end).
template <int BM, bool I8>
__device__ __forceinline__ void mma_stage(const unsigned char* slot, int ksteps,
                                          float (&acc)[Layout<BM>::MT][Layout<BM>::NT][4]) {
  using L = Layout<BM>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int wm = warp / L::WN, wn = warp % L::WN;
  const int row0 = wm * L::MT * 16, col0 = wn * L::NT * 8;
  const unsigned xs = smem_addr(slot);
  const unsigned char* wsp = slot + BM * kXPitch;
  const unsigned ws = smem_addr(wsp);
  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8
  const unsigned xa = xs + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kXPitch + (lane >> 4) * 16;
  const unsigned wa = ws + ((lane & 7) + ((lane >> 3) & 1) * 8) * kWPitch16 + (col0 + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int ks = 0; ks < kBK / kKStep; ++ks) {
    if (ks >= ksteps) break;  // CTA-uniform
    unsigned af[L::MT][4];
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt) ldmatrix_x4(xa + mt * 16 * kXPitch + ks * kKStep * 2, af[mt]);
    unsigned bf[L::NT][2];
    if constexpr (I8) {
      // lane (gid, tig): column col0 + 8 nt + gid at k 2 tig, 2 tig + 1 (b0) and + 8 (b1)
      const int8_t* wr = reinterpret_cast<const int8_t*>(wsp) + (ks * kKStep + 2 * tig) * kWPitch8 +
                         col0 + gid;
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) {
        const int8_t* p = wr + nt * 8;
        bf[nt][0] = int8_pair(p[0], p[kWPitch8]);
        bf[nt][1] = int8_pair(p[8 * kWPitch8], p[9 * kWPitch8]);
      }
    } else {
#pragma unroll
      for (int np = 0; np < L::NT / 2; ++np) {
        unsigned r[4];  // b0, b1 of n-tile 2 np, then of 2 np + 1
        ldmatrix_x4_trans(wa + ks * kKStep * kWPitch16 + np * 16 * 2, r);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
  }
}

// acc = the sums of k rows [k0, k1) in increasing k, from 0, through the ring.
template <int BM, bool I8>
__device__ __forceinline__ void run_split(const Args& a, unsigned char* smem, int m0, int n0,
                                          int k0, int k1,
                                          float (&acc)[Layout<BM>::MT][Layout<BM>::NT][4]) {
  using L = Layout<BM>;
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  constexpr int SB = stage_bytes(BM, I8);
  const int n_st = (k1 - k0 + kBK - 1) / kBK;
  __syncthreads();  // the ring is free (a previous split's last stage is computed)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st) load_stage<BM, I8>(a, smem + s * SB, m0, n0, k0 + s * kBK, k1);
    cp_commit();
  }
  for (int it = 0; it < n_st; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed for every thread; slot (it - 1) is free
    const int nx = it + kStages - 1;
    if (nx < n_st) load_stage<BM, I8>(a, smem + (nx % kStages) * SB, m0, n0, k0 + nx * kBK, k1);
    cp_commit();
    const int k = k0 + it * kBK;
    const int ksteps = (min(kBK, k1 - k) + kKStep - 1) / kKStep;
    mma_stage<BM, I8>(smem + (it % kStages) * SB, ksteps, acc);
  }
  cp_wait<0>();
}

// Output (m, n..n+1) from its total: rounded to bf16; int8: times the column's scale in bf16.
template <bool I8>
__device__ __forceinline__ void store_pair(const Args& a, int m, int n, float t0, float t1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(t0, t1);
  if constexpr (I8) {
    const __nv_bfloat162 sc = *reinterpret_cast<const __nv_bfloat162*>(a.s + n);
    v = __floats2bfloat162_rn(__low2float(v) * __low2float(sc), __high2float(v) * __high2float(sc));
  }
  *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)m * a.N + n) = v;
}

// grid (ceil(N / 128), splits in parallel ? n_split : 1, ceil(M / BM)); dynamic shared memory
// smem_bytes(BM, I8).
template <int BM, bool I8>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Args a) {
  using L = Layout<BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool is_last;
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.z * BM;
  const bool parallel = gridDim.y > 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int wm = warp / L::WN, wn = warp % L::WN;
  float acc[L::MT][L::NT][4];
  float total[L::MT][L::NT][4];
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[mt][nt][e] = 0.f;

  // accumulator e of (mt, nt): row gid (+8 for e >= 2), column 2 tig (+1 for odd e)
  const int rbase = m0 + wm * L::MT * 16 + gid, cbase = n0 + wn * L::NT * 8 + 2 * tig;
  if (parallel) {
    const int split = blockIdx.y;
    const int k0 = split * a.rows_per_split, k1 = min(a.K, k0 + a.rows_per_split);
    run_split<BM, I8>(a, smem, m0, n0, k0, k1, acc);
    float* part = a.part + (size_t)split * a.M * a.N;
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = rbase + mt * 16 + 8 * h, n = cbase + nt * 8;
          if (m < a.M && n < a.N)
            *reinterpret_cast<float2*>(part + (size_t)m * a.N + n) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned* counter = a.counters + (size_t)blockIdx.z * gridDim.x + blockIdx.x;
      is_last = atomicAdd(counter, 1u) == (unsigned)a.n_split - 1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // the tile's last CTA: each output pair's splits added in split order from 0
    const size_t plane = (size_t)a.M * a.N;
    for (int i = threadIdx.x; i < BM * (kTileN / 2); i += kThreads) {
      const int m = m0 + i / (kTileN / 2), n = n0 + (i % (kTileN / 2)) * 2;
      if (m >= a.M || n >= a.N) continue;
      const float* p = a.part + (size_t)m * a.N + n;
      float t0 = 0.f, t1 = 0.f;
      for (int s = 0; s < a.n_split; ++s) {
        const float2 v = __ldcg(reinterpret_cast<const float2*>(p + s * plane));
        t0 += v.x;
        t1 += v.y;
      }
      store_pair<I8>(a, m, n, t0, t1);
    }
    return;
  }
  for (int split = 0; split < a.n_split; ++split) {
    const int k0 = split * a.rows_per_split, k1 = min(a.K, k0 + a.rows_per_split);
    run_split<BM, I8>(a, smem, m0, n0, k0, k1, acc);
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[mt][nt][e] += acc[mt][nt][e];
  }
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = rbase + mt * 16 + 8 * h, n = cbase + nt * 8;
        if (m < a.M && n < a.N) store_pair<I8>(a, m, n, total[mt][nt][2 * h], total[mt][nt][2 * h + 1]);
      }
}

// Lets the kernel take its ring above the 48 KB default; set once per instantiation (a
// function-local static is initialised once), by zt_gemm_prepare when the library is loaded,
// so never during a CUDA graph's capture.
template <int BM, bool I8>
cudaError_t allow() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<BM, I8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(BM, I8));
  return attr;
}

template <int BM, bool I8>
int launch(const Args& a, bool parallel, cudaStream_t stream) {
  constexpr int smem = smem_bytes(BM, I8);
  const cudaError_t attr = allow<BM, I8>();
  if (attr != cudaSuccess) return attr;
  const int col_tiles = (a.N + kTileN - 1) / kTileN, row_tiles = (a.M + BM - 1) / BM;
  if (parallel) {
    const cudaError_t err =
        cudaMemsetAsync(a.counters, 0, (size_t)col_tiles * row_tiles * sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(col_tiles, parallel ? a.n_split : 1, row_tiles);
  gemm_kernel<BM, I8><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x [M, K] bf16; w [K, N] bf16 (int8 = 0) or int8 (int8 = 1) with s [N] bf16; out [M, N]
// bf16.  All contiguous and 16-byte aligned; K % 16 == 0, N % 16 == 0.  The contraction is cut
// into n_split splits of rows_per_split rows (a multiple of 64; none empty).  parallel = 1:
// each split a CTA of its own, with part [n_split, M, N] fp32 scratch and counters (one per
// (row tile, column tile), zeroed here on the stream); parallel = 0: one CTA runs a tile's
// splits in turn (part and counters unused).  bm: the row tile, 16 or 64.
extern "C" int zt_gemm(const void* x, const void* w, const void* s, void* out, void* part,
                       void* counters, int M, int K, int N, int int8, int n_split,
                       int rows_per_split, int parallel, int bm, void* stream) {
  if (M < 1 || K < kKStep || K % kKStep || N < 16 || N % 16 || n_split < 1 ||
      rows_per_split < kBK || rows_per_split % kBK || (n_split - 1) * rows_per_split >= K ||
      n_split * rows_per_split < K || (bm != 16 && bm != 64) || !aligned(x) || !aligned(w) ||
      !aligned(out) || (int8 && s == nullptr) || (parallel && n_split > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(x), w, static_cast<const __nv_bfloat16*>(s),
               static_cast<__nv_bfloat16*>(out), static_cast<float*>(part),
               static_cast<unsigned*>(counters), M, K, N, n_split, rows_per_split};
  const bool par = parallel && n_split > 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 16) return int8 ? launch<16, true>(a, par, st) : launch<16, false>(a, par, st);
  return int8 ? launch<64, true>(a, par, st) : launch<64, false>(a, par, st);
}

// Every instantiation's attributes, before any capture; the first error, if any.
extern "C" int zt_gemm_prepare() {
  const cudaError_t errs[] = {allow<16, false>(), allow<16, true>(), allow<64, false>(),
                              allow<64, true>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}
