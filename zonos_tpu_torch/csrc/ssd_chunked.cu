// K6: Mamba2 chunked-SSD prefill, fp32, for Hopper (sm_90a).
//
// For one batch row b and head h (group g = h / (H / G)), over chunks of Q = 64 steps:
//   s_i   = sum_{k <= i} dt_k * A                       (cumulative log-decay in the chunk)
//   y_i   = sum_{j <= i} (C_i . B_j) exp(s_i - s_j) dt_j x_j     (intra-chunk)
//         + exp(s_i) C_i . h                                   (inter-chunk, h = state before)
//         + D x_i                                              (skip)
//   h'    = h exp(s_last) + sum_j exp(s_last - s_j) dt_j x_j B_j^T   (state carry)
// x [B, L, H, P], dt [B, L, H], A [H], B/C [B, L, G, N], D [H], init [B, H, P, N] (may be
// null: zeros) -> y [B, L, H, P], final state [B, H, P, N]; all fp32, contiguous.  The tail
// of a sequence that is not a multiple of Q is handled as zero rows (dt = 0), exactly like
// the zero padding of the XLA formulation.
//
// Replaces the Pallas TPU kernel zonos_tpu/ops/pallas_ssm.py ssd_chunked_pallas (:167; body
// _ssd_kernel :56), and its XLA twin zonos_tpu/ops/ssm.py ssd_chunked (:74-135).  The TPU
// kernel walks a sequential (batch, chunk) grid and carries the [H, P, N] state in VMEM
// scratch, batching heads into block-diagonal dots to fill the 128-wide MXU; it computes
// C.B^T once a chunk for all heads of the group.
//
// What bounds it on an H100: the function needs at least the recurrent form's work, 4 flops
// per state element per step, 4*L*P*N per (row, head); the bytes are one read of x/dt/B/C
// and the init state and one write of y and the final state.  Its four products run on the
// tensor cores in 3xTF32 (below), three TF32 products for each fp32 one, so the operations
// bound is taken at a third of the TF32 rate (495 / 3 TFLOP/s): at P = 64, N = 128 the bytes
// (the [P, N] states) bound a prefill of up to ~300 steps, the operations beyond.
//
// Design, against what held the first form (one 256-thread CTA a (row, head), 136 KB of
// shared memory, four fp32 FMA loops, five phases in order):
// 1. Tensor cores at fp32 accuracy.  The four products, C.B^T, W.x, C.h and
//    (dt decay x)^T.B, are mma.sync m16n8k8 TF32 with fp32 accumulators, each operand split
//    a = a_hi + a_lo (a_hi = a with its low 13 mantissa bits cleared, a_lo = a - a_hi) and
//    the product taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi: about 2^-20 of relative error per
//    product against 2^-10 for one TF32 pass, which misses the 1e-4 x max|ref| tolerance at
//    the flagship widths by 8-17x (tests/test_torch_port_ssd.py models both).  The split is
//    a mask and a subtraction: cvt.rna.tf32.f32 runs at a fraction of the fp32 rate, and the
//    splits, done as fragments are loaded, are most of the instructions.  The decay
//    exp(s_i - s_j) dt_j is applied to the C.B^T accumulator in fp32, and W is split again.
//    Every product takes P as its row (M) dimension: y is formed transposed, y^T = x^T W^T
//    + h C^T, and the state [P, N] lives in the accumulators of its own product.  The state
//    then serves as the A operand of h C^T straight from registers: the accumulator holds
//    columns 2t and 2t+1 of each 8-column tile where an A fragment wants t and t + 4, so the
//    k order of that product (and of C.B^T, for 8-byte loads) is permuted to match.
// 2. No repeated or zero work.  C.B^T depends on (row, chunk, group) only.  The CTAs of
//    heads of one group form a thread-block cluster of `c` CTAs (kernels/ssd.py ssd_plan;
//    2 by default: a cluster of 4 CTAs of 206 KB fits 30 at once on the card, so 128 CTAs
//    would take two waves); rank r computes C.B^T's columns [r 64/c, (r+1) 64/c) and every
//    CTA reads the others' through distributed shared memory after one cluster barrier (the
//    idiom of csrc/decode_attention.cu), the slices double-buffered by chunk so no second
//    barrier is needed.  A cluster, not a pass through L2: a second launch would add its
//    latency to a one-chunk prefill.  Causal blocks of W.x (j > i) are skipped, and so are
//    the i-tiles and k-steps past the last valid row.
//    Without an init state, chunk 0's C.h is skipped and the state starts as zeros in
//    registers (adding exact zeros changes no bit).
// 3. Filling the SM and overlapping.  16 warps a CTA by default: warp (mt, g) owns the
//    state's rows [16 mt, 16 mt + 16) and its g-th range of N / (8 G_w) column tiles (G_w
//    column groups), computes C.h's partial over those columns for all 64 rows of y, and the
//    y tiles it = g (mod G_w); the partials meet in shared memory in a fixed order.  One CTA
//    a (row, head): splitting P over two or four CTAs was 1.5-3.1x slower (a split CTA still
//    holds whole B and C stages, so it still takes an SM).  The plan depends on the widths
//    alone, never on the batch, so a row's outputs are the same bit for bit alone and in any
//    batch.  Chunk c + 1's x, B and C are copied by cp.async into the second of two stages
//    while chunk c computes, in three parts issued at three points of chunk c so that no
//    thread waits long on the copy queue (one TMA bulk copy a row was tried: the TMA unit
//    took much of a chunk for a chunk's 192 row copies, and the issuing warp held up its
//    CTA).  The cumulative decay is one warp's shuffle scan, on dt that warp loaded during
//    the chunk before, while every warp, that one included, computes its C.B^T tiles.  W is
//    formed a column a thread, its loads of C.B^T (remote ones included) issued together.
//    The state stays in registers across chunks and goes to device memory once.
// 4. The shared-memory attribute is set when the library loads (zt_ssd_chunked_prepare),
//    never during a call or a capture.
// 5. Shared memory (floats): two stages of x [64][16 mt + 8] and B, C [64][N16 + 8] (N16 = N
//    rounded up to 16; the C.h partials reuse the B/C region once both are read); W
//    [64][68]; the C.B^T slices [64][64/c (+8)], twice when c > 1; s, exp(s), the state
//    weights and dt [4][64].  The strides make every fragment load conflict-free.  At the
//    flagship widths (P 64, N 128, c 2, 16 warps) 215,040 bytes: one CTA an SM.
// What bounds it now (one NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --times, PERF.md 6):
// 16.0 us at x [2,55,64,64] against a 2.37 us byte bound, 228 us at [2,1024] against 26.0
// at 3xTF32's rate, 183 us at [16,69] (the first form: 24.8, 390, 353).  Neither bytes nor
// the tensor cores bound it: each phase is a chain of shared loads, splits and dependent
// mma.sync with 16 warps an SM, and a chunk's fixed costs (C.B^T, W, the scan, the
// barriers, the copy issue, the partials' exchange) are about half its time at L 1024.
//
// C interface (ctypes): every entry returns a cudaError_t (after the launch for launches).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kQ = 64;                // chunk length
constexpr int kSW = kQ + 4;           // row stride of W
constexpr int kMaxP = 64, kMaxN = 128;
constexpr int kMaxWarps = 16;
constexpr int kMaxCluster = 8;        // the portable limit
constexpr int kMaxSmem = 232448;      // 227 KB, a block's most on Hopper
constexpr float kLog2e = 1.44269504088896341f;

// Shared-memory layout, in floats (mirrored for the CPU tests in tests/_k6_plans.py).
struct Layout {
  int sx, sb, wdt, scb;  // strides of x, B/C and the C.B^T slice; the slice's width
  int bc;                // floats of the B/C region (B at 0, C at 64 sb; later the partials)
  int stage;             // floats a stage: x, then the B/C region
  int w, cb, cbs, sarr;  // offsets of W, the slices and s / exp(s) / wd / dt; floats a slice
  int floats;
};

__host__ __device__ inline Layout layout(int mt, int npad, int c, int warps) {
  Layout l;
  l.sx = 16 * mt + 8;
  l.sb = npad + 8;
  l.wdt = kQ / c;
  l.scb = l.wdt % 16 == 0 ? l.wdt + 8 : l.wdt;
  l.bc = 2 * kQ * l.sb > warps * 8 * 128 ? 2 * kQ * l.sb : warps * 8 * 128;
  l.stage = kQ * l.sx + l.bc;
  l.w = 2 * l.stage;
  l.cbs = kQ * l.scb;
  l.cb = l.w + kQ * kSW;
  l.sarr = l.cb + (c > 1 ? 2 : 1) * l.cbs;
  l.floats = l.sarr + 4 * kQ;
  return l;
}

struct Args {
  const float *x, *dt, *A, *Bm, *Cm, *D, *init;
  float *y, *fstate;
  int L, H, G, P, N;
  int mt, npad, c;  // 16-row tiles of P, N rounded up to 16, the plan's cluster
};

// v = hi + lo: hi is v with its low 13 mantissa bits cleared (a tf32 value), lo = v - hi
// exactly.  The tensor cores read the 11 leading bits of lo; the rest lies below 2^-20 of v.
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(v) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (a0..a3) split into hi and lo parts.
struct FragA {
  unsigned hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};

// A B fragment (b0, b1) split into hi and lo parts.
struct FragB {
  unsigned hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
};

// d += a b in 3xTF32 (a_lo b_lo dropped) is pass 0, 1, 2 in turn, the small terms first.
// C.h runs each pass over its eight accumulators before the next, so that no mma waits on
// the one before it, and C.B^T keeps a pass in an accumulator of its own.
__device__ __forceinline__ void pass(int k, float (&d)[4], const FragA& a, const FragB& b) {
  if (k == 0) mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  if (k == 1) mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  if (k == 2) mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

__device__ __forceinline__ void copy16(float* dst, const float* src, bool in) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Rows [t0, t0 + valid) of part `part` of a chunk (0: this CTA's x columns, 1: its group's
// B, 2: C) into stage `st` by cp.async from every thread, 16 bytes each, zero-filled past the
// rows and columns the operand has; one commit group.  A chunk's three parts are issued at
// three points of the chunk before, so that no thread waits long for the copy queue.
__device__ __forceinline__ void copy_part(const Args& a, const Layout& ly, float* st, int part,
                                          int b, int h, int grp, int t0, int valid) {
  const int nq = part == 0 ? 4 * a.mt : a.npad / 4;  // 16-byte pieces of a row
  const int cols = part == 0 ? a.P : a.N;               // columns the operand has
  const int stride = part == 0 ? ly.sx : ly.sb;
  float* dst = part == 0 ? st : st + kQ * ly.sx + (part - 1) * kQ * ly.sb;
  const float* src = part == 0 ? a.x : part == 1 ? a.Bm : a.Cm;
  const int di = blockDim.x / nq, dq = blockDim.x % nq;
  for (int i = threadIdx.x / nq, q = threadIdx.x % nq; i < kQ;) {
    const bool in = i < valid && 4 * q < cols;
    const size_t row = (size_t)b * a.L + t0 + i;
    const size_t off = part == 0 ? (row * a.H + h) * a.P : (row * a.G + grp) * a.N;
    copy16(dst + i * stride + 4 * q, in ? src + off + 4 * q : src, in);
    i += di, q += dq;
    if (q >= nq) q -= nq, ++i;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One CTA per (row, head), blockDim 32 * mt * NG; clusters of a.c CTAs along x.
// Warp (mt_w, g) = (warp % mt, warp / mt).  Lane: gid = lane / 4, t = lane % 4.
template <int NG>
__global__ void __launch_bounds__(NG == 1 ? 128 : NG == 2 ? 256 : 512, 1)
ssd_chunked_kernel(const Args a) {
  constexpr int kTiles = 16 / NG;  // the most state column tiles a warp owns
  constexpr int kOwn = 8 / NG;     // y's i-tiles a warp finishes
  extern __shared__ __align__(16) float smem[];
  const int MT = a.mt, warps = MT * NG;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, t4 = lane & 3;
  const int mtw = warp % MT, g = NG == 1 ? 0 : warp / MT;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, grp = h / (a.H / a.G);
  const int rank = bh % a.c;
  const int NTg = a.npad / (8 * NG), nt0 = g * NTg;  // this warp's state column tiles
  const int pr = 16 * mtw + gid;                      // its first state row (CTA-local)
  const Layout ly = layout(MT, a.npad, a.c, warps);
  float* W = smem + ly.w;
  float* sS = smem + ly.sarr;
  float* sE = sS + kQ;
  float* sWd = sE + kQ;
  float* sDt = sWd + kQ;
  const float a_h = a.A[h], d_h = a.D[h];
  const bool has_init = a.init != nullptr;
  const int n_chunks = (a.L + kQ - 1) / kQ;
  cg::cluster_group cluster = cg::this_cluster();

  for (int part = 0; part < 3; ++part)
    copy_part(a, ly, smem, part, b, h, grp, 0, min(kQ, a.L));
  // warp 0 keeps the next chunk's dt in registers (two steps a lane) for its scan
  float dt_next[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = 2 * lane + k;
    dt_next[k] = warp == 0 && i < min(kQ, a.L) ? a.dt[((size_t)b * a.L + i) * a.H + h] : 0.f;
  }

  // the state h[p][n], p = pr (+8 for [2], [3]), n = 8 (nt0 + u) + 2 t (+1 for [1], [3])
  float hs[kTiles][4];
#pragma unroll
  for (int u = 0; u < kTiles; ++u) {
    const int n = 8 * (nt0 + u) + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = pr + 8 * half;
      float2 v = make_float2(0.f, 0.f);
      if (has_init && u < NTg && p < a.P && n < a.N)
        v = *reinterpret_cast<const float2*>(a.init + ((size_t)bh * a.P + p) * a.N + n);
      hs[u][2 * half] = v.x;
      hs[u][2 * half + 1] = v.y;
    }
  }

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * kQ, valid = min(kQ, a.L - t0), kmax = (valid + 7) / 8;
    float* xs = smem + (ch & 1) * ly.stage;
    float* bs = xs + kQ * ly.sx;
    float* cs = bs + kQ * ly.sb;
    float* next = smem + ((ch + 1) & 1) * ly.stage;  // chunk ch + 1's stage
    const int vnext = min(kQ, a.L - t0 - kQ);          // its rows (<= 0: none)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk ch has landed, and every access to chunk ch - 1's stage is done
    if (vnext > 0) copy_part(a, ly, next, 0, b, h, grp, t0 + kQ, vnext);

    // ---- the cumulative log-decay: warp 0, two steps a lane, while the others start C.B^T
    if (warp == 0) {
      const float dt0 = dt_next[0], dt1 = dt_next[1];
      const float d0 = dt0 * a_h, d1 = dt1 * a_h;
      float v = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      float before = __shfl_up_sync(0xffffffffu, v, 1);
      if (lane == 0) before = 0.f;
      const float s0 = before + d0, s1 = s0 + d1;
      const float s_last = __shfl_sync(0xffffffffu, s1, 31);
      sS[2 * lane] = s0 * kLog2e;  // log2 of the decay, for W's exp2f
      sS[2 * lane + 1] = s1 * kLog2e;
      sE[2 * lane] = expf(s0);
      sE[2 * lane + 1] = expf(s1);
      sWd[2 * lane] = dt0 * expf(s_last - s0);
      sWd[2 * lane + 1] = dt1 * expf(s_last - s1);
      sDt[2 * lane] = dt0;
      sDt[2 * lane + 1] = dt1;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = 2 * lane + k;
        dt_next[k] = i < vnext ? a.dt[((size_t)b * a.L + t0 + kQ + i) * a.H + h] : 0.f;
      }
    }

    // ---- C.B^T columns [rank wdt, rank wdt + wdt): tiles (mi, nj), k order permuted ----
    float* cbs = smem + ly.cb + (a.c > 1 ? (ch & 1) * ly.cbs : 0);
    {
      const int jt = ly.wdt / 8, tiles = 4 * jt;
      for (int tau = warp; tau < tiles; tau += warps) {
        const int mi = tau / jt, nj = tau % jt;
        const float* c0 = cs + (16 * mi + gid) * ly.sb + 2 * t4;
        const float* c1 = c0 + 8 * ly.sb;
        const float* bj = bs + (rank * ly.wdt + 8 * nj + gid) * ly.sb + 2 * t4;
        float d[3][4] = {};  // a pass each, summed at the end: no mma waits on another
#pragma unroll 4
        for (int k0 = 0; k0 < a.npad; k0 += 8) {
          const float2 u = *reinterpret_cast<const float2*>(c0 + k0);
          const float2 v = *reinterpret_cast<const float2*>(c1 + k0);
          const float2 w = *reinterpret_cast<const float2*>(bj + k0);
          FragA fa;
          FragB fb;
          fa.set(u.x, v.x, u.y, v.y);
          fb.set(w.x, w.y);
#pragma unroll
          for (int k = 0; k < 3; ++k) pass(k, d[k], fa, fb);
        }
        float* o = cbs + (16 * mi + gid) * ly.scb + 8 * nj + 2 * t4;
        *reinterpret_cast<float2*>(o) =
            make_float2(d[0][0] + d[1][0] + d[2][0], d[0][1] + d[1][1] + d[2][1]);
        *reinterpret_cast<float2*>(o + 8 * ly.scb) =
            make_float2(d[0][2] + d[1][2] + d[2][2], d[0][3] + d[1][3] + d[2][3]);
      }
    }
    if (a.c > 1)
      cluster_sync();
    else
      __syncthreads();
    if (vnext > 0) copy_part(a, ly, next, 1, b, h, grp, t0 + kQ, vnext);

    // ---- W[i][j] = (C_i . B_j) exp(s_i - s_j) dt_j for j <= i, else 0: a thread's column
    // j is fixed (one rank's slice), its rows i0 + istep r; the loads go first ----
    {
      const int j = tid & (kQ - 1), i0 = tid / kQ, istep = blockDim.x / kQ;
      const float sj = sS[j], dj = sDt[j];
      const float* src =
          (a.c > 1 ? cluster.map_shared_rank(cbs, j / ly.wdt) : cbs) + j % ly.wdt;
      for (int i1 = i0; i1 < kQ; i1 += 8 * istep) {
        float v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i1 + istep * r;
          v[r] = i < kQ && j <= i ? src[i * ly.scb] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i1 + istep * r;
          if (i < kQ) W[i * kSW + j] = j <= i ? v[r] * exp2f(sS[i] - sj) * dj : 0.f;
        }
      }
    }
    __syncthreads();
    if (vnext > 0) copy_part(a, ly, next, 2, b, h, grp, t0 + kQ, vnext);

    // ---- y^T partials: C.h over this warp's state columns for every i-tile ----
    const bool has_state = ch > 0 || has_init;
    float inter[8][4], intra[kOwn][4];
#pragma unroll
    for (int it = 0; it < 8; ++it)
#pragma unroll
      for (int r = 0; r < 4; ++r) inter[it][r] = 0.f;
#pragma unroll
    for (int v = 0; v < kOwn; ++v)
#pragma unroll
      for (int r = 0; r < 4; ++r) intra[v][r] = 0.f;
    if (has_state) {
#pragma unroll
      for (int u = 0; u < kTiles; ++u) {
        if (u < NTg) {
          const int n0 = 8 * (nt0 + u);
          FragA fa;  // slot t <-> column 2t, slot t + 4 <-> 2t + 1 of the accumulator
          fa.set(hs[u][0], hs[u][2], hs[u][1], hs[u][3]);
          FragB fb[8];
#pragma unroll
          for (int it = 0; it < 8; ++it) {
            const float2 w =
                *reinterpret_cast<const float2*>(cs + (8 * it + gid) * ly.sb + n0 + 2 * t4);
            fb[it].set(w.x, w.y);
          }
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int it = 0; it < 8; ++it)
              if (it < kmax) pass(k, inter[it], fa, fb[it]);
        }
      }
    }

    // ---- W.x for this warp's i-tiles, and the state update, over the chunk's steps j ----
    const float decay = sE[kQ - 1];
#pragma unroll
    for (int u = 0; u < kTiles; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) hs[u][r] *= decay;
#pragma unroll 1
    for (int kk = 0; kk < kmax; ++kk) {
      const int j0 = 8 * kk;
      const float* xr = xs + (j0 + t4) * ly.sx + pr;
      const float x0 = xr[0], x1 = xr[8], x2 = xr[4 * ly.sx], x3 = xr[4 * ly.sx + 8];
      FragA fx;
      fx.set(x0, x1, x2, x3);
#pragma unroll
      for (int v = 0; v < kOwn; ++v) {
        const int it = g + NG * v;
        if (it >= kk && it < kmax) {
          const float* wr = W + (8 * it + gid) * kSW + j0 + t4;
          FragB fb;
          fb.set(wr[0], wr[4]);
#pragma unroll
          for (int k = 0; k < 3; ++k) pass(k, intra[v], fx, fb);
        }
      }
      const float w0 = sWd[j0 + t4], w1 = sWd[j0 + t4 + 4];
      FragA fw;
      fw.set(x0 * w0, x1 * w0, x2 * w1, x3 * w1);
      const float* br = bs + (j0 + t4) * ly.sb + 8 * nt0 + gid;
#pragma unroll
      for (int u = 0; u < kTiles; ++u) {
        if (u < NTg) {
          FragB fb;
          fb.set(br[8 * u], br[4 * ly.sb + 8 * u]);
#pragma unroll
          for (int k = 0; k < 3; ++k) pass(k, hs[u], fw, fb);
        }
      }
    }

    // ---- the partials meet (in the B/C region, read by now), then y is finished ----
    const float* xbuf = bs;
    if (has_state && NG > 1) {
      __syncthreads();
      float* out = bs + ((mtw * 8 * NG + g) * 32 + lane) * 4;
#pragma unroll
      for (int it = 0; it < 8; ++it)
        if (it < kmax)
          *reinterpret_cast<float4*>(out + it * NG * 128) =
              make_float4(inter[it][0], inter[it][1], inter[it][2], inter[it][3]);
      __syncthreads();
    }
#pragma unroll
    for (int v = 0; v < kOwn; ++v) {
      const int it = g + NG * v;
      if (it >= kmax) continue;
      float tot[4] = {0.f, 0.f, 0.f, 0.f};
      if (has_state) {
        if (NG == 1) {
#pragma unroll
          for (int r = 0; r < 4; ++r) tot[r] = inter[v][r];
        } else {
          const float* in = xbuf + (((mtw * 8 + it) * NG) * 32 + lane) * 4;
          const float4 first = *reinterpret_cast<const float4*>(in);
          tot[0] = first.x, tot[1] = first.y, tot[2] = first.z, tot[3] = first.w;
#pragma unroll
          for (int g2 = 1; g2 < NG; ++g2) {
            const float4 more = *reinterpret_cast<const float4*>(in + g2 * 128);
            tot[0] += more.x, tot[1] += more.y, tot[2] += more.z, tot[3] += more.w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * it + 2 * t4 + (r & 1), pl = pr + 8 * (r >> 1);
        if (i < valid && pl < a.P)
          a.y[(((size_t)b * a.L + t0 + i) * a.H + h) * a.P + pl] =
              intra[v][r] + sE[i] * tot[r] + d_h * xs[i * ly.sx + pl];
      }
    }
  }
  if (a.c > 1) cluster_sync();  // no CTA leaves while another may read its slices

#pragma unroll
  for (int u = 0; u < kTiles; ++u) {
    const int n = 8 * (nt0 + u) + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = pr + 8 * half;
      if (u < NTg && p < a.P && n < a.N)
        *reinterpret_cast<float2*>(a.fstate + ((size_t)bh * a.P + p) * a.N + n) =
            make_float2(hs[u][2 * half], hs[u][2 * half + 1]);
    }
  }
}

template <int NG>
cudaError_t allow() {
  return cudaFuncSetAttribute(ssd_chunked_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

// The plan's checks (kernels/ssd.py ssd_plan makes only plans that pass them); the launch's
// shape in `cfg` and the kernel in `fn`.
cudaError_t config(int B, int H, int G, int P, int N, int groups, int cluster,
                   cudaStream_t stream, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                   void (**fn)(Args)) {
  const int mt = (P + 15) / 16, npad = (N + 15) / 16 * 16;
  if (P % 4 || P > kMaxP || P < 4 || N % 4 || N > kMaxN || N < 4 || G < 1 || H % G || B < 1)
    return cudaErrorInvalidValue;
  if ((groups & (groups - 1)) || groups < 1 || groups > 8 || (npad / 8) % groups ||
      cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) || (H / G) % cluster)
    return cudaErrorInvalidValue;
  const int warps = mt * groups;
  if (warps > kMaxWarps || warps % 2) return cudaErrorInvalidValue;  // W takes 64-thread rows
  const size_t smem = (size_t)layout(mt, npad, cluster, warps).floats * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  switch (groups) {
    case 1: *fn = ssd_chunked_kernel<1>; break;
    case 2: *fn = ssd_chunked_kernel<2>; break;
    case 4: *fn = ssd_chunked_kernel<4>; break;
    default: *fn = ssd_chunked_kernel<8>; break;
  }
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Raises every instantiation's shared-memory limit to 227 KB: once, when the library is
// loaded (kernels/ssd.py), so never during a call or a CUDA-graph capture.
extern "C" int zt_ssd_chunked_prepare() {
  const cudaError_t errs[] = {allow<1>(), allow<2>(), allow<4>(), allow<8>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

// Shapes as in the header comment; init may be null; 16-byte-aligned pointers.  The plan
// (column groups of warps, cluster size) as kernels/ssd.py ssd_plan makes it.
extern "C" int zt_ssd_chunked(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* D, const void* init, void* y,
                              void* fstate, int B, int L, int H, int G, int P, int N, int groups,
                              int cluster, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  void (*fn)(Args) = nullptr;
  if (L < 1) return cudaErrorInvalidValue;
  cudaError_t err =
      config(B, H, G, P, N, groups, cluster, static_cast<cudaStream_t>(stream), cfg, attr, &fn);
  if (err != cudaSuccess) return err;
  const Args args{static_cast<const float*>(x),  static_cast<const float*>(dt),
                  static_cast<const float*>(A),  static_cast<const float*>(Bm),
                  static_cast<const float*>(Cm), static_cast<const float*>(D),
                  static_cast<const float*>(init), static_cast<float*>(y),
                  static_cast<float*>(fstate), L, H, G, P, N, (P + 15) / 16,
                  (N + 15) / 16 * 16, cluster};
  err = cudaLaunchKernelEx(&cfg, fn, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The dynamic shared memory (bytes) of a plan, or -1 if the kernel refuses it.
extern "C" int zt_ssd_chunked_smem(int H, int G, int P, int N, int groups, int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  void (*fn)(Args) = nullptr;
  if (config(1, H, G, P, N, groups, cluster, nullptr, cfg, attr, &fn) != cudaSuccess)
    return -1;
  return (int)cfg.dynamicSmemBytes;
}

// How many clusters of a plan the card holds at once (0: it cannot launch them).
extern "C" int zt_ssd_chunked_max_active_clusters(int H, int G, int P, int N, int groups,
                                                  int cluster, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  void (*fn)(Args) = nullptr;
  cudaError_t err = config(1, H, G, P, N, groups, cluster, nullptr, cfg, attr, &fn);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(cluster);
  return cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
}
