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
// and is rounded to bf16 before w2, and the output is rounded once.  The activations are
// never quantized: the products are bf16 x bf16 summed in fp32.
//
// What bounds it on an H100: reading wo, w1 and w2 once from HBM (3.35 TB/s): 4.2 + 33.6 +
// 16.8 = 54.6 MB at the flagship's width (d 2048, I 8192), ~16.3 us a layer.  Each weight
// feeds 2 * B2 flops; at B2 = 128 that is 7.0 GFLOP, 7.1 us at the bf16 tensor-core peak
// (989 TFLOP/s), so bytes bound it up to B2 = 128 too (16.8 us).
//
// Design.
// - Four launches on the stream, as CTAs share nothing within one: (1) wo -> its split
//   partial sums; (2) one CTA per row adds them and the residual -> x2 (fp32 [B2, d]), and
//   runs the LayerNorm (two-pass mean and variance, as the Pallas body) -> h (bf16 [B2,
//   d]); (3) w1 and the SwiGLU -> act (bf16 [B2, I]); (4) w2 + x2 -> out.  Each row's
//   statistics are computed once a call.  One kernel template serves the three weight
//   passes.
// - Tensor cores: mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with the weights as A (16
//   output columns x 16 k) and the activations as B (16 k x 8 rows of x): a CTA takes up to
//   128 rows of x (NT <= 16 n-tiles), and every dequantized A fragment feeds all NT n-tiles,
//   so each weight byte is read from HBM and dequantized once a call for any B2 <= 128.
//   Rows beyond 128 take further row tiles on the grid's z axis, which read the weights
//   again (from L2 after the first).
// - Dequantizing, off the card's slow conversion units: an A register is a k-pair of one
//   column, i.e. bytes of two weight rows.  One byte permute puts byte b of row k in the low
//   byte of the register's low half and byte b of row k + 1 in that of its high half; then,
//   per half with int8 value q, (h & 0x7F) | 0x4300 is bf16 128 + (q & 127) and
//   (h & 0x80) | 0x4300 is bf16 128 for q >= 0 and 256 for q < 0, and one bf16x2 subtract
//   of the two gives q exactly.  For wo and w2 a bf16x2 multiply by the column's scale
//   (twice) rounds q * s to bf16 as the Pallas body does; for w1 q itself is the operand and
//   the scale multiplies the fp32 sum in the epilogue.
// - k is in its natural order: a k-step of 16 weight rows gives k-pair i = rows 2i, 2i + 1,
//   so a B register is one 32-bit word of a staged row of x as it lies in memory, and one
//   ldmatrix.x4 of the staged rows gives the B registers of two n-tiles.
// - The column permutation.  A lane (gid = lane / 4, tig = lane % 4) needs A rows gid and
//   gid + 8 (two columns) at k-pairs tig and tig + 4 (weight rows 2 tig, 2 tig + 1,
//   2 tig + 8 and 2 tig + 9 of the k-step).  So a warp's 16 columns are dealt out so that
//   a lane's two columns are adjacent bytes of each of those rows: byte 0 of its pair is A
//   row gid, byte 1 A row gid + 8.  The epilogue writes each accumulator to its true
//   column.
// - Worked example (the wo pass).  CTA column tile 0, warp 3 (columns 48-63), lane 9
//   (gid 2, tig 1): its columns are 52 and 53.  In the k-step at stage row 16 (weight row
//   k0 + 16 on) it reads 2 bytes of stage rows 18, 19, 26 and 27.  a0 = (w[k0+18][52],
//   w[k0+19][52]) * s[52] (A row 2 = column 52, k 2-3), a1 = the same rows at column 53
//   (A row 10), a2 and a3 rows k0+26, k0+27 (k 10-11) at columns 52 and 53.  n-tile 0's B
//   registers are (x[2][k0+18], x[2][k0+19]) and (x[2][k0+26], x[2][k0+27]); its
//   accumulators hold out[2][52], out[3][52], out[2][53] and out[3][53].
// - Tiles.  A CTA is 8 warps side by side over 128 columns (w1: 128 up and the matching
//   128 gate columns), each warp one m-tile of 16, so a thread holds at most 2 x 16 x 4 =
//   128 fp32 accumulators (w1 at NT = 16).  Narrow tiles keep the split sums of a tile
//   small at B2 = 128 (see below) and give wo and w2 16 column tiles at d = 2048.
// - Bytes in flight: the CTA's weight rows (128 bytes, or 256 for w1's up and gate) and
//   its rows of x stream through a 3-stage ring in shared memory by cp.async.cg (16 bytes
//   a thread a copy, bypassing L1), two stages ahead of the MMAs.  A stage holds 32 KB of
//   weights (256 rows for wo and w2, 128 for w1; 128 rows from 8 n-tiles on, where x
//   takes the room), so 64 KB are in flight per SM (one CTA per SM).  Measured: deeper
//   rings of smaller stages (up to 8 x 64 rows) were slower, not faster.  The ring's row
//   pitches (144 or 272 bytes for weights, 4 mod 32 words for x) make the fragment loads
//   conflict-free.
// - The split and the sum: each pass splits its contraction over the grid's y axis (about
//   one CTA per SM in all, chip_smoke.py --sweep), and every CTA writes its fp32 sums to a
//   partial plane.  For w1 and w2 the last CTA of a (column tile, row tile) to finish (an
//   atomic counter) adds the planes in split order, 16 bytes a load with four splits of
//   4-8 column groups in flight a thread, and applies the pass's epilogue; wo's planes are
//   added, in split order too, by the LayerNorm launch, one CTA per row.  So the result
//   does not depend on the order the CTAs ran in.  The wrapper caps the splits so that a
//   last CTA adds at most 512 KB (kernels/layer_tail.py split_count).  The counters are
//   the call's own, zeroed on its stream before the first pass.
// - Left for later: wgmma with A from registers and TMA loads of the weight stages; a
//   thread-block-cluster reduction through distributed shared memory in place of the
//   partials, counters and memset; the LayerNorm folded into the w1 pass at small B2.
//
// C interface (ctypes): returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKStep = 16;                        // k of one mma
constexpr int kStageBytes = 32 * 1024;            // weight bytes a ring stage holds, at most
constexpr int kMaxStages = 3;                     // stages of the ring, at most
constexpr int kSmemBudget = 220 * 1024;           // dynamic shared memory a ring may take
constexpr int kTile = kWarps * 16;                // columns a CTA takes (per half): a warp 16
constexpr int kMaxRows = 128;                     // rows of x a CTA takes (16 n-tiles)
constexpr int kAlign = 16;                        // K, N: multiples of it
constexpr int kSumSplits = 4;                     // splits of a column group in flight

enum Pass { kWo = 0, kUp = 1, kDown = 2 };

// H: weight halves a CTA takes (w1: up and gate).  A stage row holds the CTA's kTile
// columns of each half, pitched at 16 mod 64 bytes: conflict-free A loads.
__host__ __device__ constexpr int halves(int P) { return P == kUp ? 2 : 1; }
__host__ __device__ constexpr int w_pitch(int P) { return kTile * halves(P) + 16; }
// weight rows of a ring stage: kStageBytes of them, but 128 at most from 8 n-tiles on, where
// the stage's rows of x take the room
__host__ __device__ constexpr int stage_rows(int P, int nt) {
  return nt >= 8 || kStageBytes / (kTile * halves(P)) < 128 ? 128
                                                             : kStageBytes / (kTile * halves(P));
}
// x's row pitch in a stage, 4 mod 32 words: conflict-free B loads
__host__ __device__ constexpr int x_pitch_words(int P, int nt) {
  return stage_rows(P, nt) / 2 + 4;
}
// bytes of one ring stage: the weight rows, then NT * 8 rows of x
__host__ __device__ constexpr int stage_bytes(int P, int nt) {
  return stage_rows(P, nt) * w_pitch(P) + nt * 8 * x_pitch_words(P, nt) * 4;
}
// ring stages: as many as the budget holds, at most kMaxStages
__host__ __device__ constexpr int n_stages(int P, int nt) {
  return kSmemBudget / stage_bytes(P, nt) < kMaxStages ? kSmemBudget / stage_bytes(P, nt)
                                                        : kMaxStages;
}

struct Args {
  const __nv_bfloat16* x;      // the B operand [B2, K] bf16: attn (wo), h (w1), act (w2)
  const float* x2;             // kDown: the residual [B2, N]
  const int8_t* wq;            // [K, ldw]
  const __nv_bfloat16* ws;     // [ldw]
  __nv_bfloat16* act_out;      // kUp: [B2, N]
  __nv_bfloat16* out;          // kDown: [B2, N]
  float* partial;              // [n_split, H, B2, N] fp32
  unsigned* counters;          // one per (column tile, row tile), zero on entry
  int B2, K, N, ldw, n_split, k_split;  // k_split: contraction rows per split, a multiple of 16
};

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned bits) {
  __nv_bfloat162 v;
  *reinterpret_cast<unsigned*>(&v) = bits;
  return v;
}

__device__ __forceinline__ unsigned bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// The A register of byte b of two weight rows (`lo` holds row k's bytes, `hi` row k + 1's):
// bf16 (w[k][c], w[k + 1][c]), exact.
__device__ __forceinline__ __nv_bfloat162 int8_pair(unsigned lo, unsigned hi, int b) {
  const unsigned p = __byte_perm(lo, hi, b | (b << 4) | ((b + 4) << 8) | ((b + 4) << 12));
  const unsigned mag = (p & 0x007F007Fu) | 0x43004300u;   // 128 + (q & 127)
  const unsigned base = (p & 0x00800080u) | 0x43004300u;  // 128, or 256 where q < 0
  return __hsub2(as_bf162(mag), as_bf162(base));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B registers of two n-tiles (one if `one`) from the staged rows of x: the 8 x 8 bf16
// matrices whose rows (16 bytes each) the lanes address.
template <bool one>
__device__ __forceinline__ void ldmatrix_b(unsigned addr, unsigned (&b)[2][2]) {
  if constexpr (one) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(b[0][0]), "=r"(b[0][1]) : "r"(addr));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1]) : "r"(addr));
  }
}

__device__ __forceinline__ void copy16(void* dst, const void* src, bool in) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int n>
__device__ __forceinline__ void wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Starts the copy of one ring stage: weight rows [kr, kr + 64) of the CTA's columns (w1:
// its up columns, then the matching gate columns) and the same k of its NT * 8 rows of x.
// Rows at or past k_end, columns past N and rows of x past `rows` are zero-filled without
// reading global memory.
template <int P, int NT>
__device__ __forceinline__ void load_stage(const Args& a, unsigned char* st, int kr, int k_end,
                                           int col0, int m0, int rows) {
  constexpr int R = stage_rows(P, NT), XP = x_pitch_words(P, NT);
  constexpr int kRowChunks = kTile * halves(P) / 16;
  constexpr int kWChunks = R * kRowChunks;
  constexpr int kXChunks = NT * 8 * R / 8;
  unsigned char* xs = st + R * w_pitch(P);
#pragma unroll 4
  for (int c = threadIdx.x; c < kWChunks + kXChunks; c += kThreads) {
    if (c < kWChunks) {
      const int r = c / kRowChunks, q = c % kRowChunks;
      const int col = col0 + (q % (kTile / 16)) * 16;  // column within the half
      const bool in = kr + r < k_end && col < a.N;
      const int8_t* src = a.wq + (size_t)(kr + r) * a.ldw + (q / (kTile / 16)) * a.N + col;
      copy16(st + r * w_pitch(P) + q * 16, in ? src : a.wq, in);
    } else {
      const int i = c - kWChunks, n = i / (R / 8), q = i % (R / 8);
      const bool in = n < rows && kr + q * 8 < k_end;
      const __nv_bfloat16* src = a.x + (size_t)(m0 + n) * a.K + kr + q * 8;
      copy16(xs + n * XP * 4 + q * 16, in ? src : a.x, in);
    }
  }
}

// The MMAs of one ring stage: `ksteps` k-steps of 16 rows over all NT n-tiles (rows of x
// past B2 are zeros).  sp: the lane's two columns' scale pairs (wo, w2).
template <int P, int NT>
__device__ __forceinline__ void mma_stage(const unsigned char* st, int ksteps,
                                          const __nv_bfloat162 (&sp)[2],
                                          float (&acc)[halves(P)][NT][4]) {
  constexpr int H = halves(P), R = stage_rows(P, NT), XP = x_pitch_words(P, NT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  // ldmatrix row addresses, k-step 0: lane l gives row l % 8 of n-tile 2 * (pair) + l / 16,
  // k 0-7 (l / 8 even) or 8-15 (odd), so matrices 0-3 are b0, b1 of two n-tiles
  const unsigned xl = static_cast<unsigned>(__cvta_generic_to_shared(st + R * w_pitch(P))) +
                      (((lane >> 4) * 8 + (lane & 7)) * XP + ((lane >> 3) & 1) * 4) * 4;
  // the lane's two bytes (columns) of stage row 2 tig, k-step 0
  const unsigned char* wl = st + 2 * tig * w_pitch(P) + warp * 16 + 2 * gid;
#pragma unroll
  for (int ks = 0; ks < R / kKStep; ++ks) {
    if (ks >= ksteps) break;  // CTA-uniform
    unsigned a[H][4];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const unsigned char* p = wl + ks * kKStep * w_pitch(P) + h * kTile;
      unsigned w[4];  // stage rows 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 of the k-step
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const unsigned char* pr = p + ((r & 1) + 8 * (r >> 1)) * w_pitch(P);
        w[r] = *reinterpret_cast<const unsigned short*>(pr);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a0..a3: (rows 2tig / 2tig+8) x (byte 0 / 1)
        const int b = e & 1, r = 2 * (e >> 1);
        __nv_bfloat162 v = int8_pair(w[r], w[r + 1], b);
        if (P != kUp) v = __hmul2(v, sp[b]);
        a[h][e] = bits_of(v);
      }
    }
#pragma unroll
    // all NT n-tiles: a runtime bound on this loop measured slower than computing them all
    for (int nt = 0; nt < NT; nt += 2) {
      unsigned b[2][2];  // [n-tile][b0, b1]: lane (gid, tig): x[n][2 tig..], x[n][2 tig + 8..]
      ldmatrix_b<NT == 1>(xl + (nt * 8 * XP + ks * (kKStep / 2)) * 4, b);
#pragma unroll
      for (int j = 0; j < (NT == 1 ? 1 : 2); ++j)
#pragma unroll
        for (int h = 0; h < H; ++h) mma_bf16(acc[h][nt + j], a[h], b[j][0], b[j][1]);
    }
  }
}

__device__ __forceinline__ float4 bf16x4(uint2 v) {  // four bf16 -> fp32
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xFFFF0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xFFFF0000u));
}

__device__ __forceinline__ uint2 to_bf16x4(float a, float b, float c, float d) {
  return make_uint2(bits_of(__floats2bfloat162_rn(a, b)), bits_of(__floats2bfloat162_rn(c, d)));
}

// What the pass's epilogue reads for outputs (row m, columns c..c+3): w1 the up and gate
// scales; w2 x2 (written by the LayerNorm launch).
template <int P>
__device__ __forceinline__ void epilogue_inputs(const Args& a, int m, int c, float4 (&in)[2]) {
  const size_t o = (size_t)m * a.N + c;
  if (P == kUp) {
    in[0] = bf16x4(__ldg(reinterpret_cast<const uint2*>(a.ws + c)));
    in[1] = bf16x4(__ldg(reinterpret_cast<const uint2*>(a.ws + a.N + c)));
  } else {
    in[0] = __ldcg(reinterpret_cast<const float4*>(a.x2 + o));
  }
}

__device__ __forceinline__ float swiglu(float u, float su, float g, float sg) {
  u *= su;
  g *= sg;
  return u * (1.0f / (1.0f + expf(-g))) * g;
}

// The epilogue of the w1 or w2 pass for outputs (row m, columns c..c+3) from their H sums t.
template <int P>
__device__ __forceinline__ void epilogue(const Args& a, int m, int c, const float4 (&t)[2],
                                         const float4 (&in)[2]) {
  const size_t o = (size_t)m * a.N + c;
  if (P == kUp) {
    *reinterpret_cast<uint2*>(a.act_out + o) = to_bf16x4(
        swiglu(t[0].x, in[0].x, t[1].x, in[1].x), swiglu(t[0].y, in[0].y, t[1].y, in[1].y),
        swiglu(t[0].z, in[0].z, t[1].z, in[1].z), swiglu(t[0].w, in[0].w, t[1].w, in[1].w));
  } else {
    *reinterpret_cast<uint2*>(a.out + o) = to_bf16x4(in[0].x + t[0].x, in[0].y + t[0].y,
                                                     in[0].z + t[0].z, in[0].w + t[0].w);
  }
}

// The tile's outputs from the split partials (rows [m0, m0 + rows), columns [col0, col0 +
// kTile)): each thread takes 8 / H groups of four columns at a time, reads the epilogue's
// inputs for them, then adds their splits in split order with kSumSplits splits of every
// group in flight, and stores.
template <int P>
__device__ __forceinline__ void sum_splits(const Args& a, int m0, int rows, int col0) {
  constexpr int H = halves(P), G = 8 / H;
  const size_t plane = (size_t)a.B2 * a.N, stride = H * plane;
  const int groups = rows * (kTile / 4);
  for (int g0 = threadIdx.x; g0 < groups; g0 += G * kThreads) {
    float4 t[G][2], in[G][2];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int gi = g0 + g * kThreads, m = m0 + gi / (kTile / 4);
      const int c = col0 + (gi % (kTile / 4)) * 4;
      t[g][0] = t[g][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gi < groups && c < a.N) epilogue_inputs<P>(a, m, c, in[g]);
    }
    for (int s0 = 0; s0 < a.n_split; s0 += kSumSplits) {
      float4 v[kSumSplits][G][H];
#pragma unroll
      for (int k = 0; k < kSumSplits; ++k)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int gi = g0 + g * kThreads, m = m0 + gi / (kTile / 4);
          const int c = col0 + (gi % (kTile / 4)) * 4;
          const bool ok = s0 + k < a.n_split && gi < groups && c < a.N;
#pragma unroll
          for (int h = 0; h < H; ++h)
            v[k][g][h] = ok ? __ldcg(reinterpret_cast<const float4*>(
                                  a.partial + (s0 + k) * stride + h * plane + (size_t)m * a.N + c))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int k = 0; k < kSumSplits; ++k)
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int h = 0; h < H; ++h) {
            t[g][h].x += v[k][g][h].x;
            t[g][h].y += v[k][g][h].y;
            t[g][h].z += v[k][g][h].z;
            t[g][h].w += v[k][g][h].w;
          }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int gi = g0 + g * kThreads, m = m0 + gi / (kTile / 4);
      const int c = col0 + (gi % (kTile / 4)) * 4;
      if (gi < groups && c < a.N) epilogue<P>(a, m, c, t[g], in[g]);
    }
  }
}

// grid (ceil(N / 128), n_split, ceil(B2 / 128)); dynamic shared memory n_stages(P, NT) *
// stage_bytes(P, NT).  NT n-tiles hold the CTA's rows of x (min(B2 - m0, 128) of them).
template <int P, int NT>
__global__ void __launch_bounds__(kThreads, 1) tail_pass_kernel(Args args) {
  constexpr int H = halves(P), S = n_stages(P, NT), SB = stage_bytes(P, NT);
  constexpr int R = stage_rows(P, NT);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool is_last;
  const int col0 = blockIdx.x * kTile, split = blockIdx.y, m0 = blockIdx.z * kMaxRows;
  const int rows = min(kMaxRows, args.B2 - m0);
  const int nt_act = (rows + 7) / 8;
  const int k0 = split * args.k_split;
  const int k_end = min(args.K, k0 + args.k_split);
  const int n_st = (k_end - k0 + R - 1) / R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int lcol = col0 + warp * 16 + 2 * gid;  // the lane's two columns, per half

  __nv_bfloat162 sp[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const __nv_bfloat16 s = P != kUp && lcol + b < args.N ? args.ws[lcol + b]
                                                          : __float2bfloat16_rn(0.f);
    sp[b] = __halves2bfloat162(s, s);
  }
  float acc[H][NT][4];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_st)
      load_stage<P, NT>(args, smem + s * SB, k0 + s * R, k_end, col0, m0, rows);
    commit();
  }
  for (int s = 0; s < n_st; ++s) {
    wait_stages<S - 2>();
    __syncthreads();  // stage s is in; every warp is done with the buffer refilled below
    const int sn = s + S - 1;
    if (sn < n_st)
      load_stage<P, NT>(args, smem + (sn % S) * SB, k0 + sn * R, k_end, col0, m0, rows);
    commit();
    const int ksteps = min(R, k_end - k0 - s * R) / kKStep;
    mma_stage<P, NT>(smem + (s % S) * SB, ksteps, sp, acc);
  }
  wait_stages<0>();

  // this split's sums -> its partial plane; accumulator e is row 2 tig + (e & 1) of the
  // n-tile at the lane's column e >> 1, so (e, e + 2) are one float2
  const size_t plane = (size_t)args.B2 * args.N;
  float* part = args.partial + (size_t)split * H * plane;
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= nt_act) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + nt * 8 + 2 * tig + r;
        if (m < args.B2 && lcol < args.N)
          *reinterpret_cast<float2*>(part + h * plane + (size_t)m * args.N + lcol) =
              make_float2(acc[h][nt][r], acc[h][nt][r + 2]);
      }
    }

  if constexpr (P != kWo) {  // (the LayerNorm launch adds wo's splits)
    if (args.n_split > 1) {  // the tile's last CTA adds the splits
      __threadfence();
      __syncthreads();
      unsigned* counter = args.counters + blockIdx.z * gridDim.x + blockIdx.x;
      if (threadIdx.x == 0) is_last = atomicAdd(counter, 1u) == (unsigned)args.n_split - 1;
      __syncthreads();
      if (!is_last) return;
      __threadfence();
    } else {
      __syncthreads();
    }
    sum_splits<P>(args, m0, rows, col0);
  }
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

// grid (B2), one row m each: x2[m] = resid[m] + the wo pass's splits (added in split
// order, four columns a load), then h[m] = bf16(LayerNorm(x2[m]) * ln_s + ln_b) with the
// mean and the variance in two passes over the row, as the Pallas body computes them.
__global__ void __launch_bounds__(kThreads) tail_layer_norm(
    const float* __restrict__ partial, int n_split, const __nv_bfloat16* __restrict__ resid,
    const __nv_bfloat16* __restrict__ ln_s, const __nv_bfloat16* __restrict__ ln_b,
    float* __restrict__ x2, __nv_bfloat16* __restrict__ h, int B2, int d, float eps) {
  __shared__ float red[kWarps];
  const size_t row = (size_t)blockIdx.x * d, plane = (size_t)B2 * d;
  float s = 0.f;
  for (int c = 4 * threadIdx.x; c < d; c += 4 * kThreads) {
    float4 t = bf16x4(__ldg(reinterpret_cast<const uint2*>(resid + row + c)));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_split; s0 += 8) {
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = s0 + k < n_split
                   ? __ldcg(reinterpret_cast<const float4*>(partial + (s0 + k) * plane + row + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc.x += v[k].x;
        acc.y += v[k].y;
        acc.z += v[k].z;
        acc.w += v[k].w;
      }
    }
    t = make_float4(t.x + acc.x, t.y + acc.y, t.z + acc.z, t.w + acc.w);
    *reinterpret_cast<float4*>(x2 + row + c) = t;
    s += (t.x + t.y) + (t.z + t.w);
  }
  const float mu = block_sum(s, red) / d;
  float v = 0.f;
  for (int c = 4 * threadIdx.x; c < d; c += 4 * kThreads) {  // the thread's own x2 values
    const float4 t = *reinterpret_cast<const float4*>(x2 + row + c);
    v += ((t.x - mu) * (t.x - mu) + (t.y - mu) * (t.y - mu)) +
         ((t.z - mu) * (t.z - mu) + (t.w - mu) * (t.w - mu));
  }
  const float rstd = rsqrtf(block_sum(v, red) / d + eps);
  for (int c = 4 * threadIdx.x; c < d; c += 4 * kThreads) {
    const float4 t = *reinterpret_cast<const float4*>(x2 + row + c);
    const float4 sc = bf16x4(__ldg(reinterpret_cast<const uint2*>(ln_s + c)));
    const float4 b = bf16x4(__ldg(reinterpret_cast<const uint2*>(ln_b + c)));
    *reinterpret_cast<uint2*>(h + row + c) =
        to_bf16x4((t.x - mu) * rstd * sc.x + b.x, (t.y - mu) * rstd * sc.y + b.y,
                  (t.z - mu) * rstd * sc.z + b.z, (t.w - mu) * rstd * sc.w + b.w);
  }
}

template <int P, int NT>
cudaError_t launch_pass(const Args& a, cudaStream_t stream) {
  constexpr int smem = n_stages(P, NT) * stage_bytes(P, NT);
  static const cudaError_t attr = cudaFuncSetAttribute(
      tail_pass_kernel<P, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + kTile - 1) / kTile, a.n_split, (a.B2 + kMaxRows - 1) / kMaxRows);
  tail_pass_kernel<P, NT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// NT: the n-tiles of min(B2, 128) rows, rounded up to a power of two
template <int P>
cudaError_t launch_by_rows(const Args& a, cudaStream_t stream) {
  const int nt = (min(a.B2, kMaxRows) + 7) / 8;
  if (nt == 1) return launch_pass<P, 1>(a, stream);
  if (nt == 2) return launch_pass<P, 2>(a, stream);
  if (nt <= 4) return launch_pass<P, 4>(a, stream);
  if (nt <= 8) return launch_pass<P, 8>(a, stream);
  return launch_pass<P, 16>(a, stream);
}

// Contraction rows per split: ceil(K / n_split) rounded up to a k-step; 0 if a split would
// be empty.
int split_rows(int K, int n_split) {
  if (n_split < 1) return 0;
  const int rows = ((K + n_split - 1) / n_split + kKStep - 1) / kKStep * kKStep;
  return (n_split - 1) * rows < K ? rows : 0;
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename... T>
bool aligned(const void* p, T... rest) { return aligned(p) && aligned(rest...); }

}  // namespace

// attn [B2, dk] bf16; resid [B2, d] bf16; woq [dk, d] int8, wos [d] bf16; ln_s, ln_b [d]
// bf16; w1q [d, 2I] int8 (up columns, then gate), w1s [2I] bf16; w2q [I, d] int8, w2s [d]
// bf16.  Scratch: x2 [B2, d] fp32, h [B2, d] bf16, act [B2, I] bf16, partial fp32 (the
// largest of the passes' n_split * H * B2 * N), counters (2 x one per column tile and row
// tile of the wider of d and I, zeroed here on the stream); out [B2, d] bf16.  All
// contiguous, attn, resid, ln_s, ln_b, the weights and their scales 16-byte aligned; dk, d,
// I multiples of 16; splits_*
// are the passes' contraction splits (none empty).
extern "C" int zt_fused_layer_tail(const void* attn, const void* resid, const void* woq,
                                   const void* wos, const void* ln_s, const void* ln_b,
                                   const void* w1q, const void* w1s, const void* w2q,
                                   const void* w2s, void* x2, void* h, void* act, void* out,
                                   void* partial, void* counters, int B2, int dk, int d, int I,
                                   int splits_wo, int splits_up, int splits_down, float eps,
                                   void* stream) {
  const int rows_wo = split_rows(dk, splits_wo), rows_up = split_rows(d, splits_up),
            rows_down = split_rows(I, splits_down);
  if (B2 < 1 || dk < kAlign || d < kAlign || I < kAlign || dk % kAlign || d % kAlign ||
      I % kAlign || !rows_wo || !rows_up || !rows_down ||
      !aligned(attn, resid, ln_s, ln_b, woq, wos, w1q, w1s, w2q, w2s))
    return cudaErrorInvalidValue;
  Args base{};
  base.partial = static_cast<float*>(partial);
  base.B2 = B2;
  Args wo = base, up = base, down = base;
  wo.x = static_cast<const __nv_bfloat16*>(attn);
  wo.wq = static_cast<const int8_t*>(woq);
  wo.ws = static_cast<const __nv_bfloat16*>(wos);
  wo.K = dk, wo.N = d, wo.ldw = d, wo.n_split = splits_wo, wo.k_split = rows_wo;
  up.x = static_cast<const __nv_bfloat16*>(h);
  up.wq = static_cast<const int8_t*>(w1q);
  up.ws = static_cast<const __nv_bfloat16*>(w1s);
  up.act_out = static_cast<__nv_bfloat16*>(act);
  up.K = d, up.N = I, up.ldw = 2 * I, up.n_split = splits_up, up.k_split = rows_up;
  down.x = static_cast<const __nv_bfloat16*>(act);
  down.x2 = static_cast<const float*>(x2);
  down.wq = static_cast<const int8_t*>(w2q);
  down.ws = static_cast<const __nv_bfloat16*>(w2s);
  down.out = static_cast<__nv_bfloat16*>(out);
  down.K = I, down.N = d, down.ldw = d, down.n_split = splits_down, down.k_split = rows_down;
  // the w1 and w2 passes' counters, one region each
  const size_t per_pass = (size_t)(((d > I ? d : I) + kTile - 1) / kTile) *
                          ((B2 + kMaxRows - 1) / kMaxRows);
  up.counters = static_cast<unsigned*>(counters);
  down.counters = up.counters + per_pass;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counters, 0, 2 * per_pass * sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  if ((err = launch_by_rows<kWo>(wo, st)) != cudaSuccess) return err;
  tail_layer_norm<<<B2, kThreads, 0, st>>>(
      static_cast<const float*>(partial), splits_wo, static_cast<const __nv_bfloat16*>(resid),
      static_cast<const __nv_bfloat16*>(ln_s), static_cast<const __nv_bfloat16*>(ln_b),
      static_cast<float*>(x2), static_cast<__nv_bfloat16*>(h), B2, d, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_by_rows<kUp>(up, st)) != cudaSuccess) return err;
  return launch_by_rows<kDown>(down, st);
}
