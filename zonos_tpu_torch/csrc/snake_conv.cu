// K5: snake activation fused into a dilated, 'same'-padded 1-D convolution, fp32, for
// Hopper (sm_90a).  y = conv1d(snake(x, alpha), w, b) [+ residual], with
// snake(x) = x + sin^2(alpha * x) / (alpha + 1e-9).
//
// Replaces the Pallas TPU kernel zonos_tpu/ops/pallas_dac.py snake_conv1d_pallas (:47;
// body _snake_conv_kernel :30); two launches make snake_residual_unit_pallas (:90), whose
// residual add is fused into the second launch's epilogue here.
//
// What bounds it on an H100: the DAC decoder's residual units are large fp32 products,
// 2 * T * C_in * C_out * k FLOPs (29-58 GFLOP per k = 7 conv for one 5 s utterance)
// against ~T * (C_in + C_out) * 4 bytes, so they are bound by the fp32 CUDA-core rate
// (67 TFLOP/s), not by memory.  The DAC runs in fp32 (zonos_tpu/models/dac/codec.py:10-11),
// so this kernel does not use TF32 tensor cores.
//
// Design: an implicit GEMM, M = T (time), N = C_out, K = C_in x k.
// - A CTA computes a TT x TC tile (time steps x output channels) of one batch row with
//   (TT / RT) x (TC / 8) threads.  A thread holds RT x 8 outputs in registers: RT/4 groups
//   of 4 contiguous time steps (4 * kTY apart) by 2 groups of 4 contiguous channels (TC/2
//   apart).  Its operands come from shared memory as 16-byte loads (RT/4 + 2 of them for
//   8 * RT FMAs), and a warp's loads are free of bank conflicts (lanes with the same time
//   group read the same address; neighbouring channel groups are neighbouring 16 bytes).
//   kernels/snake_conv.py conv_plan picks the tile by shape: 128 x 96 (RT 8, 192 threads),
//   64 x 96 (RT 4, 192) or 32 x 96 (RT 4, 96); 96 divides every DAC width (768, 384, 192,
//   96), so no column is masked there.
// - It walks C_in in chunks of 8 channels (32 at k = 1).  A chunk's raw input window (TT +
//   (k-1) * dil rows, the halo included) and its k weight slices [k][kCI][TC] arrive by
//   16-byte cp.async copies, the next chunk's while the current one is multiplied (the
//   weights and the snake'd window double-buffered, one barrier a chunk).  When its raw
//   pieces have landed, each thread applies the snake once per element of the pieces it
//   copied and writes it channel-major, x[c][t], in four copies shifted by 0-3 time steps,
//   so that tap j's operand (shifted by j * dil) is always a 16-byte-aligned load (one
//   copy when every shift is a multiple of 4: k = 1, or a dilation of 4n).  The activated
//   tensor never exists in device memory.  Zero padding at the sequence edges is applied
//   before the snake, which is the same since snake(0) = 0.
// - Shared memory: 4 * (2 * copies * kCI * Wn + kCI * P + 2 * k * kCI * TC) bytes (kCI
//   the chunk's channels), P = TT + (k-1) * dil and Wn = P rounded up to 4: 96 KB at
//   128 x 96, k = 7, dilation 9.  Above 48 KB by the function attribute, up to the card's
//   227 KB, which sets the dilation it takes (kernels/snake_conv.py _refusal).
// - fp32 throughout, sinf (not __sinf: alpha * x is not range-reduced), the sum over C_in
//   and the taps in a fixed order; the residual add is in the epilogue.  Activations keep
//   the JAX package's NWC layout [B, T, C]; weights come in [k, C_in, C_out].  C_in and
//   C_out are multiples of 4 (16-byte rows); other channel counts and T are masked.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCI7 = 8;   // input channels a staged chunk at k > 1 (the k weight slices fill it)
constexpr int kCI1 = 32;  // at k = 1, where a chunk's products are few: fewer, larger chunks
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a block may take on sm_90

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

// The dynamic shared memory of one CTA, in floats: two buffers of the snake'd window's
// copies, the raw window and two weight buffers, for chunks of kCI input channels.
struct Layout {
  int P, Wn, copies, xs, raw, ws;  // window rows, copy stride, copies; section sizes (floats)

  __host__ __device__ Layout(int TT, int TC, int K, int dil, int kCI) {
    P = TT + (K - 1) * dil;
    Wn = round_up(P, 4);
    copies = (K == 1 || dil % 4 == 0) ? 1 : 4;
    xs = copies * kCI * Wn;
    raw = kCI * P;
    ws = K * kCI * TC;
  }
  __host__ __device__ size_t bytes() const {
    return (size_t)(2 * xs + raw + 2 * ws) * sizeof(float);
  }
};

// acc[0..8) += a * (b0, b1): one time step's products with a thread's 8 output channels.
__device__ __forceinline__ void fma4x8(float (&acc)[8], float a, const float4& b0,
                                       const float4& b1) {
  acc[0] = fmaf(a, b0.x, acc[0]);
  acc[1] = fmaf(a, b0.y, acc[1]);
  acc[2] = fmaf(a, b0.z, acc[2]);
  acc[3] = fmaf(a, b0.w, acc[3]);
  acc[4] = fmaf(a, b1.x, acc[4]);
  acc[5] = fmaf(a, b1.y, acc[5]);
  acc[6] = fmaf(a, b1.z, acc[6]);
  acc[7] = fmaf(a, b1.w, acc[7]);
}

__device__ __forceinline__ void copy16(float* dst, const float* src, bool in) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(src),
               "r"(in ? 16 : 0));
}

template <int TT, int TC, int RT>
constexpr int kThreads = (TT / RT) * (TC / 8);  // RT time steps x 8 channels a thread

template <int TT, int TC, int RT, int kCI>
__global__ void __launch_bounds__(kThreads<TT, TC, RT>, 2)
snake_conv1d_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                    const float* __restrict__ w, const float* __restrict__ bias,
                    const float* __restrict__ res, float* __restrict__ y, int T, int Cin,
                    int Cout, int K, int dil) {
  constexpr int kTX = TC / 8;  // threads along the channels
  constexpr int kTY = TT / RT;  // threads along time
  constexpr int kTG = RT / 4;  // groups of 4 time steps a thread
  constexpr int kN = kThreads<TT, TC, RT>;
  static_assert(TC % 8 == 0 && RT % 4 == 0 && TT % RT == 0, "RT x 8 outputs a thread");
  extern __shared__ __align__(16) float smem[];
  const Layout L(TT, TC, K, dil, kCI);
  const int P = L.P, Wn = L.Wn, copies = L.copies, xs_n = L.xs, ws_n = L.ws;
  float* xbuf = smem;              // [2][copies][kCI][Wn]  snake'd window, copy s shifted by s
  float* raw = xbuf + 2 * xs_n;    // [P][kCI]              the chunk's raw window
  float* wbuf = raw + L.raw;       // [2][K][kCI][TC]       weight slices

  const int t0 = blockIdx.x * TT, co0 = blockIdx.y * TC, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int pad = (K - 1) * dil / 2;
  const float* xb = x + (size_t)b * T * Cin;
  const int n_chunks = (Cin + kCI - 1) / kCI;

  // chunk ci0's raw window and weight slices into `ws`, one cp.async group.  A thread
  // copies the same 16-byte pieces of the window (4 channels of one time step) that it
  // later activates, so no barrier sits between the copy's wait and the snake.
  // (the lambdas capture by value: nothing of the kernel's frame escapes to memory)
  auto issue = [=](int ci0, float* ws) {
    for (int i = tid; i < P * (kCI / 4); i += kN) {
      const int c = (i / P) * 4, p = i % P;
      const int t = t0 - pad + p;
      const bool in = t >= 0 && t < T && ci0 + c < Cin;
      copy16(raw + p * kCI + c, in ? xb + (size_t)t * Cin + ci0 + c : xb, in);
    }
    for (int i = tid; i < K * kCI * (TC / 4); i += kN) {
      const int row = i / (TC / 4), o = (i % (TC / 4)) * 4;
      const int j = row / kCI, c = row % kCI;
      const bool in = ci0 + c < Cin && co0 + o < Cout;
      copy16(ws + row * TC + o, in ? w + ((size_t)j * Cin + ci0 + c) * Cout + co0 + o : w, in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // this thread's landed raw pieces -> snake -> the shifted copies in xs, channel-major
  auto activate = [=](int ci0, float* xs) {
    for (int i = tid; i < P * (kCI / 4); i += kN) {
      const int c4 = i / P, p = i % P;  // consecutive threads: consecutive time steps
      const float4 v = *reinterpret_cast<const float4*>(raw + p * kCI + c4 * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c4 * 4 + e, ci = ci0 + c;
        const float xv = e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
        float a = 0.f;
        if (ci < Cin) {
          const float al = __ldg(alpha + ci);
          const float sn = sinf(al * xv);
          a = xv + sn * sn / (al + 1e-9f);
        }
        for (int s = 0; s < copies && s <= p; ++s) xs[(s * kCI + c) * Wn + p - s] = a;
      }
    }
  };

  float acc[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // one barrier a chunk: the next chunk's copies fly while this one is multiplied, then each
  // thread snakes its own landed pieces into the other window buffer
  issue(0, wbuf);
  asm volatile("cp.async.wait_group 0;\n" ::);
  activate(0, xbuf);
  __syncthreads();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const bool more = chunk + 1 < n_chunks;
    if (more) issue((chunk + 1) * kCI, wbuf + ((chunk + 1) & 1) * ws_n);
    const float* xs = xbuf + (chunk & 1) * xs_n;
    const float* ws = wbuf + (chunk & 1) * ws_n + tx * 4;
    for (int j = 0, sh = 0; j < K; ++j, sh += dil) {
      const float* xa = xs + (sh & 3) * kCI * Wn + (sh & ~3) + ty * 4;
      const float* wj = ws + j * kCI * TC;
#pragma unroll
      for (int c = 0; c < kCI; ++c) {
        // the operands stay float4 values (registers): no array of them is addressed
        float4 a4[kTG];
#pragma unroll
        for (int g = 0; g < kTG; ++g)
          a4[g] = *reinterpret_cast<const float4*>(xa + c * Wn + g * 4 * kTY);
        const float4 b0 = *reinterpret_cast<const float4*>(wj + c * TC);
        const float4 b1 = *reinterpret_cast<const float4*>(wj + c * TC + TC / 2);
#pragma unroll
        for (int g = 0; g < kTG; ++g) {
          fma4x8(acc[4 * g], a4[g].x, b0, b1);
          fma4x8(acc[4 * g + 1], a4[g].y, b0, b1);
          fma4x8(acc[4 * g + 2], a4[g].z, b0, b1);
          fma4x8(acc[4 * g + 3], a4[g].w, b0, b1);
        }
      }
    }
    if (more) {
      asm volatile("cp.async.wait_group 0;\n" ::);
      activate((chunk + 1) * kCI, xbuf + ((chunk + 1) & 1) * xs_n);
    }
    __syncthreads();  // the next window and weights are complete; this chunk's are free
  }

  // epilogue: bias (and residual), 16-byte stores
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int co = co0 + tx * 4 + h * (TC / 2);
    if (co >= Cout) continue;
    const float4 bv = *reinterpret_cast<const float4*>(bias + co);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int t = t0 + ty * 4 + (i / 4) * 4 * kTY + i % 4;
      if (t >= T) continue;
      const size_t o = ((size_t)b * T + t) * Cout + co;
      float4 out = {acc[i][4 * h] + bv.x, acc[i][4 * h + 1] + bv.y, acc[i][4 * h + 2] + bv.z,
                    acc[i][4 * h + 3] + bv.w};
      if (res != nullptr) {
        const float4 r = *reinterpret_cast<const float4*>(res + o);
        out.x += r.x;
        out.y += r.y;
        out.z += r.z;
        out.w += r.w;
      }
      *reinterpret_cast<float4*>(y + o) = out;
    }
  }
}

template <int TT, int TC, int RT, int kCI>
int launch_chunked(const float* x, const float* alpha, const float* w, const float* bias,
                   const float* res, float* y, int B, int T, int Cin, int Cout, int K, int dil,
                   cudaStream_t stream) {
  const size_t smem = Layout(TT, TC, K, dil, kCI).bytes();
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  static const cudaError_t attr =
      cudaFuncSetAttribute(snake_conv1d_kernel<TT, TC, RT, kCI>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((T + TT - 1) / TT, (Cout + TC - 1) / TC, B);
  snake_conv1d_kernel<TT, TC, RT, kCI><<<grid, kThreads<TT, TC, RT>, smem, stream>>>(
      x, alpha, w, bias, res, y, T, Cin, Cout, K, dil);
  return cudaGetLastError();
}

template <int TT, int TC, int RT>
int launch(const float* x, const float* alpha, const float* w, const float* bias,
           const float* res, float* y, int B, int T, int Cin, int Cout, int K, int dil,
           cudaStream_t stream) {
  return K == 1 ? launch_chunked<TT, TC, RT, kCI1>(x, alpha, w, bias, res, y, B, T, Cin, Cout,
                                                   K, dil, stream)
                : launch_chunked<TT, TC, RT, kCI7>(x, alpha, w, bias, res, y, B, T, Cin, Cout,
                                                   K, dil, stream);
}

}  // namespace

// x [B, T, C_in], w [K, C_in, C_out], alpha [C_in], bias [C_out], res/y [B, T, C_out]:
// fp32, contiguous, 16-byte aligned, C_in and C_out multiples of 4.  res may be null.  K
// odd; 'same' padding (K-1)*dil/2 on both sides.  tile: 0 = 128 x 96 (192 threads of 8 x 8),
// 1 = 64 x 96 (192 of 4 x 8), 2 = 32 x 96 (96 of 4 x 8), as kernels/snake_conv.py TILES
// lists them.
extern "C" int zt_snake_conv1d(const void* x, const void* alpha, const void* w, const void* bias,
                               const void* res, void* y, int B, int T, int Cin, int Cout, int K,
                               int dil, int tile, void* stream) {
  if (Cin % 4 || Cout % 4 || K % 2 == 0 || dil < 1) return cudaErrorInvalidValue;
  const float *xf = static_cast<const float*>(x), *af = static_cast<const float*>(alpha),
              *wf = static_cast<const float*>(w), *bf = static_cast<const float*>(bias),
              *rf = static_cast<const float*>(res);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch<128, 96, 8>(xf, af, wf, bf, rf, yf, B, T, Cin, Cout, K, dil, st);
    case 1: return launch<64, 96, 4>(xf, af, wf, bf, rf, yf, B, T, Cin, Cout, K, dil, st);
    case 2: return launch<32, 96, 4>(xf, af, wf, bf, rf, yf, B, T, Cin, Cout, K, dil, st);
    default: return cudaErrorInvalidValue;
  }
}
