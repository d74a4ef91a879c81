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
// scratch, batching heads into block-diagonal [T*Q, T*Q] dots to fill the 128-wide MXU, and
// builds the cumsum as a triangular matmul.  None of that binds here.
//
// What bounds it on an H100: the function needs at least the recurrent form's work, 4 flops
// per state element per step (y = C.h and h' = h dA + dt x B^T), 4*L*P*N per (row, head);
// the bytes are one read of x/dt/B/C and the init state and one write of y and the final
// state.  The bound is max(bytes / 3.35 TB/s, flops / 67 TFLOP/s fp32): at P = 64, N = 128
// bytes below about 60 steps (the [P, N] states dominate), operations above.  The chunked
// form does more than that minimum: per (chunk, head) the causal halves of C.B^T and of
// W @ x, Q(Q+1)/2 * 2(N + P), on top of the 4*Q*P*N of the inter-chunk product and the
// state update.  This version runs on the CUDA cores in fp32; tensor cores (TF32 or bf16
// mma) are later work.
//
// Design: one CTA per (row, head); a loop over chunks takes the place of the TPU's
// sequential grid axis, and the fp32 [P, N] state stays in shared memory across chunks.  Each
// chunk stages x [Q, P], the head's group's B and C [Q, N] and dt [Q] in dynamic shared
// memory (136 KB in all, above the 48 KB default), takes the cumulative log-decay with a warp
// scan, forms C.B^T, and takes exp(s_i - s_j) only for j <= i (the masked half would
// overflow).  Every product is a register-tiled fp32 loop over shared memory; the B, C and
// state rows are padded to N + 4 floats so the 16-byte reads of eight neighbouring rows fall
// in distinct banks.  The D skip is fused into the y store.  At batch 1 with CFG the
// flagship's 2 x 64 (row, head) pairs are 128 CTAs on 132 SMs.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;           // chunk length
constexpr int kThreads = 256;
constexpr int kMaxP = 64;        // headdim bound of the shared-memory layout
constexpr int kMaxN = 128;       // d_state bound
constexpr int kNS = kMaxN + 4;   // row stride of B, C and the state
constexpr int kWS = kQ + 16;     // row stride of the intra-chunk weights W
constexpr int kSmemFloats = kMaxP * kNS + 2 * kQ * kNS + kQ * kMaxP + kQ * kWS + 4 * kQ;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_chunked_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ D,
                   const float* __restrict__ init, float* __restrict__ y,
                   float* __restrict__ fstate, int L, int H, int G, int P, int N) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [kMaxP][kNS] running state
  float* bs = hs + kMaxP * kNS;                 // [kQ][kNS]
  float* cs = bs + kQ * kNS;                    // [kQ][kNS]
  float* xs = cs + kQ * kNS;                    // [kQ][kMaxP]
  float* ws = xs + kQ * kMaxP;                  // [kQ][kWS] masked C.B^T * decay * dt
  float* ss = ws + kQ * kWS;                    // [kQ] s_i
  float* dts = ss + kQ;                         // [kQ] dt_i
  float* es = dts + kQ;                         // [kQ] exp(s_i)
  float* wd = es + kQ;                          // [kQ] dt_j * exp(s_last - s_j)

  const int bh = blockIdx.x, b = bh / H, h = bh % H, g = h / (H / G);
  const int tid = threadIdx.x;
  const float a_h = A[h], d_h = D[h];
  const int P4 = P / 4, N4 = N / 4;

  for (int idx = tid; idx < P * N4; idx += kThreads) {
    const int p = idx / N4, q = idx % N4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (init != nullptr)
      v = *reinterpret_cast<const float4*>(init + ((size_t)bh * P + p) * N + 4 * q);
    *reinterpret_cast<float4*>(hs + p * kNS + 4 * q) = v;
  }

  const int n_chunks = (L + kQ - 1) / kQ;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kQ, valid = min(kQ, L - t0);
    __syncthreads();  // the previous chunk is done with xs / bs / cs (and hs is written)

    // ---- stage the chunk (rows past `valid` are zeros) ----
    for (int idx = tid; idx < kQ * P4; idx += kThreads) {
      const int i = idx / P4, q = idx % P4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < valid)
        v = *reinterpret_cast<const float4*>(x + (((size_t)b * L + t0 + i) * H + h) * P + 4 * q);
      *reinterpret_cast<float4*>(xs + i * kMaxP + 4 * q) = v;
    }
    for (int idx = tid; idx < kQ * N4; idx += kThreads) {
      const int i = idx / N4, q = idx % N4;
      float4 vb = make_float4(0.f, 0.f, 0.f, 0.f), vc = vb;
      if (i < valid) {
        const size_t off = (((size_t)b * L + t0 + i) * G + g) * N + 4 * q;
        vb = *reinterpret_cast<const float4*>(Bm + off);
        vc = *reinterpret_cast<const float4*>(Cm + off);
      }
      *reinterpret_cast<float4*>(bs + i * kNS + 4 * q) = vb;
      *reinterpret_cast<float4*>(cs + i * kNS + 4 * q) = vc;
    }
    if (tid < kQ) dts[tid] = tid < valid ? dt[((size_t)b * L + t0 + tid) * H + h] : 0.f;
    __syncthreads();

    // ---- cumulative log-decay: warp 0, two steps per lane, inclusive warp scan ----
    if (tid < 32) {
      const float d0 = dts[2 * tid] * a_h, d1 = dts[2 * tid + 1] * a_h;
      float v = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += u;
      }
      float before = __shfl_up_sync(0xffffffffu, v, 1);
      if (tid == 0) before = 0.f;
      const float s0 = before + d0, s1 = s0 + d1;
      const float s_last = __shfl_sync(0xffffffffu, s1, 31);
      ss[2 * tid] = s0;
      ss[2 * tid + 1] = s1;
      es[2 * tid] = expf(s0);
      es[2 * tid + 1] = expf(s1);
      wd[2 * tid] = dts[2 * tid] * expf(s_last - s0);
      wd[2 * tid + 1] = dts[2 * tid + 1] * expf(s_last - s1);
    }
    __syncthreads();

    // ---- W[i][j] = (C_i . B_j) exp(s_i - s_j) dt_j for j <= i, else 0 ----
    {
      const int ti = tid / 16, tj = tid % 16;
      float acc[4][4] = {};
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cv[u] = *reinterpret_cast<const float4*>(cs + (ti + 16 * u) * kNS + n);
          bv[u] = *reinterpret_cast<const float4*>(bs + (tj + 16 * u) * kNS + n);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = dot4(cv[u], bv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = ti + 16 * u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = tj + 16 * v;
          ws[i * kWS + j] = j <= i ? acc[u][v] * expf(ss[i] - ss[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y_i = W[i] @ x + exp(s_i) C_i . h + D x_i, rows i = ti + 16u, cols p = tp + 16v ----
    {
      const int ti = tid / 16, tp = tid % 16;
      float intra[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < kQ; j += 4) {
        float4 wv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          wv[u] = *reinterpret_cast<const float4*>(ws + (ti + 16 * u) * kWS + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float xv[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) xv[v] = xs[(j + jj) * kMaxP + tp + 16 * v];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float w = jj == 0 ? wv[u].x : jj == 1 ? wv[u].y : jj == 2 ? wv[u].z : wv[u].w;
#pragma unroll
            for (int v = 0; v < 4; ++v) intra[u][v] = fmaf(w, xv[v], intra[u][v]);
          }
        }
      }
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], hv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cv[u] = *reinterpret_cast<const float4*>(cs + (ti + 16 * u) * kNS + n);
          hv[u] = *reinterpret_cast<const float4*>(hs + (tp + 16 * u) * kNS + n);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) inter[u][v] = dot4(cv[u], hv[v], inter[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = ti + 16 * u;
        if (i >= valid) continue;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int p = tp + 16 * v;
          if (p >= P) continue;
          const float out = intra[u][v] + es[i] * inter[u][v];
          y[(((size_t)b * L + t0 + i) * H + h) * P + p] = out + xs[i * kMaxP + p] * d_h;
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // ---- h[p][n] = h exp(s_last) + sum_j x[j][p] wd[j] B[j][n]: rows p = warp + 8u ----
    {
      const int warp = tid / 32, lane = tid % 32;
      if (4 * lane < N) {
        const float decay = expf(ss[kQ - 1]);
        float4 acc[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < kQ; ++j) {
          const float4 bv = *reinterpret_cast<const float4*>(bs + j * kNS + 4 * lane);
          const float wj = wd[j];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const float xw = xs[j * kMaxP + warp + 8 * u] * wj;
            acc[u].x = fmaf(xw, bv.x, acc[u].x);
            acc[u].y = fmaf(xw, bv.y, acc[u].y);
            acc[u].z = fmaf(xw, bv.z, acc[u].z);
            acc[u].w = fmaf(xw, bv.w, acc[u].w);
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int p = warp + 8 * u;
          if (p >= P) continue;
          float4* hp = reinterpret_cast<float4*>(hs + p * kNS + 4 * lane);
          float4 hv = *hp;
          hv.x = hv.x * decay + acc[u].x;
          hv.y = hv.y * decay + acc[u].y;
          hv.z = hv.z * decay + acc[u].z;
          hv.w = hv.w * decay + acc[u].w;
          *hp = hv;
        }
      }
    }
  }
  __syncthreads();

  for (int idx = tid; idx < P * N4; idx += kThreads) {
    const int p = idx / N4, q = idx % N4;
    *reinterpret_cast<float4*>(fstate + ((size_t)bh * P + p) * N + 4 * q) =
        *reinterpret_cast<const float4*>(hs + p * kNS + 4 * q);
  }
}

}  // namespace

// Shapes as in the header comment; init may be null.  Needs P % 4 == 0, P <= 64,
// N % 4 == 0, N <= 128, H % G == 0, 16-byte-aligned pointers.
extern "C" int zt_ssd_chunked(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* D, const void* init, void* y,
                              void* fstate, int B, int L, int H, int G, int P, int N,
                              void* stream) {
  if (P % 4 || P > kMaxP || N % 4 || N > kMaxN || G < 1 || H % G || L < 1)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)kSmemFloats * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  ssd_chunked_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(init), static_cast<float*>(y), static_cast<float*>(fstate), L,
      H, G, P, N);
  return cudaGetLastError();
}
