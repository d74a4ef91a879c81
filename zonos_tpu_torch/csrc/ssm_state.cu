// K7: Mamba2 decode-state step, for Hopper (sm_90a).  Per (batch * head) row bh, over the
// stored state s [P, N] (fp32, bf16 or float8 e4m3):
//   y[p]     = sum_n s[p][n] * C[n]                 (from the OLD state)
//   s'[p][n] = s[p][n] * dA + xdt[p] * B[n]         (fp32, stored back in place)
// Storing to f8 saturates to +-448 (the JAX package clips to +-448 before its cast, since
// e4m3 has no infinity).  The fp32 update is rounded as the plain version rounds it: each
// product, then the sum (no fused multiply-add), so the stored state equals the plain
// version's bit for bit when both round to the storage type the same way.
//
// Replaces the Pallas TPU kernel zonos_tpu/ops/pallas_state.py fused_state_step (:49; body
// _kernel :35), the fused form of zonos_tpu/ops/ssm.py ssd_decode_step (:218-226).  On the
// TPU XLA's multi-output fusion already shared the state read, so the Pallas kernel stayed
// opt-in; eager PyTorch on the card has no such fusion, and written as plain ops the step
// reads the state twice and writes and re-reads two state-sized temporaries.
//
// What bounds it on an H100: bytes.  It does 4 flops per state element against at least
// 2 * sizeof(storage) bytes of state traffic; at batch 1 with CFG (BH 128, P 64, N 128,
// fp32) one call moves 8.4 MB, ~2.5 us at 3.35 TB/s; at batch 8 with CFG in f8 (BH 1024)
// 16.8 MB, ~5 us.
//
// Design: one CTA of 8 warps per bh row.  Each lane owns one 16-byte slice of a state row (4
// fp32, 8 bf16 or 16 f8 values), so a warp reads 1, 2 or 4 whole rows per pass with
// coalesced 16-byte loads; the lane's slices of C and B are read once into registers (no
// shared memory is needed: every row of the state meets the same slice).  y[p] is a
// warp-shuffle reduction over the lanes of a row.  Each warp first loads up to four passes
// of rows, then computes and stores them, so several 16-byte loads per lane are in flight
// before the first in-place store.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // row passes loaded before the first store

template <typename T>
struct Vec;  // 16 bytes of T <-> floats

template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ static void load(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void load(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(h[k]);
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
  __device__ static uint4 store(const float* f) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return r;
  }
};

template <>
struct Vec<__nv_fp8_e4m3> {
  static constexpr int E = 16;
  __device__ static void load(const uint4& r, float* f) {
    const uint8_t* q = reinterpret_cast<const uint8_t*>(&r);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      __nv_fp8_e4m3 v;
      v.__x = q[k];
      f[k] = static_cast<float>(v);
    }
  }
  __device__ static uint4 store(const float* f) {
    uint4 r;
    uint8_t* q = reinterpret_cast<uint8_t*>(&r);
#pragma unroll
    for (int k = 0; k < 16; ++k) q[k] = __nv_cvt_float_to_fp8(f[k], __NV_SATFINITE, __NV_E4M3);
    return r;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
state_step_kernel(T* state, const float* __restrict__ C, const float* __restrict__ B,
                  const float* __restrict__ dA, const float* __restrict__ xdt,
                  float* __restrict__ y, int P, int N) {
  constexpr int E = Vec<T>::E;
  const int lanes_per_row = N / E;              // a power of two, at most 32
  const int rows_per_pass = 32 / lanes_per_row;
  const int bh = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = kThreads / 32;
  const int seg = lane / lanes_per_row, n0 = (lane % lanes_per_row) * E;

  float c[E], b[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    c[e] = C[(size_t)bh * N + n0 + e];
    b[e] = B[(size_t)bh * N + n0 + e];
  }
  const float da = dA[bh];
  T* rows = state + (size_t)bh * P * N;
  const int stride = n_warps * rows_per_pass;

  for (int base = warp * rows_per_pass; base < P; base += kUnroll * stride) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * stride + seg;
      raw[u] = p < P ? *reinterpret_cast<const uint4*>(rows + (size_t)p * N + n0)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * stride + seg;
      float s[E];
      Vec<T>::load(raw[u], s);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part = fmaf(s[e], c[e], part);
      for (int off = lanes_per_row / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (p < P) {
        const float xv = xdt[(size_t)bh * P + p];
        float ns[E];
#pragma unroll
        for (int e = 0; e < E; ++e) ns[e] = __fadd_rn(__fmul_rn(s[e], da), __fmul_rn(xv, b[e]));
        *reinterpret_cast<uint4*>(rows + (size_t)p * N + n0) = Vec<T>::store(ns);
        if (n0 == 0) y[(size_t)bh * P + p] = part;
      }
    }
  }
}

template <typename T>
int launch(void* state, const void* C, const void* B, const void* dA, const void* xdt, void* y,
           int BH, int P, int N, cudaStream_t stream) {
  constexpr int E = Vec<T>::E;
  const int lanes = N / E;
  if (N % E || lanes < 1 || lanes > 32 || (lanes & (lanes - 1))) return cudaErrorInvalidValue;
  state_step_kernel<T><<<BH, kThreads, 0, stream>>>(
      static_cast<T*>(state), static_cast<const float*>(C), static_cast<const float*>(B),
      static_cast<const float*>(dA), static_cast<const float*>(xdt), static_cast<float*>(y), P,
      N);
  return cudaGetLastError();
}

}  // namespace

// state [BH, P, N] (dtype 0 fp32, 1 bf16, 2 f8 e4m3), updated in place; C, B [BH, N],
// dA [BH], xdt [BH, P], y [BH, P]: fp32, contiguous, 16-byte-aligned state.  N * sizeof / 16
// must be a power of two no larger than 32 (N = 128 in every storage type).
extern "C" int zt_ssm_state_step(void* state, const void* C, const void* B, const void* dA,
                                 const void* xdt, void* y, int BH, int P, int N, int dtype,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(state, C, B, dA, xdt, y, BH, P, N, s);
    case 1: return launch<__nv_bfloat16>(state, C, B, dA, xdt, y, BH, P, N, s);
    case 2: return launch<__nv_fp8_e4m3>(state, C, B, dA, xdt, y, BH, P, N, s);
    default: return cudaErrorInvalidValue;
  }
}
