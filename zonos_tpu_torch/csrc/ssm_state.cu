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
// Design:
// - The launch plan (kernels/ssm_state.py slab_plan) cuts each bh row's P rows into slabs of
//   `rows` state rows, one CTA each: grid (BH, ceil(P / rows)), bh on grid.x, which takes up
//   to 2^31 - 1 (grid.y stops at 65535: batch 512 with CFG on the hybrid has 65536 bh rows).
//   A slab is one contiguous run of bytes, and slabs are small enough that the grid holds
//   several CTAs per SM.
// - One thread asks for the whole slab with one TMA bulk copy
//   (cp.async.bulk global -> shared, completing on an mbarrier) before any value is used, so
//   every byte of every resident CTA is in flight at once: one HBM round trip, not two.  The
//   threads load their C, B and dA into registers, and the slab's xdt into shared memory,
//   while it lands, so no load waits inside the loop over the slab.
// - Each lane owns one 16-byte slice of a state row (4 fp32, 8 bf16 or 16 f8 values), the
//   same slice in every row it visits, so its slices of C and B stay in registers.  y[p] is
//   a warp-shuffle reduction over the lanes of a row (no cross-CTA sum: a row never spans
//   two CTAs).  The new values go back into the slab in shared memory, and one thread
//   stores the slab with one bulk copy (shared -> global) after fence.proxy.async.
// - f8 converts two values an instruction each way.  The load widens an e4m3 pair to an
//   f16 pair (__nv_cvt_fp8x2_to_halfraw2; exact, since every e4m3 value, subnormals
//   included, is an f16 value, and NaN stays NaN), then to fp32.  (An exact integer decode,
//   sign and (byte & 0x7F) << 20 times 2^120, measured slower once it also had to keep
//   e4m3's NaN bytes NaN.)  The store saturates (__nv_cvt_float2_to_fp8x2, SATFINITE: NaN
//   stays NaN, as in the plain version's cast).  bf16 widens by a shift and narrows in pairs.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSlabBytes = 32 * 1024;  // also kernels/ssm_state.py MAX_SLAB_BYTES

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
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // a bf16 is the top half of its fp32
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
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
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>((w[k / 2] >> (16 * (k % 2))) & 0xFFFFu), __NV_E4M3);
      const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&h));
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
  __device__ static uint4 store(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo =
          __nv_cvt_float2_to_fp8x2(make_float2(f[4 * k], f[4 * k + 1]), __NV_SATFINITE, __NV_E4M3);
      const uint32_t hi = __nv_cvt_float2_to_fp8x2(make_float2(f[4 * k + 2], f[4 * k + 3]),
                                                   __NV_SATFINITE, __NV_E4M3);
      w[k] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
state_step_kernel(T* state, const float* __restrict__ C, const float* __restrict__ B,
                  const float* __restrict__ dA, const float* __restrict__ xdt,
                  float* __restrict__ y, int P, int N, int rows_per_cta) {
  constexpr int E = Vec<T>::E;
  extern __shared__ __align__(128) uint4 slab[];  // the slab, then xdt of its rows
  __shared__ __align__(8) uint64_t landed;

  const int bh = blockIdx.x, p0 = blockIdx.y * rows_per_cta;
  const int rows = min(rows_per_cta, P - p0);
  const int lanes_per_row = N / E;  // a power of two, at most 32
  const int pieces = rows * lanes_per_row;  // 16-byte slices in the slab
  const unsigned bytes = static_cast<unsigned>(pieces) * 16u;
  T* gslab = state + ((size_t)bh * P + p0) * N;
  const uint32_t bar = smem_addr(&landed);

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(slab)),
        "l"(gslab), "r"(bytes), "r"(bar)
        : "memory");
  }

  // while the slab lands: this lane's slices of C and B (the same in every row it visits,
  // since kThreads is a multiple of 32 and lanes_per_row divides 32), and dA
  const int n0 = (threadIdx.x % lanes_per_row) * E;
  float c[E], b[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    c[e] = C[(size_t)bh * N + n0 + e];
    b[e] = B[(size_t)bh * N + n0 + e];
  }
  const float da = dA[bh];
  float* xs = reinterpret_cast<float*>(slab + rows_per_cta * lanes_per_row);
  for (int r = threadIdx.x; r < rows; r += kThreads) xs[r] = xdt[(size_t)bh * P + p0 + r];
  __syncthreads();  // the barrier's initialisation and xs are visible before anyone waits

  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }

  // a warp's 32 slices at each step are whole rows; rows past the slab are masked
#pragma unroll 4
  for (int i0 = 0; i0 < pieces; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const int r = i / lanes_per_row;
    float s[E];
    Vec<T>::load(i < pieces ? slab[i] : make_uint4(0u, 0u, 0u, 0u), s);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) part = fmaf(s[e], c[e], part);
    for (int off = lanes_per_row / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (i < pieces) {
      const size_t row = (size_t)bh * P + p0 + r;
      const float xv = xs[r];
      float ns[E];
#pragma unroll
      for (int e = 0; e < E; ++e) ns[e] = __fadd_rn(__fmul_rn(s[e], da), __fmul_rn(xv, b[e]));
      slab[i] = Vec<T>::store(ns);
      if (n0 == 0) y[row] = part;
    }
  }

  // the generic-proxy writes to the slab, made visible to the bulk copy's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gslab),
                 "r"(smem_addr(slab)), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // the slab is read
  }
}

template <typename T>
int launch(void* state, const void* C, const void* B, const void* dA, const void* xdt, void* y,
           int BH, int P, int N, int rows_per_cta, cudaStream_t stream) {
  constexpr int E = Vec<T>::E;
  const int lanes = N / E;
  const int slab_bytes = rows_per_cta * N * (int)sizeof(T);
  if (N % E || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || rows_per_cta < 1 ||
      slab_bytes > kMaxSlabBytes)
    return cudaErrorInvalidValue;
  const int per_bh = (P + rows_per_cta - 1) / rows_per_cta;
  if (per_bh > 65535) return cudaErrorInvalidValue;  // grid.y's limit
  const dim3 grid(BH, per_bh);
  const int smem = slab_bytes + rows_per_cta * (int)sizeof(float);  // the slab, xdt
  state_step_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(state), static_cast<const float*>(C), static_cast<const float*>(B),
      static_cast<const float*>(dA), static_cast<const float*>(xdt), static_cast<float*>(y), P,
      N, rows_per_cta);
  return cudaGetLastError();
}

}  // namespace

// state [BH, P, N] (dtype 0 fp32, 1 bf16, 2 f8 e4m3), updated in place; C, B [BH, N],
// dA [BH], xdt [BH, P], y [BH, P]: fp32, contiguous, 16-byte-aligned state.  N * sizeof / 16
// must be a power of two no larger than 32 (N = 128 in every storage type); rows_per_cta
// rows of N make at most 32 KB, and ceil(P / rows_per_cta) <= 65535 (kernels/ssm_state.py
// slab_plan).
extern "C" int zt_ssm_state_step(void* state, const void* C, const void* B, const void* dA,
                                 const void* xdt, void* y, int BH, int P, int N, int dtype,
                                 int rows_per_cta, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(state, C, B, dA, xdt, y, BH, P, N, rows_per_cta, s);
    case 1: return launch<__nv_bfloat16>(state, C, B, dA, xdt, y, BH, P, N, rows_per_cta, s);
    case 2: return launch<__nv_fp8_e4m3>(state, C, B, dA, xdt, y, BH, P, N, rows_per_cta, s);
    default: return cudaErrorInvalidValue;
  }
}
