// K7: Mamba2 decode-state step, for Hopper (sm_90a).  Per (batch * head) row bh, over the
// stored state s [P, N] (fp32, bf16 or float8 e4m3):
//   y[p]     = sum_n s[p][n] * C[n]                 (from the OLD state)
//   s'[p][n] = s[p][n] * dA + xdt[p] * B[n]         (fp32, stored back in place)
//   bc       = sum_n B[n] * C[n]                    (where the caller asks for it)
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
// - B.C (the decode step's y = dA (C.s) + (B.C) xdt + D x takes it beside y): warp 0 of a bh
//   row's first slab, each lane over its slice in increasing n, then the same butterfly as
//   y's over the lanes of a row.  The order is fixed by N and the storage type, never by the
//   number of rows, so a request's B.C is the same bits alone and in any batch (a batched
//   library reduction picks its order by the batch).
// - f8 converts two values an instruction each way.  The load widens an e4m3 pair to an
//   f16 pair (__nv_cvt_fp8x2_to_halfraw2; exact, since every e4m3 value, subnormals
//   included, is an f16 value, and NaN stays NaN), then to fp32.  (An exact integer decode,
//   sign and (byte & 0x7F) << 20 times 2^120, measured slower once it also had to keep
//   e4m3's NaN bytes NaN.)  The store saturates (__nv_cvt_float2_to_fp8x2, SATFINITE: NaN
//   stays NaN, as in the plain version's cast).  bf16 widens by a shift and narrows in pairs.
//
// int8 and int4 storage (zonos_tpu/models/hybrid.py:145-191, XLA ops around the plain step
// there): the stored values are q * scale, one fp32 scale a (row, head).  After the step the
// head is stored again with scale' = max(absmax(s'), 1e-20) * fp32(1/127) (int4: 1/7; XLA
// multiplies by the constant's reciprocal where JAX writes `/ 127.0`) and
// q = clamp(rint(s' / scale'), +-127) (+-7, a true division, rounding half to even); int4 packs
// element 2i in the low nibble and 2i+1 in the high nibble of one byte and reads each back
// with a sign extension.  The absmax spans the whole [P, N] head, so one CTA owns a head
// (quant_step_kernel): each thread holds up to 4 pieces of 16 values (16 bytes in int8, 8 in
// int4) of the new state in registers (two a thread while the CTA has at most 256 threads:
// 256 at the flagship's P 64, N 128), the block reduces the absmax, and every thread
// quantizes and stores its own pieces.  Every thread reads the old scale before the reduction's barrier and
// thread 0 writes the new one after it.  s' is rounded as the plain version rounds it (each
// product, then the sum), so q and the scale equal the plain version's bit for bit.  The
// bytes are ~1/4 (int8) and ~1/8 (int4) of the fp32 state's, and a head is 8 KB or 4 KB at
// the flagship's P 64, N 128: one CTA a head gives 128 CTAs at batch 1 with CFG, less than a
// wave; wgmma, TMA and a split of the head over a cluster are later work.
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

// B.C of one bh row by a whole warp whose lane l holds the slice (l % lanes_per_row) of B and
// C: fmaf over the slice in increasing n, then a butterfly over the lanes of a row; lane 0
// writes it.
template <int E>
__device__ __forceinline__ void bc_of_row(const float (&b)[E], const float (&c)[E],
                                          int lanes_per_row, float* out) {
  float part = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) part = fmaf(b[e], c[e], part);
  for (int off = lanes_per_row / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (threadIdx.x == 0) *out = part;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
state_step_kernel(T* state, const float* __restrict__ C, const float* __restrict__ B,
                  const float* __restrict__ dA, const float* __restrict__ xdt,
                  float* __restrict__ y, float* __restrict__ bc, int P, int N, int rows_per_cta) {
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
  if (bc != nullptr && blockIdx.y == 0 && threadIdx.x < 32)
    bc_of_row(b, c, lanes_per_row, bc + bh);
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
           void* bc, int BH, int P, int N, int rows_per_cta, cudaStream_t stream) {
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
      static_cast<const float*>(dA), static_cast<const float*>(xdt), static_cast<float*>(y),
      static_cast<float*>(bc), P, N, rows_per_cta);
  return cudaGetLastError();
}

constexpr int kQThreads = 256;  // the most a CTA takes; also kernels/ssm_state.py QUANT_THREADS
constexpr int kQPieces = 4;     // pieces of 16 values a thread holds (QUANT_VALUES_PER_THREAD / 16)

template <bool kInt4>
struct QPiece;  // 16 stored values <-> 16 floats

template <>
struct QPiece<false> {  // int8: 16 bytes
  static constexpr int kBytes = 16;
  __device__ static void load(const int8_t* p, float scale, float* f) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int e = 0; e < 16; ++e) f[e] = __fmul_rn(static_cast<float>(b[e]), scale);
  }
  __device__ static void store(int8_t* p, const int* q) {
    uint4 r;
    int8_t* b = reinterpret_cast<int8_t*>(&r);
#pragma unroll
    for (int e = 0; e < 16; ++e) b[e] = static_cast<int8_t>(q[e]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

template <>
struct QPiece<true> {  // int4: 8 bytes, element 2i in the low nibble of byte i
  static constexpr int kBytes = 8;
  __device__ static void load(const int8_t* p, float scale, float* f) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int v = b[k];
      f[2 * k] = __fmul_rn(static_cast<float>(((v & 15) ^ 8) - 8), scale);  // sign-extended
      f[2 * k + 1] = __fmul_rn(static_cast<float>(v >> 4), scale);
    }
  }
  __device__ static void store(int8_t* p, const int* q) {
    uint2 r;
    int8_t* b = reinterpret_cast<int8_t*>(&r);
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = static_cast<int8_t>((q[2 * k] & 0x0F) | (q[2 * k + 1] << 4));
    *reinterpret_cast<uint2*>(p) = r;
  }
};

template <bool kInt4>
__global__ void __launch_bounds__(kQThreads)
quant_step_kernel(int8_t* state, float* scale, const float* __restrict__ C,
                  const float* __restrict__ B, const float* __restrict__ dA,
                  const float* __restrict__ xdt, float* __restrict__ y, float* __restrict__ bc,
                  int P, int N) {
  using Piece = QPiece<kInt4>;
  constexpr float kLimit = kInt4 ? 7.f : 127.f;
  constexpr float kInvLimit = kInt4 ? 1.f / 7.f : 1.f / 127.f;  // rounded to fp32, as XLA's
  __shared__ float warp_max[kQThreads / 32];

  const int bh = blockIdx.x;
  const int lanes_per_row = N / 16;  // a power of two, at most 32: a row's lanes share a warp
  const int pieces = P * lanes_per_row;
  const int n0 = (threadIdx.x % lanes_per_row) * 16;  // the same in every piece of this thread
  int8_t* head = state + (size_t)bh * pieces * Piece::kBytes;
  const float old_scale = scale[bh];
  float c[16], b[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    c[e] = C[(size_t)bh * N + n0 + e];
    b[e] = B[(size_t)bh * N + n0 + e];
  }
  const float da = dA[bh];
  if (bc != nullptr && threadIdx.x < 32) bc_of_row(b, c, lanes_per_row, bc + bh);

  const int threads = blockDim.x;  // a multiple of 32, enough for kQPieces pieces each
  float ns[kQPieces][16];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kQPieces; ++j) {
    if (j * threads >= pieces) continue;  // the same in every thread of the block
    const int i = j * threads + threadIdx.x;
    const bool live = i < pieces;  // a dead lane still takes part in the shuffle
    float s[16];
    if (live) {
      Piece::load(head + (size_t)i * Piece::kBytes, old_scale, s);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = 0.f;
    }
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) part = fmaf(s[e], c[e], part);
    for (int off = lanes_per_row / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    const int r = i / lanes_per_row;
    const float xv = live ? xdt[(size_t)bh * P + r] : 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      ns[j][e] = __fadd_rn(__fmul_rn(s[e], da), __fmul_rn(xv, b[e]));
      if (live) amax = fmaxf(amax, fabsf(ns[j][e]));
    }
    if (live && n0 == 0) y[(size_t)bh * P + r] = part;
  }

  // the head's absmax: a warp's, then the block's
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();  // also orders every thread's read of the old scale before the write below
  amax = warp_max[0];
  for (int w = 1; w < threads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float new_scale = __fmul_rn(fmaxf(amax, 1e-20f), kInvLimit);
  if (threadIdx.x == 0) scale[bh] = new_scale;

#pragma unroll
  for (int j = 0; j < kQPieces; ++j) {
    const int i = j * threads + threadIdx.x;
    if (i < pieces) {
      int q[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        q[e] = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(ns[j][e], new_scale)), -kLimit), kLimit));
      Piece::store(head + (size_t)i * Piece::kBytes, q);
    }
  }
}

template <bool kInt4>
int launch_quant(void* state, void* scale, const void* C, const void* B, const void* dA,
                 const void* xdt, void* y, void* bc, int BH, int P, int N, cudaStream_t stream) {
  const int lanes = N / 16;
  if (N % 16 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || P < 1 ||
      P * N > kQThreads * kQPieces * 16)
    return cudaErrorInvalidValue;
  // two pieces a thread, in whole warps, up to kQThreads (then up to kQPieces a thread): at
  // the flagship's 512 pieces 256 threads (on an H100 at 700 W, 7.2 us at BH 128 against
  // 10.5 with 128 threads of four pieces, 25.5 against 24.0 at BH 1024; PERF.md)
  const int pieces = P * lanes;
  const int threads = min(kQThreads, ((pieces + 1) / 2 + 31) / 32 * 32);
  quant_step_kernel<kInt4><<<BH, threads, 0, stream>>>(
      static_cast<int8_t*>(state), static_cast<float*>(scale), static_cast<const float*>(C),
      static_cast<const float*>(B), static_cast<const float*>(dA),
      static_cast<const float*>(xdt), static_cast<float*>(y), static_cast<float*>(bc), P, N);
  return cudaGetLastError();
}

}  // namespace

// state [BH, P, N] (dtype 0 fp32, 1 bf16, 2 f8 e4m3), updated in place; C, B [BH, N],
// dA [BH], xdt [BH, P], y [BH, P], bc [BH] (null: not computed): fp32, contiguous,
// 16-byte-aligned state.  N * sizeof / 16
// must be a power of two no larger than 32 (N = 128 in every storage type); rows_per_cta
// rows of N make at most 32 KB, and ceil(P / rows_per_cta) <= 65535 (kernels/ssm_state.py
// slab_plan).
extern "C" int zt_ssm_state_step(void* state, const void* C, const void* B, const void* dA,
                                 const void* xdt, void* y, void* bc, int BH, int P, int N,
                                 int dtype, int rows_per_cta, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(state, C, B, dA, xdt, y, bc, BH, P, N, rows_per_cta, s);
    case 1:
      return launch<__nv_bfloat16>(state, C, B, dA, xdt, y, bc, BH, P, N, rows_per_cta, s);
    case 2: return launch<__nv_fp8_e4m3>(state, C, B, dA, xdt, y, bc, BH, P, N, rows_per_cta, s);
    default: return cudaErrorInvalidValue;
  }
}

// state int8 [BH, P, N] (int4 != 0: [BH, P, N / 2], two values a byte) and scale [BH] fp32,
// both updated in place; C, B [BH, N], dA [BH], xdt [BH, P], y [BH, P], bc [BH] (null: not
// computed): fp32, contiguous, 16-byte-aligned state.  N / 16 must be a power of two no larger than 32, and P * N at most
// 16,384 (kernels/ssm_state.py _quant_refusal).
extern "C" int zt_ssm_state_step_quant(void* state, void* scale, const void* C, const void* B,
                                       const void* dA, const void* xdt, void* y, void* bc,
                                       int BH, int P, int N, int int4, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int4 ? launch_quant<true>(state, scale, C, B, dA, xdt, y, bc, BH, P, N, s)
              : launch_quant<false>(state, scale, C, B, dA, xdt, y, bc, BH, P, N, s);
}
