// A row's LayerNorm / RMSNorm statistics and normalised values, the one definition shared by
// N1 (csrc/row_norm.cu) and the products that normalise x as they stage it (G1 csrc/gemm.cu,
// K8 csrc/int4_matmul.cu).  A norm computed by N1 and written out, then read by a product,
// and the same norm computed inside the product give the same bits, because both run this
// code: the same summation order and the same roundings.
//
// The order, fixed by the row's width d alone: one warp a row; lane l keeps 8 partial sums,
// partial i adding the elements l * 8 + i, l * 8 + i + 256, l * 8 + i + 512, ... in increasing
// order (8 elements a lane a step whatever the dtype: 8 short chains rather than one long
// one); a lane's 8 partials meet as ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)), and the
// 32 lanes' sums by a butterfly of shuffles (xor 16, 8, 4, 2, 1), which leaves every lane the
// same total.  LayerNorm: mean = sum(v) / d, then the squared deviations summed the same way
// (a second pass over the row), r = rsqrt(sum / d + eps).  RMSNorm: mean = 0, r = rsqrt(sum(v^2)
// / d + eps).  An element's value is ((v - mean) * r) * scale (+ bias).
//
// Every operation is written with its rounding (__fadd_rn, __fmul_rn, __fsub_rn, __fdiv_rn),
// so nvcc contracts none of them into an FMA: an FMA it chose in one kernel and not in another
// would round the same formula two ways.
//
// Needs d % 8 == 0 and 16-byte aligned rows (bf16 or fp32), bf16 scale and bias.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace row_stats {

constexpr int kVec = 8;              // elements a lane takes at a time
constexpr int kWarpStep = 32 * kVec;  // elements a warp takes at a time

// 8 elements at p (16-byte aligned), widened to fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// 8 values rounded to bf16 (to nearest even), as one 16-byte word.
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&b);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = pack8(v);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The warp's total of one value a lane: a butterfly, the same total in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One step of a pass over R rows: each row's 8 elements at c, element i handed to
// add(r, i, v).
template <int R, typename T, typename Add>
__device__ __forceinline__ void step(const T* const (&row)[R], int c, Add& add) {
  float v[R][kVec];
#pragma unroll
  for (int r = 0; r < R; ++r) load8(row[r] + c, v[r]);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < kVec; ++i) add(r, i, v[r][i]);
}

// A pass of the calling warp over R rows in each lane's order, U steps unrolled so that their
// loads are in flight at once (U R 8 values a lane in registers; U moves no bit).
template <int R, int U, typename T, typename Add>
__device__ __forceinline__ void pass(const T* const (&row)[R], int d, Add add) {
  const int first = (threadIdx.x & 31) * kVec;
  if constexpr (U >= 8) {
#pragma unroll 8
    for (int c = first; c < d; c += kWarpStep) step<R>(row, c, add);
  } else if constexpr (U == 4) {
#pragma unroll 4
    for (int c = first; c < d; c += kWarpStep) step<R>(row, c, add);
  } else if constexpr (U == 2) {
#pragma unroll 2
    for (int c = first; c < d; c += kWarpStep) step<R>(row, c, add);
  } else {
#pragma unroll 1
    for (int c = first; c < d; c += kWarpStep) step<R>(row, c, add);
  }
}

// ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)).
__device__ __forceinline__ float lane_total(const float (&p)[kVec]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3])),
                   __fadd_rn(__fadd_rn(p[4], p[5]), __fadd_rn(p[6], p[7])));
}

// (mean, r) of each of the R rows at row[0..R-1] (d elements each), computed by the calling
// warp, all 32 lanes, U steps of a pass in flight at once (by default 8 / R).  Each row's
// statistics come out the same whatever R and U are: they only set how many loads the warp
// keeps in flight (and so its registers).  LayerNorm reads each row twice (the second time from
// L1).
template <int R, int U = (R >= 8 ? 1 : 8 / R), typename T>
__device__ __forceinline__ void stats_rows(const T* const (&row)[R], int d, float eps, bool rms,
                                           float2 (&out)[R]) {
  float s[R][kVec], first[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < kVec; ++i) s[r][i] = 0.f;
  pass<R, U>(row, d, [&](int r, int i, float v) {
    s[r][i] = __fadd_rn(s[r][i], rms ? __fmul_rn(v, v) : v);
  });
#pragma unroll
  for (int r = 0; r < R; ++r)
    first[r] = __fdiv_rn(warp_sum(lane_total(s[r])), static_cast<float>(d));
  if (rms) {
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] = make_float2(0.f, rsqrtf(__fadd_rn(first[r], eps)));
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < kVec; ++i) s[r][i] = 0.f;
  pass<R, U>(row, d, [&](int r, int i, float v) {
    const float dv = __fsub_rn(v, first[r]);
    s[r][i] = __fadd_rn(s[r][i], __fmul_rn(dv, dv));
  });
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float var = __fdiv_rn(warp_sum(lane_total(s[r])), static_cast<float>(d));
    out[r] = make_float2(first[r], rsqrtf(__fadd_rn(var, eps)));
  }
}

// (mean, r) of one row.
template <typename T>
__device__ __forceinline__ float2 stats(const T* row, int d, float eps, bool rms) {
  const T* rows[1] = {row};
  float2 out[1];
  stats_rows<1>(rows, d, eps, rms, out);
  return out[0];
}

// The bf16 scale and bias (bias may be null: zeros) at columns c..c + 7.
__device__ __forceinline__ void load_params(const __nv_bfloat16* scale, const __nv_bfloat16* bias,
                                            int c, float (&sc)[8], float (&b)[8]) {
  load8(scale + c, sc);
  if (bias != nullptr) {
    load8(bias + c, b);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) b[i] = 0.f;
  }
}

// The normalised values of 8 elements v of a row with statistics st, with their columns'
// scale and bias (has_bias false: no addition, so that -0 stays -0 as in the plain version).
__device__ __forceinline__ void normalise8(float (&v)[8], float2 st, const float (&sc)[8],
                                           const float (&b)[8], bool has_bias) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float t = __fmul_rn(__fmul_rn(__fsub_rn(v[i], st.x), st.y), sc[i]);
    v[i] = has_bias ? __fadd_rn(t, b[i]) : t;
  }
}

}  // namespace row_stats
