// Shared device helpers of the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {
// Internal linkage: every kernel library carries its own copy.
namespace {

constexpr float kInvSqrt2Pi = 0.39894228040143267794f;
constexpr float kNegLog2e = -1.442695022e+00f;
constexpr float kLn2Hi = 6.931471825e-01f;      // ln 2 rounded to float
constexpr float kLn2Lo = -1.904654212e-09f;     // ln 2 - kLn2Hi
constexpr float kSqrt2 = 1.414213538e+00f;
constexpr float kErfcK = 3.0f;                 // erfc_gauss's q = (t - K) / (t + K)

// 2^x by one SFU op (ex2.approx.ftz.f32): no denormal fix-ups, a result
// below 2^-126 is flushed to +0, and -inf gives +0.  Used where a flushed
// term is far below the tolerance of the sum it enters (gh_fused.cu,
// lscv_grid.cu, qmc_reduce.cu, pairwise_reduce.cu, kde_eval.cu, and through
// erfc_gauss aqp_batch.cu, aqp_boxes.cu and aqp_grouped.cu); the build has no global
// -ftz.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1/x by one SFU op (rcp.approx.ftz.f32, within 1 ulp); for x far from 0
// and from the float range's ends.
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// erfc(z / sqrt2) and g = exp(-z^2 / 2) from one exponential and one
// reciprocal (two SFU ops where erfcf and expf take three): g is the
// exponential inside erfc, and the density of eq. 10 up to 1/sqrt(2 pi).
// z^2 / 2 is carried as s_hi + s_lo (exact, by fmaf, as CUDA's own erfcf
// compensates its square) and 2^y's rounding of y = -s_hi log2 e is put
// back as the factor 1 + r, so g keeps its relative precision out to
// |z| ~ 13, where erfcf of the rounded z / sqrt2 loses up to 1e-5.  The
// reduced 2^y never meets a denormal input; a g below 2^-126 (|z| > 13.2,
// erfc below 1.2e-38) is flushed to 0.  |z| is clamped to 16 (where both are
// 0 in float) so no step overflows; a NaN z gives NaN.
__device__ __forceinline__ void erfc_gauss(float z, float& ec, float& g) {
  float t = fabsf(z);
  t = t > 16.0f ? 16.0f : t;
  const float ht = 0.5f * t;
  const float s_hi = ht * t;
  const float s_lo = fmaf(ht, t, -s_hi);
  const float y = s_hi * kNegLog2e;
  float r = fmaf(y, -kLn2Hi, -s_hi);
  r = fmaf(y, -kLn2Lo, r) - s_lo;
  const float e = ex2_ftz(y);
  g = fmaf(e, r, e);
  // one reciprocal gives both 1 / (t + K) and 1 / (1 + sqrt2 t)
  const float den_q = t + kErfcK;
  const float den_p = fmaf(kSqrt2, t, 1.0f);
  const float inv = rcp_approx(den_q * den_p);
  const float q = fmaf(-2.0f * kErfcK, inv * den_p, 1.0f);
  // Shepherd & Laframboise's form (Math. Comp. 36 (1981) 249-253):
  // (1 + sqrt2 t) exp(t^2 / 2) erfc(t / sqrt2) = p(q), q = (t - K) / (t + K),
  // p of degree 9 fitted for t in [0, 16] (relative error 4.1e-8)
  float p = -2.048213792e-04f;
  p = fmaf(p, q, -1.317089656e-03f);
  p = fmaf(p, q, -4.543135874e-04f);
  p = fmaf(p, q, 9.255982935e-03f);
  p = fmaf(p, q, 7.704673917e-04f);
  p = fmaf(p, q, -6.936229020e-02f);
  p = fmaf(p, q, 1.660429388e-01f);
  p = fmaf(p, q, -1.485603303e-01f);
  p = fmaf(p, q, -1.020300165e-01f);
  p = fmaf(p, q, 1.274107933e+00f);
  const float tail = g * (p * (inv * den_q));
  ec = z < 0.0f ? 2.0f - tail : tail;
}

// Phi(zb) - Phi(za) and phi(zb) - phi(za) (eqs. 9-10) from two erfc_gauss.
// The Phi difference is taken from the tail the pair sits in (upper tail
// when the midpoint is positive), where erfc keeps its relative precision,
// without the cancellation of 0.5 * (erf(zb / sqrt2) - erf(za / sqrt2)); the
// identity holds for any sign, so one select picks the operands.  The
// density difference comes from the same two exponentials.
__device__ __forceinline__ void phi_dens_diff(float za, float zb, float& d_Phi,
                                              float& d_phi) {
  const bool upper = za + zb > 0.0f;
  float eu, gu, ev, gv;
  erfc_gauss(upper ? za : -zb, eu, gu);
  erfc_gauss(upper ? zb : -za, ev, gv);
  d_Phi = 0.5f * (eu - ev);
  // g is even: gu is g(za) on the upper branch and g(zb) on the lower
  const float d = kInvSqrt2Pi * (gv - gu);
  d_phi = upper ? d : -d;
}

// Sum over the 32 lanes of a warp, the same tree every call.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Each thread c < width sums column c of a (n_chunks, width) partials array
// in chunk order into out[c] (one fixed order: the same bits run to run).
__global__ void sum_partial_columns(const float* __restrict__ partials,
                                    int n_chunks, int width,
                                    float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  float acc = 0.0f;
  for (int k = 0; k < n_chunks; ++k) acc += partials[(size_t)k * width + c];
  out[c] = acc;
}

// eqs. (49)/(50) in double precision with the +-1 correction of
// repro/kernels/triangle.py: column l holds bx in [l(l+1)/2, (l+1)(l+2)/2).
// Turns a 1-D block index over the upper-triangle tiles into the tile's row
// q and column l (the paper's Fig. 3 schema, Appendix A).
__device__ __forceinline__ bool tri_col_ok(long long l, long long bx) {
  return l >= 0 && l * (l + 1) / 2 <= bx && bx < (l + 1) * (l + 2) / 2;
}

__device__ __forceinline__ void bx_to_ql(long long bx, int* q, int* l) {
  const long long l0 =
      (long long)ceil((sqrt(8.0 * (double)bx + 9.0) - 3.0) * 0.5);
  const long long lc =
      tri_col_ok(l0 - 1, bx) ? l0 - 1 : (tri_col_ok(l0, bx) ? l0 : l0 + 1);
  *l = (int)lc;
  *q = (int)(bx - lc * (lc + 1) / 2);
}

// Block b sums row b of a (gridDim.x, m) partials array into out[b]:
// strided float64 sums over 256 threads, then a fixed tree, so results are
// the same bits run to run (no float atomics).  Launch with 256 threads.
__global__ void sum_tile_partials(const float* __restrict__ partials,
                                  long long m, float* __restrict__ out) {
  __shared__ double s[256];
  const float* row = partials + (size_t)blockIdx.x * (size_t)m;
  double acc = 0.0;
  for (long long idx = threadIdx.x; idx < m; idx += blockDim.x) acc += row[idx];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = (float)s[0];
}

}  // namespace
}  // namespace repro_torch
