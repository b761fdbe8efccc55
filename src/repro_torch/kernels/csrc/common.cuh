// Shared device helpers of the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {
// Internal linkage: every kernel library carries its own copy.
namespace {

constexpr float kInvSqrt2Pi = 0.39894228040143267794f;
constexpr float kSqrt1_2 = 0.70710678118654752440f;

// Phi(zb) - Phi(za) without the tail cancellation of
// 0.5 * (erf(zb / sqrt2) - erf(za / sqrt2)): both terms are taken from the
// tail the pair sits in (upper tail when the midpoint is positive), where
// erfc keeps its relative precision.  The identity holds for any sign, so
// one select picks the operands and both branches cost two erfcf.
__device__ __forceinline__ float phi_diff(float za, float zb) {
  const bool upper = za + zb > 0.0f;
  const float u = upper ? za : -zb;
  const float v = upper ? zb : -za;
  return 0.5f * (erfcf(u * kSqrt1_2) - erfcf(v * kSqrt1_2));
}

// phi(zb) - phi(za), the density difference of eq. 10.
__device__ __forceinline__ float dens_diff(float za, float zb) {
  return kInvSqrt2Pi * (expf(-0.5f * zb * zb) - expf(-0.5f * za * za));
}

// 2^x by one SFU op (ex2.approx.ftz.f32): no denormal fix-ups, a result
// below 2^-126 is flushed to +0, and -inf gives +0.  Used where a flushed
// term is far below the tolerance of the sum it enters (gh_fused.cu,
// lscv_grid.cu); the build has no global -ftz.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sum over the 32 lanes of a warp, the same tree every call.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Each thread c < 2*q sums column c of a (n_chunks, 2*q) partials array in
// chunk order and writes it to cnt[c] (c < q) or sum[c - q].  One fixed
// order, so results are the same run to run.
__global__ void sum_chunk_partials(const float* __restrict__ partials,
                                   int n_chunks, int q,
                                   float* __restrict__ cnt,
                                   float* __restrict__ sum) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= 2 * q) return;
  float acc = 0.0f;
  for (int k = 0; k < n_chunks; ++k) acc += partials[(size_t)k * 2 * q + c];
  if (c < q) cnt[c] = acc;
  else sum[c - q] = acc;
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
