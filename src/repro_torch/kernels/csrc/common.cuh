// Shared device helpers of the port's kernels.
#pragma once

#include <cuda_runtime.h>

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

}  // namespace
}  // namespace repro_torch
