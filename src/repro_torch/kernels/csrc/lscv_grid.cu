// LSCV_h grid phase (paper §6.2 phase 2, eqs. 40-43): for every h on the
// grid, sum_{i<j} T~(S_ij; h) with
//   T~(S; h) = c_kk exp(-S / (4 h^2)) - 2 c_k exp(-S / (2 h^2))
// over the precomputed S of sv_precompute.cu.
//
// Replaces the TPU kernel repro/kernels/lscv_grid.py, lscv_grid_sums (its
// pallas_call _kernel; the S precompute it calls first is sv_precompute.cu).
//
// Bound on the H100: operations.  n = 32768 and 150 grid points make
// 8.1e10 (pair, h) terms against 2.1 GB of S read once.  With
// a_h = -log2(e) / (4 h^2) precomputed, e4 = exp2(a_h S) is one SFU ex2,
// exp(-S / (2 h^2)) = e4 * e4, and T~ = e4 (c_kk - 2 c_k e4): one multiply,
// one ex2 and two FMAs per term.  The TPU kernel streams every (k, k) tile
// of S together with a dense (n, n) 0/1 mask; here a 1-D grid enumerates
// only the upper-triangle tiles (eqs. 49/50, common.cuh), each block stages
// its kGridTile^2 tile of S in shared memory with the masked entries set to
// +inf (so their term is exactly 0 and the inner loop has no branch), and
// each thread owns one h, reading the tile as float4 broadcasts and keeping
// its sum in registers.  Every (tile, h) partial goes to device memory and a
// second kernel adds each h's partials in a fixed order (no float atomics),
// so a fit gives the same bits run to run.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kGridTile = 64;   // S tile side: kGridTile^2 floats of shared memory

__device__ __forceinline__ float t_term(float s, float a, float c_kk,
                                        float m2ck) {
  const float e4 = exp2f(s * a);
  return e4 * fmaf(m2ck, e4, c_kk);
}

// partials: (n_h, n_tri); block bx writes column bx.  consts = (c_k, c_kk).
__global__ void lscv_grid_tiles(const float* __restrict__ S, int n,
                                const float* __restrict__ a_h, int n_h,
                                const float* __restrict__ consts,
                                long long n_tri, float* __restrict__ partials) {
  __shared__ float4 tile4[kGridTile * kGridTile / 4];
  float* tile = reinterpret_cast<float*>(tile4);
  int q, l;
  bx_to_ql(blockIdx.x, &q, &l);
  const long long i0 = (long long)q * kGridTile;
  const long long j0 = (long long)l * kGridTile;
  for (int e = threadIdx.x; e < kGridTile * kGridTile; e += blockDim.x) {
    const long long i = i0 + e / kGridTile;
    const long long j = j0 + e % kGridTile;
    tile[e] = (i < j && j < n) ? S[i * n + j] : INFINITY;
  }
  __syncthreads();
  const float c_kk = consts[1];
  const float m2ck = -2.0f * consts[0];
  for (int h = threadIdx.x; h < n_h; h += blockDim.x) {
    const float a = a_h[h];
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
#pragma unroll 4
    for (int e = 0; e < kGridTile * kGridTile / 4; ++e) {
      const float4 s = tile4[e];
      acc0 += t_term(s.x, a, c_kk, m2ck);
      acc1 += t_term(s.y, a, c_kk, m2ck);
      acc2 += t_term(s.z, a, c_kk, m2ck);
      acc3 += t_term(s.w, a, c_kk, m2ck);
    }
    partials[(size_t)h * (size_t)n_tri + blockIdx.x] = (acc0 + acc1) + (acc2 + acc3);
  }
}

}  // namespace repro_torch

// S: (n, n) row-major (only its strict upper triangle is read); a_h: (n_h,)
// = -log2(e) / (4 h^2); consts: (c_k, c_kk); partials: n_h * n_tri floats
// with n_tri = T(T+1)/2, T = ceil(n / 64); out: (n_h,).  `threads` per block
// (a multiple of 32).  Returns the cudaError_t of the launches.
extern "C" int lscv_grid_sums_launch(const float* S, int n, const float* a_h,
                                     int n_h, const float* consts, int threads,
                                     float* partials, float* out,
                                     void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n_tiles = (n + kGridTile - 1) / kGridTile;
  const long long n_tri = n_tiles * (n_tiles + 1) / 2;
  lscv_grid_tiles<<<(unsigned)n_tri, threads, 0, stream>>>(S, n, a_h, n_h, consts,
                                                          n_tri, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_tile_partials<<<(unsigned)n_h, 256, 0, stream>>>(partials, n_tri, out);
  return (int)cudaGetLastError();
}
