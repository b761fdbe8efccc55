// Batched range-query sums of eqs. 9-10 against one 1-D synopsis, with the
// three second-moment sums of their CI, per query q over the sample points i:
//   c_qi = Phi((b_q - x_i)/h) - Phi((a_q - x_i)/h)            (eq. 9's term)
//   s_qi = x_i c_qi - h [phi((b_q - x_i)/h) - phi((a_q - x_i)/h)]  (eq. 10's)
//   out[:, q] = (sum c, sum s, sum c^2, sum s^2, sum c s)
//
// Replaces the TPU kernel repro/kernels/aqp_batch.py, aqp_batch_sums (its
// pallas_call _kernel); the three squared sums replace the separate CI pass
// over the same terms (repro/core/aqp_ci.py, moments_1d).
//
// Bound on the H100: operations.  A (query, point) pair costs two erfc and
// the density difference, about 85 instructions against 4 bytes of input per
// point: at q = 256 and n = 32 768, 8.4e6 pairs read 0.13 MB.  The first
// design (one query per thread against a shared chunk of 512 points) put
// 128 blocks of 128 threads on 132 SMs, each thread walking its 512 pairs
// in one dependent chain: latency bound, at a sixth of the SFU floor.
//
// What the design does about it:
//  - a warp holds kRows queries (bounds in registers) and its lanes split a
//    range of points (lane l takes points l, l + 32, ...), so one point load
//    feeds kRows independent pairs, and the point ranges are cut at call
//    time from the SM count and the occupancy so that the grid fills, and
//    stays within, two waves of resident blocks at any q (point_range);
//  - erfc_gauss (common.cuh) gives erfc and the exponential of eq. 10 from
//    one ex2 and one reciprocal: 4 SFU ops per pair where two erfcf and two
//    expf took 6;
//  - each warp adds its lanes by a fixed shuffle tree and writes one partial
//    per (sum, query, range); sum_tile_partials adds a value's partials in
//    range order in float64.  No float atomics: two launches give the same
//    bits.
// The Phi difference is taken from the tail the pair sits in (the
// reference's erf difference cancels in the far tails).  h is read from
// device memory.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kRows = 4;                       // queries per warp (registers)
constexpr int kWarps = 8;                      // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kQueryTile = kRows * kWarps;     // queries per block (blockIdx.x)

// blockIdx.x = query tile, blockIdx.y = range of range_pts points.
// partials: (5, q, gridDim.y).
__global__ void __launch_bounds__(kThreads)
aqp_batch_tiles(const float* __restrict__ x, int n, const float* __restrict__ h,
                const float* __restrict__ a, const float* __restrict__ b, int q,
                int range_pts, float* __restrict__ partials) {
  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (q0 >= q) return;                         // a whole warp past the queries
  const float hv = h[0];
  const float inv_h = 1.0f / hv;
  float lo[kRows], hi[kRows], acc[kRows][5];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = min(q0 + r, q - 1);
    lo[r] = a[qi];
    hi[r] = b[qi];
#pragma unroll
    for (int k = 0; k < 5; ++k) acc[r][k] = 0.0f;
  }
  const int begin = blockIdx.y * range_pts;
  const int end = min(n, begin + range_pts);
  for (int i = begin + lane; i < end; i += 32) {
    const float xv = __ldg(x + i);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float c, d_phi;
      phi_dens_diff((lo[r] - xv) * inv_h, (hi[r] - xv) * inv_h, c, d_phi);
      const float s = fmaf(xv, c, -hv * d_phi);
      acc[r][0] += c;
      acc[r][1] += s;
      acc[r][2] = fmaf(c, c, acc[r][2]);
      acc[r][3] = fmaf(s, s, acc[r][3]);
      acc[r][4] = fmaf(c, s, acc[r][4]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int k = 0; k < 5; ++k) acc[r][k] = warp_sum(acc[r][k]);
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (q0 + r >= q) break;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      partials[((size_t)k * q + q0 + r) * gridDim.y + blockIdx.y] = acc[r][k];
  }
}

}  // namespace repro_torch

// Blocks of aqp_batch_tiles one SM holds at once, into *blocks.  Returns the
// cudaError_t.
extern "C" int aqp_batch_blocks_per_sm(int* blocks) {
  using namespace repro_torch;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, aqp_batch_tiles,
                                                            kThreads, 0);
}

// x: (n,), h: one float, a/b: (q,); n, q >= 1, range_pts >= 1.  partials
// holds 5 * q * ceil(n / range_pts) floats, out (5, q).  Returns the
// cudaError_t of the launches.
extern "C" int aqp_batch_moments_launch(const float* x, int n, const float* h,
                                        const float* a, const float* b, int q,
                                        int range_pts, float* partials, float* out,
                                        void* stream_ptr) {
  using namespace repro_torch;
  if (n < 1 || q < 1 || range_pts < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_ranges = (n + range_pts - 1) / range_pts;
  const dim3 grid((q + kQueryTile - 1) / kQueryTile, n_ranges);
  aqp_batch_tiles<<<grid, kThreads, 0, stream>>>(x, n, h, a, b, q, range_pts, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_tile_partials<<<5 * q, 256, 0, stream>>>(partials, n_ranges, out);
  return (int)cudaGetLastError();
}
