// Batched box-query sums of eq. 11 against one diagonal-bandwidth joint
// synopsis, with the three second-moment sums of their CI, per query q (box
// [lo_q, hi_q], SUM target axis t_q) over the sample rows i:
//   c_qi = prod_j dPhi_qij                                   (eq. 11's term)
//   s_qi = m_qit * prod_{j != t_q} dPhi_qij                  (its SUM term)
//   out[:, q] = (sum c, sum s, sum c^2, sum s^2, sum c s)
//   dPhi_qij = Phi((hi_qj - x_ij)/h_j) - Phi((lo_qj - x_ij)/h_j)
//   m_qij    = x_ij dPhi_qij - h_j dphi_qij                      (eq. 10)
//
// Replaces the TPU kernel repro/kernels/aqp_boxes.py, aqp_box_sums (its
// pallas_call _kernel); the three squared sums replace the separate CI pass
// over the same terms (repro/core/aqp_ci.py, moments_box).
//
// Bound on the H100: operations.  A (query, row) costs two erfc per axis and
// the target axis's density difference, about 85 instructions an axis against
// 4d bytes of input per row: at q = 384, n = 32 768, d = 3, 1.3e7 (query,
// row) pairs read 0.4 MB.  The first design (one query per thread against a
// shared chunk of 256 rows) put 384 blocks of 128 threads on 132 SMs, each
// thread walking its rows in one dependent chain: latency bound, at a
// seventh of the SFU floor.
//
// What the design does about it (the layout of aqp_batch.cu):
//  - a warp holds kRows boxes (bounds in registers; d is a template
//    parameter, so the axis loop unrolls and nothing spills) and its lanes
//    split a range of rows, so one row load feeds kRows boxes, and the row
//    ranges are cut at call time from the SM count and the occupancy so
//    that the grid fills, and stays within, two waves of resident blocks
//    at any q (point_range);
//  - erfc_gauss (common.cuh) gives each axis's erfc and exponentials from
//    one ex2 and one reciprocal, so the target axis's density difference
//    needs no exponential of its own: 4d SFU ops per (query, row) where
//    erfcf and expf took 4d + 2;
//  - each warp adds its lanes by a fixed shuffle tree and writes one partial
//    per (sum, query, range); sum_tile_partials adds a value's partials in
//    range order in float64 (no float atomics: two launches give the same
//    bits).
// The SUM factor is a select on the target axis, never a division of the
// product by dPhi_t, which blows up when a box leaves no mass on an axis.  A
// target outside [0, d) gives NaN for the sums that hold s instead of
// reading out of bounds.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kRows = 4;                       // boxes per warp (registers)
constexpr int kWarps = 8;                      // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kQueryTile = kRows * kWarps;     // boxes per block (blockIdx.x)

// blockIdx.x = query tile, blockIdx.y = range of range_rows rows.  x: (n, D)
// row-major, lo/hi: (q, D).  partials: (5, q, gridDim.y).
template <int D>
__global__ void __launch_bounds__(kThreads)
aqp_box_tiles(const float* __restrict__ x, int n, const float* __restrict__ h,
              const float* __restrict__ lo, const float* __restrict__ hi,
              const int* __restrict__ tgt, int q, int range_rows,
              float* __restrict__ partials) {
  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (q0 >= q) return;                         // a whole warp past the boxes
  float h_r[D], ih_r[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    h_r[j] = h[j];
    ih_r[j] = 1.0f / h_r[j];
  }
  float lo_r[kRows][D], hi_r[kRows][D], acc[kRows][5];
  int t_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = min(q0 + r, q - 1);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      lo_r[r][j] = lo[(size_t)qi * D + j];
      hi_r[r][j] = hi[(size_t)qi * D + j];
    }
    t_r[r] = tgt[qi];
#pragma unroll
    for (int k = 0; k < 5; ++k) acc[r][k] = 0.0f;
  }
  const int begin = blockIdx.y * range_rows;
  const int end = min(n, begin + range_rows);
  for (int i = begin + lane; i < end; i += 32) {
    float xr[D];
#pragma unroll
    for (int j = 0; j < D; ++j) xr[j] = __ldg(x + (size_t)i * D + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float c = 1.0f, s = 1.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float d_Phi, d_phi;
        phi_dens_diff((lo_r[r][j] - xr[j]) * ih_r[j], (hi_r[r][j] - xr[j]) * ih_r[j],
                      d_Phi, d_phi);
        c *= d_Phi;
        s *= j == t_r[r] ? fmaf(xr[j], d_Phi, -h_r[j] * d_phi) : d_Phi;
      }
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
    const bool t_ok = t_r[r] >= 0 && t_r[r] < D;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      partials[((size_t)k * q + q0 + r) * gridDim.y + blockIdx.y] =
          t_ok || k == 0 || k == 2 ? acc[r][k] : nanf("");
  }
}

template <int D>
cudaError_t launch_d(const float* x, int n, const float* h, const float* lo,
                     const float* hi, const int* tgt, int q, int range_rows,
                     float* partials, cudaStream_t stream) {
  const dim3 grid((q + kQueryTile - 1) / kQueryTile, (n + range_rows - 1) / range_rows);
  aqp_box_tiles<D><<<grid, kThreads, 0, stream>>>(x, n, h, lo, hi, tgt, q, range_rows,
                                                  partials);
  return cudaGetLastError();
}

template <int D>
cudaError_t blocks_d(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, aqp_box_tiles<D>,
                                                       kThreads, 0);
}

}  // namespace repro_torch

#define BOX_CASES(F, ...)                                                          \
  case 1: err = F<1>(__VA_ARGS__); break;                                          \
  case 2: err = F<2>(__VA_ARGS__); break;                                          \
  case 3: err = F<3>(__VA_ARGS__); break;                                          \
  case 4: err = F<4>(__VA_ARGS__); break;                                          \
  case 5: err = F<5>(__VA_ARGS__); break;                                          \
  case 6: err = F<6>(__VA_ARGS__); break;                                          \
  case 7: err = F<7>(__VA_ARGS__); break;                                          \
  case 8: err = F<8>(__VA_ARGS__); break;                                          \
  default: return (int)cudaErrorInvalidValue;

// Blocks of aqp_box_tiles<d> one SM holds at once, into *blocks; 1 <= d <= 8.
// Returns the cudaError_t.
extern "C" int aqp_box_blocks_per_sm(int d, int* blocks) {
  using namespace repro_torch;
  cudaError_t err;
  switch (d) { BOX_CASES(blocks_d, blocks) }
  return (int)err;
}

// x: (n, d) row-major, h: (d,), lo/hi: (q, d), tgt: (q,); 1 <= d <= 8, n,
// q >= 1, range_rows >= 1.  partials holds 5 * q * ceil(n / range_rows)
// floats, out (5, q).  Returns the cudaError_t of the launches.
extern "C" int aqp_box_moments_launch(const float* x, int n, int d, const float* h,
                                      const float* lo, const float* hi,
                                      const int* tgt, int q, int range_rows,
                                      float* partials, float* out, void* stream_ptr) {
  using namespace repro_torch;
  if (n < 1 || q < 1 || range_rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (d) { BOX_CASES(launch_d, x, n, h, lo, hi, tgt, q, range_rows, partials, stream) }
  if (err != cudaSuccess) return (int)err;
  const int n_ranges = (n + range_rows - 1) / range_rows;
  sum_tile_partials<<<5 * q, 256, 0, stream>>>(partials, n_ranges, out);
  return (int)cudaGetLastError();
}
