// Factored GROUP BY box sums (eq. 11 over a family of boxes that differ only
// in one axis, the group column's code window):
//   count_raw[g] = sum_i shared_cnt_i * gPhi_ig
//   sum_raw[g]   = sum_i shared_sm_i  * gPhi_ig        (target on a kept axis)
//                = sum_i shared_cnt_i * gmom_ig        (target == group axis)
//   shared_cnt_i = prod_{j != g_axis} dPhi_ij   (the family's shared box)
//   shared_sm_i  = the same product with the target axis's factor swapped
//                  for its first moment x dPhi - h dphi (eq. 10)
//   gPhi_ig      = dPhi of row i on the group axis over category g's window
//
// Replaces the TPU kernel repro/kernels/aqp_grouped.py, aqp_grouped_sums (its
// pallas_call _kernel).
//
// Bound on the H100: operations.  Each row costs two erfcf per shared axis
// once, then two erfcf (and two expf when the group axis is the target) per
// (row, category), against 4d bytes of input per row; G <= 64 categories per
// family on the engine's path.  The TPU kernel keeps a (G-tile, 2)
// accumulator resident across sequential data tiles; blocks here run in no
// order, so each block owns one chunk of rows: its threads first form the
// shared products of the chunk's rows (one row per thread) into shared
// memory, then thread (row group r, category g) sums rows r, r + 4, ... of
// the chunk for category g, the four row groups are added in a fixed order,
// and each block writes one partial per (channel, category).  A second
// kernel adds the chunk partials in chunk order (common.cuh), so a repeat
// query gives the same bits.  Small chunks (128 rows) put 256 blocks on the
// 132 SMs at n = 32768 even when one block covers all 64 categories.  Phi
// differences come from the tail (erfcf, common.cuh), not as an erf
// difference, which cancels in the far tails.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kGroupTile = 64;   // categories per block (blockIdx.y)
constexpr int kRowGroups = 4;    // row groups per block: blockDim = 256

// blockIdx.x = chunk of k rows, blockIdx.y = tile of kGroupTile categories;
// dynamic shared memory 3 k floats.  partials: (n_chunks, 2, G).
template <int D>
__global__ void grouped_tiles(const float* __restrict__ x, int n,
                              const float* __restrict__ h,
                              const float* __restrict__ lo,
                              const float* __restrict__ hi,
                              const float* __restrict__ glo,
                              const float* __restrict__ ghi, int G, int g_axis,
                              int tgt, int k, float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* s_cnt = smem;           // shared_cnt of the chunk's rows
  float* s_sm = smem + k;        // shared_sm (target on a kept axis)
  float* s_xg = smem + 2 * k;    // the rows' group-axis values
  __shared__ float red[2][kRowGroups][kGroupTile];
  const int base = blockIdx.x * k;
  const int rows = min(k, n - base);
  const bool tgt_is_group = (tgt == g_axis);

  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float* row = x + (size_t)(base + r) * D;
    float pc = 1.0f, ps = 1.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float xv = row[j];
      const float ih = 1.0f / h[j];
      const float za = (lo[j] - xv) * ih;
      const float zb = (hi[j] - xv) * ih;
      const float dP = phi_diff(za, zb);
      const bool keep = (j != g_axis);
      pc *= keep ? dP : 1.0f;
      const float fac = (j == tgt) ? xv * dP - h[j] * dens_diff(za, zb) : dP;
      ps *= keep ? fac : 1.0f;
    }
    s_cnt[r] = pc;
    s_sm[r] = ps;
    s_xg[r] = row[g_axis];
  }
  __syncthreads();

  const int gl = threadIdx.x % kGroupTile;
  const int rg = threadIdx.x / kGroupTile;
  const int g = blockIdx.y * kGroupTile + gl;
  float cnt = 0.0f, sm = 0.0f;
  if (g < G) {
    const float hg = h[g_axis];
    const float ihg = 1.0f / hg;
    const float a = glo[g], b = ghi[g];
    for (int r = rg; r < rows; r += kRowGroups) {
      const float xg = s_xg[r];
      const float za = (a - xg) * ihg;
      const float zb = (b - xg) * ihg;
      const float gP = phi_diff(za, zb);
      cnt = fmaf(s_cnt[r], gP, cnt);
      if (tgt_is_group)
        sm = fmaf(s_cnt[r], xg * gP - hg * dens_diff(za, zb), sm);
      else
        sm = fmaf(s_sm[r], gP, sm);
    }
  }
  red[0][rg][gl] = cnt;
  red[1][rg][gl] = sm;
  __syncthreads();
  if (rg == 0 && g < G) {
    float c = red[0][0][gl], s = red[1][0][gl];
#pragma unroll
    for (int t = 1; t < kRowGroups; ++t) {
      c += red[0][t][gl];
      s += red[1][t][gl];
    }
    float* out = partials + (size_t)blockIdx.x * 2 * G;
    out[g] = c;
    out[G + g] = s;
  }
}

template <int D>
cudaError_t launch_d(const float* x, int n, const float* h, const float* lo,
                     const float* hi, const float* glo, const float* ghi, int G,
                     int g_axis, int tgt, int k, float* partials,
                     cudaStream_t stream) {
  const dim3 grid((n + k - 1) / k, (G + kGroupTile - 1) / kGroupTile);
  grouped_tiles<D><<<grid, kGroupTile * kRowGroups, (size_t)3 * k * sizeof(float),
                     stream>>>(x, n, h, lo, hi, glo, ghi, G, g_axis, tgt, k, partials);
  return cudaGetLastError();
}

}  // namespace repro_torch

// x: (n, d) row-major, h/lo/hi: (d,), glo/ghi: (G,); 1 <= d <= 8,
// 0 <= g_axis, tgt < d; partials holds ceil(n/k) * 2 * G floats.  Returns
// the cudaError_t of the launches.
extern "C" int aqp_grouped_sums_launch(const float* x, int n, int d,
                                       const float* h, const float* lo,
                                       const float* hi, const float* glo,
                                       const float* ghi, int G, int g_axis,
                                       int tgt, int k, float* partials,
                                       float* cnt, float* sum, void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (d) {
    case 1: err = launch_d<1>(x, n, h, lo, hi, glo, ghi, G, g_axis, tgt, k, partials, s); break;
    case 2: err = launch_d<2>(x, n, h, lo, hi, glo, ghi, G, g_axis, tgt, k, partials, s); break;
    case 3: err = launch_d<3>(x, n, h, lo, hi, glo, ghi, G, g_axis, tgt, k, partials, s); break;
    case 4: err = launch_d<4>(x, n, h, lo, hi, glo, ghi, G, g_axis, tgt, k, partials, s); break;
    case 5: err = launch_d<5>(x, n, h, lo, hi, glo, ghi, G, g_axis, tgt, k, partials, s); break;
    case 6: err = launch_d<6>(x, n, h, lo, hi, glo, ghi, G, g_axis, tgt, k, partials, s); break;
    case 7: err = launch_d<7>(x, n, h, lo, hi, glo, ghi, G, g_axis, tgt, k, partials, s); break;
    case 8: err = launch_d<8>(x, n, h, lo, hi, glo, ghi, G, g_axis, tgt, k, partials, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (n + k - 1) / k;
  sum_chunk_partials<<<(2 * G + 255) / 256, 256, 0, s>>>(partials, n_chunks, G, cnt, sum);
  return (int)cudaGetLastError();
}
