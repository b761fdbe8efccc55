// Batched range-query sums of eqs. 9-10 against one 1-D synopsis:
//   count_raw[q] = sum_i Phi((b_q - x_i)/h) - Phi((a_q - x_i)/h)
//   sum_raw[q]   = sum_i x_i [Phi]_qi - h [phi]_qi
//
// Replaces the TPU kernel repro/kernels/aqp_batch.py, aqp_batch_sums (its
// pallas_call _kernel).
//
// Bound on the H100: operations.  Each (query, point) pair costs two erfcf,
// two expf and about twenty FP32 operations against 8 bytes of input per
// point, all of which stay in shared memory.  The TPU kernel carries a
// resident (qk, 2) accumulator along a sequential data-tile grid axis; Hopper
// blocks run in no order, so here each block takes a query tile (one query
// per thread, its bounds in registers) and one data chunk staged in shared
// memory (a broadcast read per point), and writes per-chunk partials; a
// second kernel adds the chunks in a fixed order, so results are the same
// run to run.  The Phi difference is taken from the tail the pair sits in
// (common.cuh, phi_diff) instead of as a difference of erf values, which
// cancels in the far tails.  h is read from device memory.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

// blockDim.x = query tile; blockIdx.y = data chunk of k points;
// dynamic shared memory k floats.  partials: (n_chunks, 2, q).
__global__ void aqp_batch_tiles(const float* __restrict__ x, int n,
                                const float* __restrict__ h,
                                const float* __restrict__ a,
                                const float* __restrict__ b, int q, int k,
                                float* __restrict__ partials) {
  extern __shared__ float xs[];
  const int base = blockIdx.y * k;
  const int m = min(k, n - base);
  for (int t = threadIdx.x; t < m; t += blockDim.x) xs[t] = x[base + t];
  __syncthreads();
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const float hv = h[0];
  const float inv_h = 1.0f / hv;
  const float aq = a[qi];
  const float bq = b[qi];
  float cnt = 0.0f, sm = 0.0f;
  for (int t = 0; t < m; ++t) {
    const float xv = xs[t];
    const float za = (aq - xv) * inv_h;
    const float zb = (bq - xv) * inv_h;
    const float dP = phi_diff(za, zb);
    cnt += dP;
    sm += xv * dP - hv * dens_diff(za, zb);
  }
  float* out = partials + (size_t)blockIdx.y * 2 * q;
  out[qi] = cnt;
  out[q + qi] = sm;
}

}  // namespace repro_torch

// partials holds ceil(n/k) * 2 * q floats.  Returns the cudaError_t.
extern "C" int aqp_batch_sums_launch(const float* x, int n, const float* h,
                                     const float* a, const float* b, int q,
                                     int k, int qk, float* partials,
                                     float* cnt, float* sum, void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_chunks = (n + k - 1) / k;
  const dim3 grid((q + qk - 1) / qk, n_chunks);
  aqp_batch_tiles<<<grid, qk, (size_t)k * sizeof(float), stream>>>(
      x, n, h, a, b, q, k, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_chunk_partials<<<(2 * q + 255) / 256, 256, 0, stream>>>(partials, n_chunks, q,
                                                              cnt, sum);
  return (int)cudaGetLastError();
}
