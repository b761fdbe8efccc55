// Fused quasi-MC box reduction of a full-H synopsis (eq. 6 integrated over
// boxes on shared Halton nodes): for box q with SUM target axis t_q,
//   cnt_sums[q] = sum_m 1_q(node_m) f_m
//   sum_sums[q] = sum_m 1_q(node_m) node_m[t_q] f_m
//   f_m = sum_i exp(log_norm - quad_mi / 2),
//   quad_mi = (node_m - x_i)^T H^-1 (node_m - x_i)
// The caller applies vol(G) / m.
//
// Replaces the TPU kernel repro/kernels/qmc_reduce.py, qmc_box_reduce (its
// pallas_call _kernel).
//
// Bound on the H100: operations.  The density costs d subtractions, d^2 + d
// FMAs of the quadratic form and one expf per (node, row): 1.07e9 pairs at
// m = n = 32768, against m d + n d floats of input; the indicator pass is
// q m d compares.  The TPU grid (box tile, node tile, data tile) recomputes
// the m x n densities for every box tile, because its accumulator lives
// with a box tile.  Both sums are linear in f, so here the densities are
// formed once: stage 1 has one node per thread (its point and H^-1 in
// registers) against a chunk of rows in shared memory and writes one
// partial per (chunk, node); stage 2 adds each node's partials in chunk
// order; stage 3 gives each box a block that walks the nodes and reduces in
// a fixed tree.  That is q / 64 times less exp work than the TPU schedule at
// q = 384, and the same bits run to run.  The quadratic form contracts
// v = diff H^-1 before the second dot (as the reference's einsum and the
// Pallas kernel do): an ill-conditioned LSCV_H makes H^-1 large with
// alternating signs, and v absorbs the cancellation at small magnitude.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

// blockDim.x nodes per block (blockIdx.x), k rows per chunk (blockIdx.y);
// dynamic shared memory k * D floats.  partials: (n_chunks, m).
template <int D>
__global__ void qmc_density_tiles(const float* __restrict__ nodes, int m,
                                  const float* __restrict__ x, int n,
                                  const float* __restrict__ h_inv,
                                  const float* __restrict__ log_norm, int k,
                                  float* __restrict__ partials) {
  extern __shared__ float xs[];
  const int base = blockIdx.y * k;
  const int rows = min(k, n - base);
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x)
    xs[e] = x[(size_t)base * D + e];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float p[D], hinv[D * D];
#pragma unroll
  for (int a = 0; a < D; ++a) p[a] = nodes[(size_t)i * D + a];
#pragma unroll
  for (int e = 0; e < D * D; ++e) hinv[e] = h_inv[e];
  const float ln = log_norm[0];
  float acc = 0.0f;
  for (int r = 0; r < rows; ++r) {
    float diff[D];
#pragma unroll
    for (int a = 0; a < D; ++a) diff[a] = p[a] - xs[r * D + a];
    float quad = 0.0f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float v = 0.0f;
#pragma unroll
      for (int e = 0; e < D; ++e) v = fmaf(hinv[a * D + e], diff[e], v);
      quad = fmaf(v, diff[a], quad);
    }
    acc += expf(ln - 0.5f * quad);
  }
  partials[(size_t)blockIdx.y * m + i] = acc;
}

// One block of 256 threads per box q: nodes strided over the threads, then
// a fixed tree (warp shuffles, then the 8 warp sums in order).
template <int D>
__global__ void qmc_box_tiles(const float* __restrict__ nodes, int m,
                              const float* __restrict__ f,
                              const float* __restrict__ lo,
                              const float* __restrict__ hi,
                              const int* __restrict__ tgt,
                              float* __restrict__ cnt, float* __restrict__ sum) {
  __shared__ float warp_c[8], warp_s[8];
  const int qi = blockIdx.x;
  float l[D], u[D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    l[a] = lo[(size_t)qi * D + a];
    u[a] = hi[(size_t)qi * D + a];
  }
  const int t = tgt[qi];
  float c = 0.0f, s = 0.0f;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    bool inside = true;
    float tv = 0.0f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const float na = nodes[(size_t)j * D + a];
      inside = inside && na >= l[a] && na <= u[a];
      tv = (t == a) ? na : tv;
    }
    const float w = inside ? f[j] : 0.0f;
    c += w;
    s = fmaf(w, tv, s);
  }
  c = warp_sum(c);
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) {
    warp_c[threadIdx.x >> 5] = c;
    warp_s[threadIdx.x >> 5] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float cc = 0.0f, ss = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      cc += warp_c[w];
      ss += warp_s[w];
    }
    cnt[qi] = cc;
    sum[qi] = ss;
  }
}

template <int D>
cudaError_t launch_d(const float* nodes, int m, const float* x, int n,
                     const float* h_inv, const float* log_norm, const float* lo,
                     const float* hi, const int* tgt, int q, int mk, int k,
                     float* partials, float* f, float* cnt, float* sum,
                     cudaStream_t stream) {
  const int n_chunks = (n + k - 1) / k;
  const dim3 grid((m + mk - 1) / mk, n_chunks);
  qmc_density_tiles<D><<<grid, mk, (size_t)k * D * sizeof(float), stream>>>(
      nodes, m, x, n, h_inv, log_norm, k, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partial_columns<<<(m + 255) / 256, 256, 0, stream>>>(partials, n_chunks, m, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qmc_box_tiles<D><<<q, 256, 0, stream>>>(nodes, m, f, lo, hi, tgt, cnt, sum);
  return cudaGetLastError();
}

}  // namespace repro_torch

// nodes: (m, d), x: (n, d), h_inv: (d, d), all row-major; log_norm: one
// float on the device; lo/hi: (q, d), tgt: (q,); 1 <= d <= 8, mk nodes per
// block (a multiple of 32), k rows per chunk.  partials holds
// ceil(n/k) * m floats and f holds m.  Returns the cudaError_t of the
// launches.
extern "C" int qmc_box_reduce_launch(const float* nodes, int m, const float* x,
                                     int n, int d, const float* h_inv,
                                     const float* log_norm, const float* lo,
                                     const float* hi, const int* tgt, int q,
                                     int mk, int k, float* partials, float* f,
                                     float* cnt, float* sum, void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (d) {
    case 1: err = launch_d<1>(nodes, m, x, n, h_inv, log_norm, lo, hi, tgt, q, mk, k, partials, f, cnt, sum, s); break;
    case 2: err = launch_d<2>(nodes, m, x, n, h_inv, log_norm, lo, hi, tgt, q, mk, k, partials, f, cnt, sum, s); break;
    case 3: err = launch_d<3>(nodes, m, x, n, h_inv, log_norm, lo, hi, tgt, q, mk, k, partials, f, cnt, sum, s); break;
    case 4: err = launch_d<4>(nodes, m, x, n, h_inv, log_norm, lo, hi, tgt, q, mk, k, partials, f, cnt, sum, s); break;
    case 5: err = launch_d<5>(nodes, m, x, n, h_inv, log_norm, lo, hi, tgt, q, mk, k, partials, f, cnt, sum, s); break;
    case 6: err = launch_d<6>(nodes, m, x, n, h_inv, log_norm, lo, hi, tgt, q, mk, k, partials, f, cnt, sum, s); break;
    case 7: err = launch_d<7>(nodes, m, x, n, h_inv, log_norm, lo, hi, tgt, q, mk, k, partials, f, cnt, sum, s); break;
    case 8: err = launch_d<8>(nodes, m, x, n, h_inv, log_norm, lo, hi, tgt, q, mk, k, partials, f, cnt, sum, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
