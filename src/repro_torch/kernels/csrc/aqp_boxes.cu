// Batched box-query sums of eq. 11 against one diagonal-bandwidth joint
// synopsis, for query q (box [lo_q, hi_q], SUM target axis t_q):
//   count_raw[q] = sum_i prod_j dPhi_qij
//   sum_raw[q]   = sum_i m_qit * prod_{j != t_q} dPhi_qij
//   dPhi_qij = Phi((hi_qj - x_ij)/h_j) - Phi((lo_qj - x_ij)/h_j)
//   m_qij    = x_ij dPhi_qij - h_j dphi_qij                      (eq. 10)
//
// Replaces the TPU kernel repro/kernels/aqp_boxes.py, aqp_box_sums (its
// pallas_call _kernel).
//
// Bound on the H100: operations.  Each (query, row) pair costs two erfcf per
// axis plus two expf for the target axis against 4d bytes of input per row.
// Same layout as aqp_batch.cu: one query per thread with its box, inverse
// bandwidths and target in registers (d is a template parameter, so the
// per-axis loop unrolls and nothing spills to local memory), one data chunk
// of rows staged in shared memory, per-chunk partials and a fixed-order
// second pass (deterministic, no atomics).  The SUM factor is a select on
// the target axis, never a division of the product by dPhi_t, which blows up
// when a box leaves no mass on an axis.  A target outside [0, d) yields NaN
// sums instead of reading out of bounds.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

// blockDim.x = query tile; blockIdx.y = chunk of k rows; dynamic shared
// memory k * D floats.  x: (n, D) row-major.  partials: (n_chunks, 2, q).
template <int D>
__global__ void aqp_box_tiles(const float* __restrict__ x, int n,
                              const float* __restrict__ h,
                              const float* __restrict__ lo,
                              const float* __restrict__ hi,
                              const int* __restrict__ tgt, int q, int k,
                              float* __restrict__ partials) {
  extern __shared__ float xs[];
  const int base = blockIdx.y * k;
  const int m = min(k, n - base);
  for (int t = threadIdx.x; t < m * D; t += blockDim.x) xs[t] = x[(size_t)base * D + t];
  __syncthreads();
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;

  float lo_r[D], hi_r[D], h_r[D], ih_r[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    lo_r[j] = lo[(size_t)qi * D + j];
    hi_r[j] = hi[(size_t)qi * D + j];
    h_r[j] = h[j];
    ih_r[j] = 1.0f / h_r[j];
  }
  const int tq = tgt[qi];
  const bool t_ok = tq >= 0 && tq < D;

  float cnt = 0.0f, sm = 0.0f;
  for (int t = 0; t < m; ++t) {
    const float* row = xs + t * D;
    float prod_all = 1.0f, prod_rest = 1.0f;
    float x_t = 0.0f, za_t = 0.0f, zb_t = 0.0f, dP_t = 0.0f, h_t = 1.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float xv = row[j];
      const float za = (lo_r[j] - xv) * ih_r[j];
      const float zb = (hi_r[j] - xv) * ih_r[j];
      const float dP = phi_diff(za, zb);
      prod_all *= dP;
      const bool is_t = (j == tq);
      prod_rest *= is_t ? 1.0f : dP;
      x_t = is_t ? xv : x_t;
      za_t = is_t ? za : za_t;
      zb_t = is_t ? zb : zb_t;
      dP_t = is_t ? dP : dP_t;
      h_t = is_t ? h_r[j] : h_t;
    }
    cnt += prod_all;
    sm += prod_rest * (x_t * dP_t - h_t * dens_diff(za_t, zb_t));
  }
  float* out = partials + (size_t)blockIdx.y * 2 * q;
  out[qi] = cnt;
  out[q + qi] = t_ok ? sm : nanf("");
}

template <int D>
cudaError_t launch_d(const float* x, int n, const float* h, const float* lo,
                     const float* hi, const int* tgt, int q, int k, int qk,
                     float* partials, cudaStream_t stream) {
  const dim3 grid((q + qk - 1) / qk, (n + k - 1) / k);
  aqp_box_tiles<D><<<grid, qk, (size_t)k * D * sizeof(float), stream>>>(
      x, n, h, lo, hi, tgt, q, k, partials);
  return cudaGetLastError();
}

}  // namespace repro_torch

// 1 <= d <= 8.  partials holds ceil(n/k) * 2 * q floats.  Returns the
// cudaError_t of the launches.
extern "C" int aqp_box_sums_launch(const float* x, int n, int d, const float* h,
                                   const float* lo, const float* hi,
                                   const int* tgt, int q, int k, int qk,
                                   float* partials, float* cnt, float* sum,
                                   void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (d) {
    case 1: err = launch_d<1>(x, n, h, lo, hi, tgt, q, k, qk, partials, stream); break;
    case 2: err = launch_d<2>(x, n, h, lo, hi, tgt, q, k, qk, partials, stream); break;
    case 3: err = launch_d<3>(x, n, h, lo, hi, tgt, q, k, qk, partials, stream); break;
    case 4: err = launch_d<4>(x, n, h, lo, hi, tgt, q, k, qk, partials, stream); break;
    case 5: err = launch_d<5>(x, n, h, lo, hi, tgt, q, k, qk, partials, stream); break;
    case 6: err = launch_d<6>(x, n, h, lo, hi, tgt, q, k, qk, partials, stream); break;
    case 7: err = launch_d<7>(x, n, h, lo, hi, tgt, q, k, qk, partials, stream); break;
    case 8: err = launch_d<8>(x, n, h, lo, hi, tgt, q, k, qk, partials, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (n + k - 1) / k;
  sum_chunk_partials<<<(2 * q + 255) / 256, 256, 0, stream>>>(partials, n_chunks, q,
                                                              cnt, sum);
  return (int)cudaGetLastError();
}
