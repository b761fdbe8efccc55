// Fused LSCV_H objective inner sum (paper §6.3, eqs. 32-35):
//   sum_{i<j} T_H(s_ij),  s_ij = (x_i - x_j)^T H^-1 (x_i - x_j),
//   T_H(s) = c_kk exp(-s/4) - 2 c_k exp(-s/2).
//
// Replaces the TPU kernel repro/kernels/gh_fused.py, gh_fused_sum (its
// pallas_call _kernel).
//
// Bound on the H100: operations.  H^-1 changes at every Nelder-Mead step,
// so S cannot be precomputed (§4.5, last paragraph): each evaluation forms
// the quadratic forms of all 5.4e8 pairs (n = 32768) and reduces them in one
// pass, reading only n*d floats.  The design is pairwise_reduce.cu's: a 1-D
// grid over the upper-triangle tiles (eqs. 49/50, common.cuh), one row per
// thread with its point in registers, the column chunk in shared memory (a
// broadcast read per pair).  The TPU kernel expands s = qe + qf - 2 e^T M f
// for its matrix unit; this one forms the difference v = x_i - x_j and
// s = v^T M v (what the reference oracle computes).  M is folded into its
// d(d+1)/2 symmetric coefficients, pre-scaled by -log2(e)/4, so
// e4 = exp(-s/4) is one SFU ex2 of the quadratic form, exp(-s/2) = e4 * e4,
// and T_H = e4 (c_kk - 2 c_k e4).  c_k and c_kk are read from device memory,
// so the objective needs no host sync before the launch.  Each block reduces
// into one partial in a fixed tree and a second one-block kernel adds the
// partials in a fixed order (no float atomics).
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

constexpr float kNegQuarterLog2e = -0.36067376022224085f;   // -log2(e) / 4

// blockDim.x == k (a multiple of 32); dynamic shared memory k*D + k/32
// floats.  consts = (c_k, c_kk).
template <int D>
__global__ void gh_tiles(const float* __restrict__ x, int n,
                         const float* __restrict__ h_inv,
                         const float* __restrict__ consts, int k,
                         float* __restrict__ partials) {
  constexpr int kCoef = D * (D + 1) / 2;
  extern __shared__ float smem[];
  float* cols = smem;              // column chunk l, k x D
  float* warp_acc = smem + k * D;  // one slot per warp
  __shared__ float coef[kCoef];
  int q, l;
  bx_to_ql(blockIdx.x, &q, &l);
  const int t = threadIdx.x;
  const long long j0 = (long long)l * k;
  const long long i = (long long)q * k + t;
  for (int e = t; e < k * D; e += k)
    cols[e] = (j0 * D + e < (long long)n * D) ? x[j0 * D + e] : 0.0f;
  for (int e = t; e < kCoef; e += k) {
    int a = 0, rem = e;
    while (rem >= D - a) { rem -= D - a; ++a; }
    const int b = a + rem;
    const float mab = (a == b) ? h_inv[a * D + a] : h_inv[a * D + b] + h_inv[b * D + a];
    coef[e] = kNegQuarterLog2e * mab;
  }
  float xi[D];
#pragma unroll
  for (int a = 0; a < D; ++a) xi[a] = (i < n) ? x[i * D + a] : 0.0f;
  const float c_kk = consts[1];
  const float m2ck = -2.0f * consts[0];
  __syncthreads();

  float c[kCoef];
#pragma unroll
  for (int e = 0; e < kCoef; ++e) c[e] = coef[e];
  float acc = 0.0f;
  if (i < n) {
    // pairs i < j < n: on the diagonal tile only the columns after row t
    const int c_begin = (q == l) ? t + 1 : 0;
    const int c_end = (int)min((long long)k, n - j0);
    for (int cc = c_begin; cc < c_end; ++cc) {
      float v[D];
#pragma unroll
      for (int a = 0; a < D; ++a) v[a] = xi[a] - cols[cc * D + a];
      float s = 0.0f;
      int e = 0;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        float w = 0.0f;
#pragma unroll
        for (int b = a; b < D; ++b) w = fmaf(c[e++], v[b], w);
        s = fmaf(v[a], w, s);
      }
      const float e4 = exp2f(s);
      acc = fmaf(e4, fmaf(m2ck, e4, c_kk), acc);
    }
  }
  acc = warp_sum(acc);
  if ((t & 31) == 0) warp_acc[t >> 5] = acc;
  __syncthreads();
  if (t < 32) {
    float v = (t < (k >> 5)) ? warp_acc[t] : 0.0f;
    v = warp_sum(v);
    if (t == 0) partials[blockIdx.x] = v;
  }
}

template <int D>
int launch_gh(const float* x, int n, const float* h_inv, const float* consts,
              int k, long long n_tri, float* partials, cudaStream_t stream) {
  const size_t smem = (size_t)(k * D + k / 32) * sizeof(float);
  gh_tiles<D><<<(unsigned)n_tri, k, smem, stream>>>(x, n, h_inv, consts, k, partials);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// x: (n, d) row-major, h_inv: (d, d), consts: (c_k, c_kk), 1 <= d <= 8;
// partials holds n_tri floats with n_tri = T(T+1)/2, T = ceil(n/k).
// Returns the cudaError_t of the launches.
extern "C" int gh_fused_sum_launch(const float* x, int n, int d,
                                   const float* h_inv, const float* consts,
                                   int k, float* partials, float* out,
                                   void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const long long n_tiles = (n + k - 1) / k;
  const long long n_tri = n_tiles * (n_tiles + 1) / 2;
  int err;
  switch (d) {
    case 1: err = launch_gh<1>(x, n, h_inv, consts, k, n_tri, partials, s); break;
    case 2: err = launch_gh<2>(x, n, h_inv, consts, k, n_tri, partials, s); break;
    case 3: err = launch_gh<3>(x, n, h_inv, consts, k, n_tri, partials, s); break;
    case 4: err = launch_gh<4>(x, n, h_inv, consts, k, n_tri, partials, s); break;
    case 5: err = launch_gh<5>(x, n, h_inv, consts, k, n_tri, partials, s); break;
    case 6: err = launch_gh<6>(x, n, h_inv, consts, k, n_tri, partials, s); break;
    case 7: err = launch_gh<7>(x, n, h_inv, consts, k, n_tri, partials, s); break;
    case 8: err = launch_gh<8>(x, n, h_inv, consts, k, n_tri, partials, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != (int)cudaSuccess) return err;
  sum_tile_partials<<<1, 256, 0, s>>>(partials, n_tri, out);
  return (int)cudaGetLastError();
}
