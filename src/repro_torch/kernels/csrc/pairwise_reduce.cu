// Triangular pairwise derivative-kernel sum, sum_{i<j} K^(r)((x_i - x_j)/g),
// for PLUGIN's Psi6 (K^(6), eq. 16) and Psi4 (K^(4), eq. 18).
//
// Replaces the TPU kernel repro/kernels/pairwise_reduce.py,
// pairwise_scaled_ksum (its pallas_call _kernel).
//
// Bound on the H100: operations, not bytes.  n = 32768 reads 128 KiB once
// but evaluates 5.4e8 pairs, each an expf (an SFU ex2) and about a dozen
// FP32 operations.  The design keeps every operand on chip: one block per
// upper-triangle tile (the paper's Fig. 3 schema, eqs. 49/50 turning the 1-D
// block index into the tile's row q and column l), the column chunk staged in
// shared memory (Fig. 5), the row value in a register, so the inner loop is
// a shared-memory broadcast read and the kernel arithmetic.  Each block
// reduces into one float partial in a fixed tree; a second one-block kernel
// sums the partials in a fixed order (no float atomics), so the result is
// the same bits run to run.  g is read from device memory, as the TPU kernel
// reads g_ref, so PLUGIN needs no host sync between Psi6 and Psi4.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

template <int KIND>
__device__ __forceinline__ float kfun(float t) {
  const float t2 = t * t;
  const float ph = kInvSqrt2Pi * expf(-0.5f * t2);
  if (KIND == 0) return ((t2 - 6.0f) * t2 + 3.0f) * ph;                    // K^(4)
  if (KIND == 1) return (((t2 - 15.0f) * t2 + 45.0f) * t2 - 15.0f) * ph;   // K^(6)
  return ph;                                                              // K
}

// blockDim.x == k (a multiple of 32); dynamic shared memory k + k/32 floats.
template <int KIND>
__global__ void pairwise_tiles(const float* __restrict__ x, int n,
                               const float* __restrict__ g, int k,
                               float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* cols = smem;          // column chunk l
  float* warp_acc = smem + k;  // one slot per warp
  int q, l;
  bx_to_ql(blockIdx.x, &q, &l);
  const int t = threadIdx.x;
  const int j0 = l * k;
  const int i = q * k + t;
  cols[t] = (j0 + t < n) ? x[j0 + t] : 0.0f;
  const float inv_g = 1.0f / g[0];
  const float xi = (i < n) ? x[i] : 0.0f;
  __syncthreads();

  float acc = 0.0f;
  if (i < n) {
    // pairs i < j < n: on the diagonal tile only the columns after row t
    const int c_begin = (q == l) ? t + 1 : 0;
    const int c_end = min(k, n - j0);
    for (int c = c_begin; c < c_end; ++c) acc += kfun<KIND>((xi - cols[c]) * inv_g);
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

__global__ void triangle_map(long long n_tri, int* __restrict__ q,
                             int* __restrict__ l) {
  const long long bx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= n_tri) return;
  int qq, ll;
  bx_to_ql(bx, &qq, &ll);
  q[bx] = qq;
  l[bx] = ll;
}

}  // namespace repro_torch

// kind: 0 = K^(4), 1 = K^(6), 2 = Gaussian.  partials holds n_tri floats with
// n_tri = T(T+1)/2, T = ceil(n/k).  Returns the cudaError_t of the launches.
extern "C" int pairwise_scaled_ksum_launch(const float* x, int n, const float* g,
                                           int kind, int k, float* partials,
                                           float* out, void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n_tiles = (n + k - 1) / k;
  const long long n_tri = n_tiles * (n_tiles + 1) / 2;
  const size_t smem = (size_t)(k + k / 32) * sizeof(float);
  switch (kind) {
    case 0: pairwise_tiles<0><<<(unsigned)n_tri, k, smem, stream>>>(x, n, g, k, partials); break;
    case 1: pairwise_tiles<1><<<(unsigned)n_tri, k, smem, stream>>>(x, n, g, k, partials); break;
    case 2: pairwise_tiles<2><<<(unsigned)n_tri, k, smem, stream>>>(x, n, g, k, partials); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_tile_partials<<<1, 256, 0, stream>>>(partials, n_tri, out);
  return (int)cudaGetLastError();
}

// The device-side eqs. 49/50 mapping for every bx < n_tri, for checks.
extern "C" int triangle_map_launch(long long n_tri, int* q, int* l,
                                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned blocks = (unsigned)((n_tri + 255) / 256);
  repro_torch::triangle_map<<<blocks, 256, 0, stream>>>(n_tri, q, l);
  return (int)cudaGetLastError();
}
