// Dense quadratic-form precompute of LSCV_h (paper §4.5, eq. 39; §5.5,
// Fig. 6): S_ij = (x_i - x_j)^T M (x_i - x_j) on the strict upper triangle,
// 0 on the diagonal and below, as a dense (n, n) float32 matrix.
//
// Replaces the TPU kernel repro/kernels/sv_precompute.py, sv_matrix (its
// pallas_call _kernel).
//
// Bound on the H100: bytes.  The output is n^2 floats (4.29 GB at n = 32768)
// against n*d floats of input; the arithmetic (d subtractions and
// d(d+1)/2 + d FMAs per element) is far below the write time.  The TPU
// kernel's "mxu" variant expands S = qe + qf - 2 e^T M f, which cancels in
// float32 for close pairs; this kernel forms the difference v = x_i - x_j
// and s = v^T M v directly (eq. 60, the function both reference oracles
// compute) for either `algorithm` the wrapper is given.  v^T M v equals
// v^T ((M + M^T)/2) v for any M, so each block folds M into its
// d(d+1)/2 symmetric coefficients once, in shared memory.  A block owns
// kSvRows rows x blockDim.x columns of S: the row chunk, the column chunk
// and the coefficients are staged in shared memory, each thread keeps its
// column's point and the coefficients in registers and walks the rows, so
// every row of the tile is written by one coalesced store per warp.  Tiles
// wholly on or below the diagonal only write zeros.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kSvRows = 32;   // rows of S per block (one blockIdx.y)

// blockDim.x columns (a multiple of 32) per block; dynamic shared memory
// (kSvRows + blockDim.x) * D floats.
template <int D>
__global__ void sv_tiles(const float* __restrict__ x, int n,
                         const float* __restrict__ m,
                         float* __restrict__ out) {
  constexpr int kCoef = D * (D + 1) / 2;
  extern __shared__ float smem[];
  float* rows = smem;                   // kSvRows x D
  float* cols = smem + kSvRows * D;     // blockDim.x x D
  __shared__ float coef[kCoef];
  const int t = threadIdx.x;
  const int k = blockDim.x;
  const long long i0 = (long long)blockIdx.y * kSvRows;
  const long long j0 = (long long)blockIdx.x * k;
  const long long j = j0 + t;

  if (j0 + k - 1 <= i0) {               // tile on or below the diagonal
    for (int r = 0; r < kSvRows && i0 + r < n; ++r)
      if (j < n) out[(i0 + r) * n + j] = 0.0f;
    return;
  }
  for (int e = t; e < kSvRows * D; e += k)
    rows[e] = (i0 * D + e < (long long)n * D) ? x[i0 * D + e] : 0.0f;
  for (int e = t; e < k * D; e += k)
    cols[e] = (j0 * D + e < (long long)n * D) ? x[j0 * D + e] : 0.0f;
  for (int e = t; e < kCoef; e += k) {
    // e -> (a, b), a <= b, in row-major order of the upper triangle
    int a = 0, rem = e;
    while (rem >= D - a) { rem -= D - a; ++a; }
    const int b = a + rem;
    coef[e] = (a == b) ? m[a * D + a] : m[a * D + b] + m[b * D + a];
  }
  __syncthreads();

  float xj[D], c[kCoef];
#pragma unroll
  for (int a = 0; a < D; ++a) xj[a] = cols[t * D + a];
#pragma unroll
  for (int e = 0; e < kCoef; ++e) c[e] = coef[e];
  if (j >= n) return;
  for (int r = 0; r < kSvRows; ++r) {
    const long long i = i0 + r;
    if (i >= n) break;
    float v[D];
#pragma unroll
    for (int a = 0; a < D; ++a) v[a] = rows[r * D + a] - xj[a];
    float s = 0.0f;
    int e = 0;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float w = 0.0f;
#pragma unroll
      for (int b = a; b < D; ++b) w = fmaf(c[e++], v[b], w);
      s = fmaf(v[a], w, s);
    }
    out[i * n + j] = (i < j) ? s : 0.0f;
  }
}

template <int D>
int launch_sv(const float* x, int n, const float* m, int k, float* out,
              cudaStream_t stream) {
  const dim3 grid((unsigned)((n + k - 1) / k),
                  (unsigned)((n + kSvRows - 1) / kSvRows));
  const size_t smem = (size_t)(kSvRows + k) * D * sizeof(float);
  sv_tiles<D><<<grid, k, smem, stream>>>(x, n, m, out);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// x: (n, d) row-major, m: (d, d), out: (n, n); 1 <= d <= 16, k columns per
// block.  Returns the cudaError_t of the launch.
extern "C" int sv_matrix_launch(const float* x, int n, int d, const float* m,
                                int k, float* out, void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (d) {
    case 1: return launch_sv<1>(x, n, m, k, out, s);
    case 2: return launch_sv<2>(x, n, m, k, out, s);
    case 3: return launch_sv<3>(x, n, m, k, out, s);
    case 4: return launch_sv<4>(x, n, m, k, out, s);
    case 5: return launch_sv<5>(x, n, m, k, out, s);
    case 6: return launch_sv<6>(x, n, m, k, out, s);
    case 7: return launch_sv<7>(x, n, m, k, out, s);
    case 8: return launch_sv<8>(x, n, m, k, out, s);
    case 9: return launch_sv<9>(x, n, m, k, out, s);
    case 10: return launch_sv<10>(x, n, m, k, out, s);
    case 11: return launch_sv<11>(x, n, m, k, out, s);
    case 12: return launch_sv<12>(x, n, m, k, out, s);
    case 13: return launch_sv<13>(x, n, m, k, out, s);
    case 14: return launch_sv<14>(x, n, m, k, out, s);
    case 15: return launch_sv<15>(x, n, m, k, out, s);
    case 16: return launch_sv<16>(x, n, m, k, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
