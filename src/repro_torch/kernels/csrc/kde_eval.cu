// Direct scalar-h Gaussian KDE sums (paper eq. 3) at m evaluation points:
//   sums[p] = sum_i exp(-||p - x_i||^2 / (2 h^2))
// The caller applies norm / n = (2 pi)^(-d/2) h^(-d) / n, as the reference
// applies it outside its pallas_call.
//
// Replaces the TPU kernel repro/kernels/kde_eval.py, kde_eval (its
// pallas_call _kernel).
//
// Bound on the H100: operations.  Each (point, row) pair is d subtractions
// and d FMAs of the squared distance, one multiply and one exp: 1.3e8 pairs
// at m = 4096, n = 32768, against (m + n) d floats of input.  The TPU grid
// (eval tile, data tile) keeps the eval tile's accumulator resident across
// sequential data tiles; here a block owns one point tile (one point per
// thread, in registers) and one chunk of rows staged in shared memory, and
// writes one partial per (chunk, point); a second kernel adds each point's
// partials in chunk order (common.cuh), so the sums are the same bits run
// to run.  exp is folded into exp2 with a = -log2(e) / (2 h^2) formed once
// per thread from h in device memory (no host sync before the launch), so a
// term is one SFU ex2.  d is a template parameter (1..16), as in
// sv_precompute.cu, so the point stays in registers.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

constexpr float kNegHalfLog2e = -0.72134752044448170f;   // -log2(e) / 2

// blockDim.x points per block (blockIdx.x), k rows per chunk (blockIdx.y);
// dynamic shared memory k * D floats.  partials: (n_chunks, m).
template <int D>
__global__ void kde_tiles(const float* __restrict__ pts, int m,
                          const float* __restrict__ x, int n,
                          const float* __restrict__ h, int k,
                          float* __restrict__ partials) {
  extern __shared__ float xs[];
  const int base = blockIdx.y * k;
  const int rows = min(k, n - base);
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x)
    xs[e] = x[(size_t)base * D + e];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float hv = h[0];
  const float a = kNegHalfLog2e / (hv * hv);
  float p[D];
#pragma unroll
  for (int c = 0; c < D; ++c) p[c] = pts[(size_t)i * D + c];
  float acc = 0.0f;
  for (int r = 0; r < rows; ++r) {
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float v = p[c] - xs[r * D + c];
      s = fmaf(v, v, s);
    }
    acc += exp2f(a * s);
  }
  partials[(size_t)blockIdx.y * m + i] = acc;
}

template <int D>
cudaError_t launch_d(const float* pts, int m, const float* x, int n,
                     const float* h, int pk, int k, float* partials, float* out,
                     cudaStream_t stream) {
  const int n_chunks = (n + k - 1) / k;
  const dim3 grid((m + pk - 1) / pk, n_chunks);
  kde_tiles<D><<<grid, pk, (size_t)k * D * sizeof(float), stream>>>(pts, m, x, n, h,
                                                                     k, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partial_columns<<<(m + 255) / 256, 256, 0, stream>>>(partials, n_chunks, m, out);
  return cudaGetLastError();
}

}  // namespace repro_torch

// pts: (m, d), x: (n, d) row-major, h: one float on the device; 1 <= d <= 16,
// pk points per block (a multiple of 32), k rows per chunk; partials holds
// ceil(n/k) * m floats.  Returns the cudaError_t of the launches.
extern "C" int kde_eval_launch(const float* pts, int m, const float* x, int n,
                               int d, const float* h, int pk, int k,
                               float* partials, float* out, void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (d) {
    case 1: return (int)launch_d<1>(pts, m, x, n, h, pk, k, partials, out, s);
    case 2: return (int)launch_d<2>(pts, m, x, n, h, pk, k, partials, out, s);
    case 3: return (int)launch_d<3>(pts, m, x, n, h, pk, k, partials, out, s);
    case 4: return (int)launch_d<4>(pts, m, x, n, h, pk, k, partials, out, s);
    case 5: return (int)launch_d<5>(pts, m, x, n, h, pk, k, partials, out, s);
    case 6: return (int)launch_d<6>(pts, m, x, n, h, pk, k, partials, out, s);
    case 7: return (int)launch_d<7>(pts, m, x, n, h, pk, k, partials, out, s);
    case 8: return (int)launch_d<8>(pts, m, x, n, h, pk, k, partials, out, s);
    case 9: return (int)launch_d<9>(pts, m, x, n, h, pk, k, partials, out, s);
    case 10: return (int)launch_d<10>(pts, m, x, n, h, pk, k, partials, out, s);
    case 11: return (int)launch_d<11>(pts, m, x, n, h, pk, k, partials, out, s);
    case 12: return (int)launch_d<12>(pts, m, x, n, h, pk, k, partials, out, s);
    case 13: return (int)launch_d<13>(pts, m, x, n, h, pk, k, partials, out, s);
    case 14: return (int)launch_d<14>(pts, m, x, n, h, pk, k, partials, out, s);
    case 15: return (int)launch_d<15>(pts, m, x, n, h, pk, k, partials, out, s);
    case 16: return (int)launch_d<16>(pts, m, x, n, h, pk, k, partials, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
