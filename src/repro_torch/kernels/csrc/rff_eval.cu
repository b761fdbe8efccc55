// Random-Fourier-feature density dots of a fitted RFF synopsis:
//   raw[p] = sum_j cos(w_j . x_p + b_j) z_j
// for m points against D features (the caller applies the kernel norm).
//
// Replaces the TPU kernel repro/kernels/rff_eval.py, rff_density (its
// pallas_call _kernel).
//
// Bound on the H100: operations.  Each (point, feature) pair is d FMAs of
// the projection, one cosine and one FMA: 6.7e7 pairs at m = 32768 nodes
// and D = 2048 against (m + D) d floats of input.  The projection reaches
// hundreds of radians for small H and far nodes, so the cosine is cosf with
// its full range reduction: no fast-math build and no __cosf, whose error
// grows with the argument.  The TPU kernel keeps a (point tile) accumulator
// resident across sequential feature tiles; here each block owns a point
// tile (one point per thread, in registers) and one chunk of features staged
// in shared memory (w, b, z), writes one partial per (chunk, point), and a
// second kernel adds the chunks in order (common.cuh), so the same inputs
// give the same bits.  Feature chunks also give the grid enough blocks: 128
// point tiles x 8 chunks at m = 32768, D = 2048.  The ragged edges of m and
// D are masked here; the reference relies on zero-padded z instead.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

// blockDim.x points per block (blockIdx.x), fk features per chunk
// (blockIdx.y); dynamic shared memory fk * (D + 2) floats.
// partials: (n_chunks, m).
template <int D>
__global__ void rff_tiles(const float* __restrict__ pts, int m,
                          const float* __restrict__ w,
                          const float* __restrict__ b,
                          const float* __restrict__ z, int nf, int fk,
                          float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* ws = smem;              // fk x D frequencies
  float* bs = smem + fk * D;     // fk phases
  float* zs = bs + fk;           // fk weights
  const int base = blockIdx.y * fk;
  const int cnt = min(fk, nf - base);
  for (int e = threadIdx.x; e < cnt * D; e += blockDim.x)
    ws[e] = w[(size_t)base * D + e];
  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    bs[e] = b[base + e];
    zs[e] = z[base + e];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float p[D];
#pragma unroll
  for (int a = 0; a < D; ++a) p[a] = pts[(size_t)i * D + a];
  float acc = 0.0f;
  for (int j = 0; j < cnt; ++j) {
    float dot = ws[j * D] * p[0];
#pragma unroll
    for (int a = 1; a < D; ++a) dot = fmaf(ws[j * D + a], p[a], dot);
    acc = fmaf(cosf(dot + bs[j]), zs[j], acc);
  }
  partials[(size_t)blockIdx.y * m + i] = acc;
}

template <int D>
cudaError_t launch_d(const float* pts, int m, const float* w, const float* b,
                     const float* z, int nf, int pk, int fk, float* partials,
                     float* out, cudaStream_t stream) {
  const int n_chunks = (nf + fk - 1) / fk;
  const dim3 grid((m + pk - 1) / pk, n_chunks);
  rff_tiles<D><<<grid, pk, (size_t)fk * (D + 2) * sizeof(float), stream>>>(
      pts, m, w, b, z, nf, fk, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partial_columns<<<(m + 255) / 256, 256, 0, stream>>>(partials, n_chunks, m, out);
  return cudaGetLastError();
}

}  // namespace repro_torch

// pts: (m, d), w: (D, d) row-major, b/z: (D,); 1 <= d <= 8, pk points per
// block (a multiple of 32), fk features per chunk; partials holds
// ceil(D/fk) * m floats.  Returns the cudaError_t of the launches.
extern "C" int rff_density_launch(const float* pts, int m, int d, const float* w,
                                  const float* b, const float* z, int nf, int pk,
                                  int fk, float* partials, float* out,
                                  void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (d) {
    case 1: return (int)launch_d<1>(pts, m, w, b, z, nf, pk, fk, partials, out, s);
    case 2: return (int)launch_d<2>(pts, m, w, b, z, nf, pk, fk, partials, out, s);
    case 3: return (int)launch_d<3>(pts, m, w, b, z, nf, pk, fk, partials, out, s);
    case 4: return (int)launch_d<4>(pts, m, w, b, z, nf, pk, fk, partials, out, s);
    case 5: return (int)launch_d<5>(pts, m, w, b, z, nf, pk, fk, partials, out, s);
    case 6: return (int)launch_d<6>(pts, m, w, b, z, nf, pk, fk, partials, out, s);
    case 7: return (int)launch_d<7>(pts, m, w, b, z, nf, pk, fk, partials, out, s);
    case 8: return (int)launch_d<8>(pts, m, w, b, z, nf, pk, fk, partials, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
