// Random-Fourier-feature density dots of a fitted RFF synopsis:
//   raw[p] = sum_j cos(w_j . x_p + b_j) z_j
// for m points against D features (the caller applies the kernel norm),
// together with the same dot over each of B feature blocks (the feature
// batch-means CI's replicates) in the same launch.
//
// Replaces the TPU kernel repro/kernels/rff_eval.py, rff_density (its
// pallas_call _kernel).
//
// Bound on the H100: operations.  Each (point, feature) pair is d FMAs of
// the projection, the phase add, one cosine and one FMA: 6.7e7 pairs at
// m = 32768 nodes and D = 2048 against (m + D) d floats of input.  The
// projection reaches hundreds of radians for small H and far nodes, so a
// bare __cosf (cos.approx, whose error grows with the argument) is out;
// cosf with its full range reduction takes about 20 FP32-pipe instructions,
// two conversions and 35 issue slots a pair in its SASS.
//
// What the design does about it: the cosine takes a Cody-Waite reduction to
// [-pi, pi] (k = rint(x / 2 pi) by the magic-number add, r = x - k 2 pi in
// two FMAs with 2 pi split into its float and the rest) and then the
// hardware cosine on that range (cos.approx, one MUFU op): 7 FP32-pipe
// instructions and one MUFU a pair with the projection, which balance at
// 128 and 16 a clock per SM.  The sums stay within 2e-5 of float64 at the
// main path's largest projections (chip_smoke.py).  One launch serves the
// estimate and the B blocks: feature chunks are aligned on the block
// boundaries (B chunks of cb = D / B features and a remainder chunk of D - B
// cb), each chunk split into sub-chunks of at most fk features staged in
// shared memory as one 16-byte-aligned record a feature (w, b, z, padded to
// 4, 8 or 12 floats), read as float4 broadcasts.  A block owns kPoints
// points per thread in registers, so one record read serves kPoints pairs;
// each point's sum runs over its sub-chunk's features in order.  A second
// kernel adds each chunk's sub-chunks in order into its block dot, and the
// chunks, the remainder last, in order into the estimate (no float atomics:
// the same inputs give the same bits).  With B = 1 the estimate alone is
// `rff_density`.  The ragged edges of m and D are masked here; the reference
// relies on zero-padded z instead.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kPoints = 4;      // points per thread
constexpr float kInv2Pi = 0.15915494309189533577f;
constexpr float k2PiHi = 6.28318548202514648438f;      // float(2 pi)
constexpr float k2PiLo = -1.74845553146951215e-07f;    // 2 pi - k2PiHi
constexpr float kRoundMagic = 12582912.0f;             // 1.5 * 2^23

__device__ __forceinline__ float rff_cos(float x) {
  const float k = (x * kInv2Pi + kRoundMagic) - kRoundMagic;   // rint(x / 2 pi)
  float r = fmaf(-k, k2PiHi, x);
  r = fmaf(-k, k2PiLo, r);
  return __cosf(r);
}

// Floats of one feature record in shared memory: d + 2 padded to 4, 8, 12.
template <int D>
struct Rec {
  static constexpr int F = (D + 2 + 3) / 4 * 4;
};

// Sub-chunk y of the launch: its first feature and its count.  Chunks
// 0..B-1 hold cb features, split into spc sub-chunks of at most fk; the
// remainder chunk's rem features follow.
__device__ __forceinline__ void sub_chunk(int y, int n_blocks, int cb, int rem,
                                          int fk, int* base, int* cnt) {
  const int spc = (cb + fk - 1) / fk;
  if (y < n_blocks * spc) {
    const int k = y / spc, s = y % spc;
    *base = k * cb + s * fk;
    *cnt = min(fk, cb - s * fk);
  } else {
    const int s = y - n_blocks * spc;
    *base = n_blocks * cb + s * fk;
    *cnt = min(fk, rem - s * fk);
  }
}

// blockDim.x threads of kPoints points each (blockIdx.x), one sub-chunk of
// features (blockIdx.y); dynamic shared memory fk * Rec<D>::F floats.
// partials: (n_sub, m).
template <int D>
__global__ void rff_tiles(const float* __restrict__ pts, int m,
                          const float* __restrict__ w,
                          const float* __restrict__ b,
                          const float* __restrict__ z, int n_blocks, int cb,
                          int rem, int fk, float* __restrict__ partials) {
  constexpr int F = Rec<D>::F;
  extern __shared__ float4 recs4[];
  float* recs = reinterpret_cast<float*>(recs4);
  int base, cnt;
  sub_chunk(blockIdx.y, n_blocks, cb, rem, fk, &base, &cnt);
  for (int e = threadIdx.x; e < cnt * F; e += blockDim.x) {
    const int j = e / F, a = e % F;
    const int f = base + j;
    recs[e] = a < D ? w[(size_t)f * D + a] : (a == D ? b[f] : (a == D + 1 ? z[f] : 0.0f));
  }
  const int T = blockDim.x;
  const int i0 = blockIdx.x * kPoints * T + threadIdx.x;
  float p[kPoints][D], acc[kPoints];
#pragma unroll
  for (int r = 0; r < kPoints; ++r) {
    const int i = i0 + r * T;
#pragma unroll
    for (int a = 0; a < D; ++a) p[r][a] = (i < m) ? pts[(size_t)i * D + a] : 0.0f;
    acc[r] = 0.0f;
  }
  __syncthreads();
  for (int j = 0; j < cnt; ++j) {
    float rec[F];
#pragma unroll
    for (int u = 0; u < F / 4; ++u) {
      const float4 v = recs4[j * (F / 4) + u];
      rec[4 * u] = v.x;
      rec[4 * u + 1] = v.y;
      rec[4 * u + 2] = v.z;
      rec[4 * u + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < kPoints; ++r) {
      float dot = rec[0] * p[r][0];
#pragma unroll
      for (int a = 1; a < D; ++a) dot = fmaf(rec[a], p[r][a], dot);
      acc[r] = fmaf(rff_cos(dot + rec[D]), rec[D + 1], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kPoints; ++r) {
    const int i = i0 + r * T;
    if (i < m) partials[(size_t)blockIdx.y * m + i] = acc[r];
  }
}

// out: (n_blocks + 1, m), row 0 the estimate, row 1 + k block k.  Each
// thread sums one point's sub-chunks in order into its block dots and those,
// then the remainder's, in order into the estimate.
__global__ void rff_combine(const float* __restrict__ partials, int m,
                            int n_blocks, int spc, int spr,
                            float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float est = 0.0f;
  int y = 0;
  for (int k = 0; k < n_blocks; ++k) {
    float s = 0.0f;
    for (int u = 0; u < spc; ++u, ++y) s += partials[(size_t)y * m + i];
    out[(size_t)(1 + k) * m + i] = s;
    est = k == 0 ? s : est + s;
  }
  float s = 0.0f;
  for (int u = 0; u < spr; ++u, ++y) s += partials[(size_t)y * m + i];
  out[i] = spr ? est + s : est;
}

template <int D>
cudaError_t launch_d(const float* pts, int m, const float* w, const float* b,
                     const float* z, int n_blocks, int cb, int rem, int threads,
                     int fk, int n_sub, float* partials, cudaStream_t stream) {
  const dim3 grid((m + kPoints * threads - 1) / (kPoints * threads), n_sub);
  rff_tiles<D><<<grid, threads, (size_t)fk * Rec<D>::F * sizeof(float), stream>>>(
      pts, m, w, b, z, n_blocks, cb, rem, fk, partials);
  return cudaGetLastError();
}

}  // namespace repro_torch

// pts: (m, d), w: (D, d) row-major, b/z: (D,); 1 <= d <= 8, m >= 1;
// 1 <= n_blocks <= D; `threads` per block (a multiple of 32) of 4 points
// each; fk features per sub-chunk.  partials holds n_sub * m floats with
// n_sub = n_blocks * ceil(cb / fk) + ceil(rem / fk), cb = D / n_blocks,
// rem = D - n_blocks * cb; out (n_blocks + 1) * m.  Returns the cudaError_t
// of the launches.
extern "C" int rff_density_blocks_launch(const float* pts, int m, int d,
                                         const float* w, const float* b,
                                         const float* z, int nf, int n_blocks,
                                         int threads, int fk, float* partials,
                                         float* out, void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const int cb = nf / n_blocks;
  const int rem = nf - n_blocks * cb;
  const int spc = (cb + fk - 1) / fk;
  const int spr = (rem + fk - 1) / fk;
  const int n_sub = n_blocks * spc + spr;
  cudaError_t err;
  switch (d) {
    case 1: err = launch_d<1>(pts, m, w, b, z, n_blocks, cb, rem, threads, fk, n_sub, partials, s); break;
    case 2: err = launch_d<2>(pts, m, w, b, z, n_blocks, cb, rem, threads, fk, n_sub, partials, s); break;
    case 3: err = launch_d<3>(pts, m, w, b, z, n_blocks, cb, rem, threads, fk, n_sub, partials, s); break;
    case 4: err = launch_d<4>(pts, m, w, b, z, n_blocks, cb, rem, threads, fk, n_sub, partials, s); break;
    case 5: err = launch_d<5>(pts, m, w, b, z, n_blocks, cb, rem, threads, fk, n_sub, partials, s); break;
    case 6: err = launch_d<6>(pts, m, w, b, z, n_blocks, cb, rem, threads, fk, n_sub, partials, s); break;
    case 7: err = launch_d<7>(pts, m, w, b, z, n_blocks, cb, rem, threads, fk, n_sub, partials, s); break;
    case 8: err = launch_d<8>(pts, m, w, b, z, n_blocks, cb, rem, threads, fk, n_sub, partials, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  rff_combine<<<(m + 255) / 256, 256, 0, s>>>(partials, m, n_blocks, spc, spr, out);
  return (int)cudaGetLastError();
}
