// Triangular pairwise derivative-kernel sum, sum_{i<j} K^(r)((x_i - x_j)/g),
// for PLUGIN's Psi6 (K^(6), eq. 16) and Psi4 (K^(4), eq. 18).
//
// Replaces the TPU kernel repro/kernels/pairwise_reduce.py,
// pairwise_scaled_ksum (its pallas_call _kernel).
//
// Bound on the H100: the SFU.  n = 32768 reads 128 KiB once but evaluates
// 5.4e8 pairs, each one exponential.  At 16 MUFU ops per clock per SM a
// pair holds a quarter SM's 4 SFU lanes for 8 cycles per warp, against 7
// FP32-pipe instructions (K^(6)) at one issue per cycle: the SFU binds, and
// every instruction beside the arithmetic eats into the slack.
//
// What the design does about it: the exponent's constants are folded so
// that a term is one subtraction, one square, one ex2.approx.ftz
// (common.cuh), t^2 and the polynomial.  x is scaled once as it is staged,
// by s = sqrt(c) / g with c = log2(e) / 2, after subtracting x[0] (so the
// rounding follows the data's spread, not its offset): then u = s (x_i -
// x_j) and v = -u^2 give exp(-t^2 / 2) = 2^v, and t^2 = v (-1 / c) feeds
// the polynomial with its integer coefficients, ((t^2 - 15) t^2 + 45) t^2 -
// 15 for K^(6), (t^2 - 6) t^2 + 3 for K^(4).  The coefficients must stay
// exact: Psi6's terms cancel about 10^4-fold at n = 32768, so a coefficient
// rounded to float (as in a polynomial in v, 15c, 45c^2, 15c^3) moves the
// sum by 6e-4 of itself, twice the tolerance, while a uniform scale of t^2
// moves it by a few times its own rounding.  1/sqrt(2 pi) is applied once per
// block.  g is read from device memory, as the TPU kernel reads g_ref, so
// PLUGIN needs no host sync between Psi6 and Psi4.  A 2^v below 2^-126 is
// flushed: |t| > 13.2, where even t^6 phi(t) is below 1e-30.
//
// The tiles stay the paper's Fig. 3 schema: one block per upper-triangle
// tile of side K = kRows * blockDim.x, the 1-D block index turned into the
// tile's row q and column l by eqs. 49/50 (bx_to_ql, common.cuh).  Each
// thread owns kRows rows in registers (r * T + t), and the column chunk is
// read from shared memory as 16-byte broadcasts, so one load serves 4 kRows
// pairs.  A tile off the diagonal walks its columns below n, the same count
// for every lane.  A diagonal tile of side m (K, or what is left of n)
// walks its strict upper triangle as a circle: row i takes columns
// (i + o) mod m for o = 1 .. (m - 1) / 2, and rows i < m / 2 also o = m / 2
// when m is even, which covers every pair i < j once (the kernels are even
// in t, so (i, j) and (j, i) give the same term bit for bit); every lane
// takes the same count, none idles for half the tile.  Each block reduces
// into one float partial in a fixed tree; a second one-block kernel sums the
// partials in a fixed order (no float atomics), so two launches give the
// same bits.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kRows = 4;   // rows per thread
constexpr float kSqrtHalfLog2e = 0.84932180028801904272f;   // sqrt(log2(e) / 2)
constexpr float kNegTwoLn2 = -1.38629436111989061883f;      // -1 / (log2(e) / 2)

// The term of a pair from its scaled values, without 1/sqrt(2 pi).
template <int KIND>
__device__ __forceinline__ float term(float xi, float xj, float acc) {
  const float d = xi - xj;
  const float v = d * -d;
  const float e = ex2_ftz(v);
  const float t2 = v * kNegTwoLn2;
  if (KIND == 0) return fmaf(fmaf(t2 - 6.0f, t2, 3.0f), e, acc);                     // K^(4)
  if (KIND == 1) return fmaf(fmaf(fmaf(t2 - 15.0f, t2, 45.0f), t2, -15.0f), e, acc);  // K^(6)
  return acc + e;                                                                   // K
}

// blockDim.x = T (a multiple of 32), tile side K = kRows * T; dynamic shared
// memory K floats.  Block b sums triangle tile begin + b into partials[b].
template <int KIND>
__global__ void pairwise_tiles(const float* __restrict__ x, int n,
                               const float* __restrict__ g, long long begin,
                               float* __restrict__ partials) {
  constexpr int R = kRows;
  extern __shared__ float4 cols4[];
  float* cols = reinterpret_cast<float*>(cols4);
  __shared__ float warp_acc[32];
  const int T = blockDim.x;
  const int K = R * T;
  const int t = threadIdx.x;
  int q, l;
  bx_to_ql(begin + blockIdx.x, &q, &l);
  const int i0 = q * K;
  const int j0 = l * K;
  const float s = kSqrtHalfLog2e / g[0];
  const float x0 = x[0];
  for (int c = t; c < K; c += T) cols[c] = (j0 + c < n) ? (x[j0 + c] - x0) * s : 0.0f;
  float xi[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * T + t;
    xi[r] = (i < n) ? (x[i] - x0) * s : 0.0f;
    acc[r] = 0.0f;
  }
  __syncthreads();

  if (q != l) {
    // every row lies below n; columns j0 .. min(j0 + K, n) - 1
    const int c_end = min(K, n - j0);
    const int c4 = c_end >> 2;
#pragma unroll 2
    for (int v4 = 0; v4 < c4; ++v4) {
      const float4 f = cols4[v4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r] = term<KIND>(xi[r], f.x, acc[r]);
        acc[r] = term<KIND>(xi[r], f.y, acc[r]);
        acc[r] = term<KIND>(xi[r], f.z, acc[r]);
        acc[r] = term<KIND>(xi[r], f.w, acc[r]);
      }
    }
    for (int c = 4 * c4; c < c_end; ++c) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = term<KIND>(xi[r], cols[c], acc[r]);
    }
  } else {
    // the diagonal tile of side m as a circle (the columns are its rows)
    const int m = min(K, n - i0);
    const int half = (m - 1) >> 1;
    int lr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) lr[r] = r * T + t;
    if (m == K) {   // every row of the tile lies below n
      for (int o = 1; o <= half; ++o) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = lr[r] + o;
          acc[r] = term<KIND>(xi[r], cols[j >= m ? j - m : j], acc[r]);
        }
      }
    } else {
      for (int o = 1; o <= half; ++o) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = lr[r] + o;
          if (lr[r] < m) acc[r] = term<KIND>(xi[r], cols[j >= m ? j - m : j], acc[r]);
        }
      }
    }
    if ((m & 1) == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (lr[r] < (m >> 1)) acc[r] = term<KIND>(xi[r], cols[min(lr[r] + (m >> 1), K - 1)], acc[r]);
    }
  }

  float sum = acc[0];
#pragma unroll
  for (int r = 1; r < R; ++r) sum += acc[r];
  sum = warp_sum(sum);
  if ((t & 31) == 0) warp_acc[t >> 5] = sum;
  __syncthreads();
  if (t < 32) {
    float v = (t < (T >> 5)) ? warp_acc[t] : 0.0f;
    v = warp_sum(v);
    if (t == 0) partials[blockIdx.x] = v * kInvSqrt2Pi;
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

// kind: 0 = K^(4), 1 = K^(6), 2 = Gaussian.  x: (n,) with n >= 2; g: one
// float in device memory.  Tiles of side k, a multiple of 32 kRows, with
// k / kRows threads (at most 1024).  The launch sums the count triangle
// tiles begin .. begin + count - 1 of the n_tri = T(T+1)/2, T = ceil(n/k)
// (0 and n_tri: the whole triangle; a share of it is one rank's part of a
// distributed sum); partials holds count floats, count >= 1.  Returns the
// cudaError_t of the launches.
extern "C" int pairwise_scaled_ksum_launch(const float* x, int n, const float* g,
                                           int kind, int k, long long begin,
                                           long long count, float* partials,
                                           float* out, void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k % (32 * kRows) != 0 || k / kRows > 1024) return (int)cudaErrorInvalidValue;
  const int threads = k / kRows;
  const long long n_tiles = ((long long)n + k - 1) / k;
  const long long n_tri = n_tiles * (n_tiles + 1) / 2;
  if (begin < 0 || count < 1 || begin + count > n_tri) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)k * sizeof(float);
  const unsigned blocks = (unsigned)count;
  switch (kind) {
    case 0: pairwise_tiles<0><<<blocks, threads, smem, stream>>>(x, n, g, begin, partials); break;
    case 1: pairwise_tiles<1><<<blocks, threads, smem, stream>>>(x, n, g, begin, partials); break;
    case 2: pairwise_tiles<2><<<blocks, threads, smem, stream>>>(x, n, g, begin, partials); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_tile_partials<<<1, 256, 0, stream>>>(partials, count, out);
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
