// Fused LSCV_H objective inner sum (paper §6.3, eqs. 32-35):
//   sum_{i<j} T_H(s_ij),  s_ij = (x_i - x_j)^T H^-1 (x_i - x_j),
//   T_H(s) = c_kk exp(-s/4) - 2 c_k exp(-s/2).
//
// Replaces the TPU kernel repro/kernels/gh_fused.py, gh_fused_sum (its
// pallas_call _kernel).
//
// Bound on the H100: the FP32 pipe's issue rate.  H^-1 changes at every
// Nelder-Mead step, so S cannot be precomputed (§4.5, last paragraph): each
// evaluation forms the quadratic forms of all 5.4e8 pairs (n = 32768) and
// reduces them in one pass, reading only n*d floats.  Per pair the work is
// d subtractions, d(d+1)/2 + d multiply-adds of the quadratic form, one SFU
// ex2 and two FMAs of T_H: 15 instructions at d = 3, against one SFU op, so
// the SM's 4 warp-instructions per clock bind, not its 16 ex2 per clock.
//
// What the design does about it: every instruction that is not that
// arithmetic goes.  The triangle tile is K x K with K = kRows * blockDim.x:
// each thread owns kRows = 4 rows (points and accumulators in registers), so
// one column read from shared memory serves 4 pairs; a column is padded to 1, 2, 4 or 8
// floats and read as 16-byte broadcasts (one float4 holds 4 columns at d = 1,
// 2 at d = 2, one at d = 3..4, half of one at d = 5..8).  The column loop is
// unrolled over kColStep columns with no per-pair bounds: tiles off the
// diagonal with every column below n take that path, and only the diagonal
// tiles and the ragged last tile column take the masked one, which sets the
// ex2 argument to -inf (the term is then exactly 0).  The ex2 is
// ex2.approx.ftz (common.cuh), without exp2f's denormal fix-ups: a term
// below 2^-126 * c_kk is flushed.  The quadratic form keeps the difference
// v = x_i - x_j (the TPU kernel's qe + qf - 2 e^T M f expansion cancels for
// close pairs), with M folded into its d(d+1)/2 symmetric coefficients
// pre-scaled by -log2(e)/4, so e4 = exp(-s/4) is one ex2, exp(-s/2) = e4^2
// and T_H = e4 (c_kk - 2 c_k e4).  c_k and c_kk are read from device
// memory, so the objective needs no host sync and no extra kernel before the
// launch.  Each block reduces into one partial in a fixed tree and a
// second one-block kernel adds the partials in a fixed order (no float
// atomics): two launches give the same bits.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

constexpr float kNegQuarterLog2e = -0.36067376022224085f;   // -log2(e) / 4
constexpr int kColStep = 8;   // columns per unrolled step (K is a multiple of 32)
constexpr int kRows = 4;      // rows per thread

// Floats one column takes in shared memory: d padded to 1, 2, 4 or 8.
template <int D>
struct ColPad {
  static constexpr int P = D == 1 ? 1 : D == 2 ? 2 : D <= 4 ? 4 : 8;
  static constexpr int kVec = P <= 4 ? 1 : 2;   // float4 loads per column group
  static constexpr int kCols = P <= 4 ? 4 / P : 1;   // columns per group
};

// e4 = exp(-s/4) of one pair from the scaled coefficients c (row-major upper
// triangle of M with the off-diagonal pairs folded).
template <int D>
__device__ __forceinline__ float pair_arg(const float (&xi)[D],
                                          const float* col,
                                          const float (&c)[D * (D + 1) / 2]) {
  float v[D];
#pragma unroll
  for (int a = 0; a < D; ++a) v[a] = xi[a] - col[a];
  float s = 0.0f;
  int e = 0;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    float w = c[e++] * v[a];
#pragma unroll
    for (int b = a + 1; b < D; ++b) w = fmaf(c[e++], v[b], w);
    s = fmaf(v[a], w, s);
  }
  return s;
}

// Columns [c_lo, c_hi) of the tile (multiples of kColStep) against the
// thread's R rows.  MASKED: pair (row r, column c) counts only when
// lim[r] < c < c_end.
template <int D, int R, bool MASKED>
__device__ __forceinline__ void walk_columns(const float4* __restrict__ cols4,
                                             int c_lo, int c_hi,
                                             const float (&xi)[R][D],
                                             const float (&c)[D * (D + 1) / 2],
                                             float c_kk, float m2ck,
                                             const int (&lim)[R], int c_end,
                                             float (&acc)[R]) {
  using Pad = ColPad<D>;
  constexpr int kGroups = kColStep / Pad::kCols;
  for (int c0 = c_lo; c0 < c_hi; c0 += kColStep) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int cg = c0 + g * Pad::kCols;   // first column of the group
      float buf[4 * Pad::kVec];
#pragma unroll
      for (int u = 0; u < Pad::kVec; ++u) {
        const float4 f = cols4[(cg * Pad::P) / 4 + u];
        buf[4 * u] = f.x;
        buf[4 * u + 1] = f.y;
        buf[4 * u + 2] = f.z;
        buf[4 * u + 3] = f.w;
      }
#pragma unroll
      for (int cc = 0; cc < Pad::kCols; ++cc) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = pair_arg<D>(xi[r], buf + cc * Pad::P, c);
          if (MASKED) s = (cg + cc > lim[r] && cg + cc < c_end) ? s : -INFINITY;
          const float e4 = ex2_ftz(s);
          acc[r] = fmaf(e4, fmaf(m2ck, e4, c_kk), acc[r]);
        }
      }
    }
  }
}

// blockDim.x = T (a multiple of 32), tile side K = kRows * T; dynamic shared
// memory K * ColPad<D>::P floats.  Thread t owns rows q*K + r*T + t.
template <int D>
__global__ void gh_tiles(const float* __restrict__ x, int n,
                         const float* __restrict__ h_inv,
                         const float* __restrict__ c_k_ptr,
                         const float* __restrict__ c_kk_ptr,
                         float* __restrict__ partials) {
  using Pad = ColPad<D>;
  constexpr int R = kRows;
  constexpr int kCoef = D * (D + 1) / 2;
  extern __shared__ float4 cols4[];
  float* cols = reinterpret_cast<float*>(cols4);
  __shared__ float coef[kCoef];
  __shared__ float warp_acc[32];
  const int T = blockDim.x;
  const int K = R * T;
  const int t = threadIdx.x;
  int q, l;
  bx_to_ql(blockIdx.x, &q, &l);
  const long long i0 = (long long)q * K;
  const long long j0 = (long long)l * K;
  for (int e = t; e < K * Pad::P; e += T) {
    const int cc = e / Pad::P, a = e % Pad::P;
    cols[e] = (a < D && j0 + cc < n) ? x[(j0 + cc) * D + a] : 0.0f;
  }
  for (int e = t; e < kCoef; e += T) {
    int a = 0, rem = e;
    while (rem >= D - a) { rem -= D - a; ++a; }
    const int b = a + rem;
    const float mab = (a == b) ? h_inv[a * D + a] : h_inv[a * D + b] + h_inv[b * D + a];
    coef[e] = kNegQuarterLog2e * mab;
  }
  float xi[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = i0 + r * T + t;
#pragma unroll
    for (int a = 0; a < D; ++a) xi[r][a] = (i < n) ? x[i * D + a] : 0.0f;
  }
  const float c_kk = c_kk_ptr[0];
  const float m2ck = -2.0f * c_k_ptr[0];
  __syncthreads();

  float c[kCoef];
#pragma unroll
  for (int e = 0; e < kCoef; ++e) c[e] = coef[e];
  float acc[R];
  int lim[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = 0.0f;
    // pairs i < j < n: on the diagonal tile the columns after the row
    lim[r] = (q == l) ? r * T + t : -1;
  }
  const int c_end = (int)min((long long)K, n - j0);
  if (q == l || c_end < K) {
    const int c_hi = (c_end + kColStep - 1) / kColStep * kColStep;
    walk_columns<D, R, true>(cols4, 0, c_hi, xi, c, c_kk, m2ck, lim, c_end, acc);
  } else {
    walk_columns<D, R, false>(cols4, 0, K, xi, c, c_kk, m2ck, lim, c_end, acc);
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
    if (t == 0) partials[blockIdx.x] = v;
  }
}

template <int D>
void launch_gh(const float* x, int n, const float* h_inv, const float* c_k,
               const float* c_kk, int threads, long long n_tri, float* partials,
               cudaStream_t s) {
  const size_t smem = (size_t)kRows * threads * ColPad<D>::P * sizeof(float);
  gh_tiles<D><<<(unsigned)n_tri, threads, smem, s>>>(x, n, h_inv, c_k, c_kk,
                                                     partials);
}

}  // namespace repro_torch

// x: (n, d) row-major, h_inv: (d, d), 1 <= d <= 8; c_k, c_kk: one float
// each in device memory.  Tiles of side K = 4 * threads, threads a multiple
// of 32; partials holds n_tri floats with n_tri = T(T+1)/2, T = ceil(n/K).
// Returns the cudaError_t of the launches.
extern "C" int gh_fused_sum_launch(const float* x, int n, int d,
                                   const float* h_inv, const float* c_k,
                                   const float* c_kk, int threads,
                                   float* partials, float* out,
                                   void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const long long k = (long long)kRows * threads;
  const long long n_tiles = (n + k - 1) / k;
  const long long n_tri = n_tiles * (n_tiles + 1) / 2;
  switch (d) {
    case 1: launch_gh<1>(x, n, h_inv, c_k, c_kk, threads, n_tri, partials, s); break;
    case 2: launch_gh<2>(x, n, h_inv, c_k, c_kk, threads, n_tri, partials, s); break;
    case 3: launch_gh<3>(x, n, h_inv, c_k, c_kk, threads, n_tri, partials, s); break;
    case 4: launch_gh<4>(x, n, h_inv, c_k, c_kk, threads, n_tri, partials, s); break;
    case 5: launch_gh<5>(x, n, h_inv, c_k, c_kk, threads, n_tri, partials, s); break;
    case 6: launch_gh<6>(x, n, h_inv, c_k, c_kk, threads, n_tri, partials, s); break;
    case 7: launch_gh<7>(x, n, h_inv, c_k, c_kk, threads, n_tri, partials, s); break;
    case 8: launch_gh<8>(x, n, h_inv, c_k, c_kk, threads, n_tri, partials, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_tile_partials<<<1, 256, 0, s>>>(partials, n_tri, out);
  return (int)cudaGetLastError();
}
