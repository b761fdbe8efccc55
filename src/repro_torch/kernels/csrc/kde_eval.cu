// Direct scalar-h Gaussian KDE (paper eq. 3) at m evaluation points:
//   out[p] = (2 pi)^(-d/2) h^(-d) / n * sum_i exp(-||p - x_i||^2 / (2 h^2))
//
// Replaces the TPU kernel repro/kernels/kde_eval.py, kde_eval (its
// pallas_call _kernel; the normalisation it applies outside the call is
// applied here in the second kernel).
//
// Bound on the H100: operations, and among them the SFU.  A (point, row)
// pair is d subtractions, the sum of d squares and one exp2 against
// (m + n) d floats of input: at m = 4096, n = 32 768, 1.3e8 pairs and one
// MUFU op each, 0.032 ms at 16 MUFU a clock per SM.  The first design (one
// point per thread against a chunk of rows staged in shared memory) left
// most of the card idle at the shape that launches most (m = 513: 96
// blocks on 132 SMs), each thread walking its chunk in one dependent chain
// with one shared-memory load a pair, and its wrapper launched six more
// kernels around the two (a stack, a memset, the normalisation).
//
// What the design does about it:
//  - a warp holds kPts points in registers (the same points in every lane,
//    kPts from d so that they stay in registers) and its lanes split a range
//    of rows (lane l takes rows l, l + 32, ...): one row load feeds kPts
//    independent pairs, and the row ranges are cut from n alone
//    (_launch.fixed_range, RANGES in the launcher: about one wave of
//    resident blocks at m = 513), so a point's partials, and its density's
//    bits, do not depend on the other points of the launch or on the card;
//  - the exponent is folded into the data: with c = sqrt(log2(e) / 2) / h,
//    formed in each thread from h in device memory (no host sync), a term is
//    ex2.approx.ftz(-sum v^2) (common.cuh) with v = c x - c p, and a pair at
//    d = 1 costs an FMA, a subtraction, a multiply, the MUFU op and the add.
//    Each point is its own centre: c p is held as its rounded product and
//    that product's exact error (two registers a coordinate), v =
//    fmaf(c, x, -(c p)_rounded) - error, so the rounding of the fold is
//    relative to |x - p| / h, not to |x| / h (scaling about 0 loses the
//    tolerance once |x| / h reaches 1e4, tests/test_torch_kde_eval.py), and
//    depends on no other point of the launch;
//  - each warp adds its lanes by a fixed shuffle tree and writes one partial
//    per (point, range); the second kernel adds a point's partials in
//    float64 (lane-strided, then a fixed shuffle tree) and applies
//    (2 pi)^(-d/2) h^(-d) / n in double, h^d from h in device memory,
//    writing every output.  No float atomics: two launches give the same
//    bits, and a point's bits are the same alone and in any batch.  One call
//    is these two kernels and nothing else.
// d is a template parameter (1..16), so the points stay in registers.
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace repro_torch {

constexpr int kWarps = 8;                      // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kPtsD4 = 8;                      // points per warp for d <= 4
constexpr int kPtsD8 = 4;                      // for 4 < d <= 8
constexpr int kPtsD16 = 2;                     // for 8 < d <= 16
constexpr int kRowUnroll = 4;                  // rows a lane has in flight
constexpr float kSqrtHalfLog2e = 0.84932180028801904272f;   // sqrt(log2(e) / 2)
constexpr double kTwoPi = 6.283185307179586477;

template <int D>
__host__ __device__ constexpr int pts_per_warp() {
  return D <= 4 ? kPtsD4 : (D <= 8 ? kPtsD8 : kPtsD16);
}

// blockIdx.x = point tile of kPts * kWarps points, blockIdx.y = range of
// range_rows rows.  partials: (m, gridDim.y).
template <int D>
__global__ void __launch_bounds__(kThreads)
kde_tiles(const float* __restrict__ pts, int m, const float* __restrict__ x, int n,
          const float* __restrict__ h, int range_rows, float* __restrict__ partials) {
  constexpr int P = pts_per_warp<D>();
  const int lane = threadIdx.x & 31;
  const int p0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * P;
  if (p0 >= m) return;                         // a whole warp past the points
  const float c = kSqrtHalfLog2e / h[0];
  // c p = -(nhi + lo) exactly: nhi the rounded product negated, lo its error
  float nhi[P][D], lo[P][D], acc[P];
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const size_t pi = (size_t)min(p0 + r, m - 1);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float pk = pts[pi * D + k];
      nhi[r][k] = -(c * pk);
      lo[r][k] = fmaf(c, pk, nhi[r][k]);
    }
    acc[r] = 0.0f;
  }
  const int begin = blockIdx.y * range_rows;
  const int end = min(n, begin + range_rows);
#pragma unroll kRowUnroll
  for (int i = begin + lane; i < end; i += 32) {
    float xv[D];
#pragma unroll
    for (int k = 0; k < D; ++k) xv[k] = __ldg(x + (size_t)i * D + k);
#pragma unroll
    for (int r = 0; r < P; ++r) {
      // v = c x - c p, rounded relative to |x - p| / h
      const float v0 = fmaf(c, xv[0], nhi[r][0]) - lo[r][0];
      float s = -v0 * v0;                      // -sum v^2, the negations free
#pragma unroll
      for (int k = 1; k < D; ++k) {
        const float v = fmaf(c, xv[k], nhi[r][k]) - lo[r][k];
        s = fmaf(-v, v, s);
      }
      acc[r] += ex2_ftz(s);
    }
  }
#pragma unroll
  for (int r = 0; r < P; ++r) acc[r] = warp_sum(acc[r]);
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    if (p0 + r >= m) break;
    partials[(size_t)(p0 + r) * gridDim.y + blockIdx.y] = acc[r];
  }
}

// Warp w of block b finishes point b * kWarps + w: its n_ranges partials
// added in float64 (lane-strided, then a fixed tree) times
// norm_n / h^d, norm_n = (2 pi)^(-d/2) / n.
__global__ void __launch_bounds__(kThreads)
kde_finish(const float* __restrict__ partials, int m, int n_ranges, int d, double norm_n,
           const float* __restrict__ h, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= m) return;
  const float* row = partials + (size_t)p * n_ranges;
  double acc = 0.0;
  for (int k = lane; k < n_ranges; k += 32) acc += row[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane != 0) return;
  const double hv = h[0];
  double hd = hv;
  for (int k = 1; k < d; ++k) hd *= hv;
  out[p] = (float)(norm_n / hd * acc);
}

template <int D>
cudaError_t launch_d(const float* pts, int m, const float* x, int n, const float* h,
                     int range_rows, float* partials, float* out, cudaStream_t stream) {
  const int n_ranges = (n + range_rows - 1) / range_rows;
  constexpr int tile = pts_per_warp<D>() * kWarps;
  const dim3 grid((m + tile - 1) / tile, n_ranges);
  kde_tiles<D><<<grid, kThreads, 0, stream>>>(pts, m, x, n, h, range_rows, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const double norm_n = pow(kTwoPi, -0.5 * D) / n;
  kde_finish<<<(m + kWarps - 1) / kWarps, kThreads, 0, stream>>>(partials, m, n_ranges, D,
                                                                norm_n, h, out);
  return cudaGetLastError();
}

// Calls f with std::integral_constant<int, d> for 1 <= d <= 16.
template <int D = 1, class F>
int with_d(int d, F f) {
  if (d == D) return (int)f(std::integral_constant<int, D>{});
  if constexpr (D < 16) return with_d<D + 1>(d, f);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

// pts: (m, d), x: (n, d) row-major, h: one float on the device; m, n >= 1,
// 1 <= d <= 16, range_rows >= 1 rows per block; partials holds
// m * ceil(n / range_rows) floats, out m.  Returns the cudaError_t of the
// launches.
extern "C" int kde_eval_launch(const float* pts, int m, const float* x, int n, int d,
                               const float* h, int range_rows, float* partials,
                               float* out, void* stream_ptr) {
  using namespace repro_torch;
  if (m < 1 || n < 1 || range_rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  return with_d(d, [&](auto dd) {
    return launch_d<decltype(dd)::value>(pts, m, x, n, h, range_rows, partials, out, s);
  });
}
