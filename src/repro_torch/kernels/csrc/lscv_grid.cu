// LSCV_h grid phase (paper §6.2 phase 2, eqs. 40-43): for every h on the
// grid, sum_{i<j} T~(S_ij; h) with
//   T~(S; h) = c_kk exp(-S / (4 h^2)) - 2 c_k exp(-S / (2 h^2))
// over the precomputed S of sv_precompute.cu.
//
// Replaces the TPU kernel repro/kernels/lscv_grid.py, lscv_grid_sums (its
// pallas_call _kernel; the S precompute it calls first is sv_precompute.cu).
//
// Bound on the H100: the SFU, with the FP32 pipe beside it.  n = 32768 and
// 150 grid points make 8.1e10 (pair, h) terms against 2.1 GB of S read
// once.  With a_h = -log2(e) / (4 h^2) precomputed, e4 = exp2(a_h S),
// exp(-S / (2 h^2)) = e4 * e4 and T~ = e4 (c_kk - 2 c_k e4): one multiply,
// one exp2 and two FMAs per term.  Taken as one SFU ex2 each, a warp's 32
// terms hold its SM quarter's 4 SFU lanes for 8 cycles but its issue slot
// for only about 4: the SFU (16 ex2 per clock per SM) binds and the FP32
// pipe idles half the time.
//
// What the design does about it: each term's 2^x is one ex2.approx.ftz
// (common.cuh), without exp2f's denormal fix-ups, which cost FP32 issue
// slots; and a fixed share of the terms, by position, takes 2^x from a
// polynomial on the FP32 pipe instead (exp2_poly below: a Cody-Waite split by
// the round-to-nearest magic-number add, a degree-6 minimax polynomial on
// [-1/2, 1/2] (degree 5 misses 2 ulp), the exponent added to the bits, 0
// below -126).  A term on the SFU costs one MUFU slot (8 cycles of a quarter
// SM's 4 SFU lanes per warp) and 4 FP32-pipe instructions, one on the
// polynomial 15 instructions: the pipes balance near a share of 1/5, but the
// share that measured fastest on the H100 is 1/8 (PERF.md), so kPolyTerms of
// every 4 kGroup terms, the .w lanes first and then the .z lanes, go through
// the polynomial; the same term always takes the same path and repeats are
// bit-identical.  As before, a 1-D grid enumerates only the upper-triangle
// tiles (eqs. 49/50, common.cuh), each block stages its kGridTile^2 tile of
// S in shared memory (16-byte loads where the tile lies wholly in the strict
// upper triangle) with the masked entries set to +inf (their term is exactly
// 0, so the inner loop has no branch), each thread owns one h with its sums
// in registers, reading the tile as float4 broadcasts, and every (tile, h)
// partial goes to device memory for a second kernel that adds each h's
// partials in a fixed order (no float atomics): a fit gives the same bits
// run to run.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kGridTile = 64;   // S tile side: kGridTile^2 floats of shared memory
constexpr int kGroup = 2;       // float4 broadcasts per unrolled group
constexpr int kPolyTerms = 1;   // of a group's 4 kGroup terms, those on the polynomial

// BEGIN EXP2_POLY: 2^f on [-1/2, 1/2], p(f) = sum_k kExp2Pk f^k (Horner,
// fmaf); relative minimax, float32 coefficients.  Read by
// tests/test_torch_lscv_kernels.py.
constexpr float kExp2Magic = 12582912.0f;   // 1.5 * 2^23: x + magic rounds x to an integer
constexpr float kExp2P0 = 1.0f;
constexpr float kExp2P1 = 0.6931471824645996f;
constexpr float kExp2P2 = 0.24022647738456726f;
constexpr float kExp2P3 = 0.055503323674201965f;
constexpr float kExp2P4 = 0.009618437848985195f;
constexpr float kExp2P5 = 0.0013398872688412666f;
constexpr float kExp2P6 = 0.00015353341586887836f;
// END EXP2_POLY

// 2^x on the FP32 pipe, within 2 ulp where the result is normal, +0 for
// x < -126 (as ex2.approx.ftz flushes) and x itself for a NaN x.  t = x +
// magic holds j = rint(x) in its low mantissa bits, so bits(t) << 23 is
// j << 23 modulo 2^32.
__device__ __forceinline__ float exp2_poly(float x) {
  const float t = x + kExp2Magic;
  const float f = x - (t - kExp2Magic);
  float p = kExp2P6;
  p = fmaf(p, f, kExp2P5);
  p = fmaf(p, f, kExp2P4);
  p = fmaf(p, f, kExp2P3);
  p = fmaf(p, f, kExp2P2);
  p = fmaf(p, f, kExp2P1);
  p = fmaf(p, f, kExp2P0);
  const float r = __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
  return x >= -126.0f ? r : (x < -126.0f ? 0.0f : x);
}

// partials: (n_h, count); block b takes triangle tile begin + b and writes
// column b.
__global__ void lscv_grid_tiles(const float* __restrict__ S, int n,
                                const float* __restrict__ a_h, int n_h,
                                const float* __restrict__ c_k_ptr,
                                const float* __restrict__ c_kk_ptr,
                                long long begin, long long count,
                                float* __restrict__ partials) {
  constexpr int kVecs = kGridTile * kGridTile / 4;
  __shared__ float4 tile4[kVecs];
  float* tile = reinterpret_cast<float*>(tile4);
  int q, l;
  bx_to_ql(begin + blockIdx.x, &q, &l);
  const long long i0 = (long long)q * kGridTile;
  const long long j0 = (long long)l * kGridTile;
  if (q != l && j0 + kGridTile <= n && (n & 3) == 0 &&
      (reinterpret_cast<size_t>(S) & 15) == 0) {
    // every entry of the tile lies in the strict upper triangle: 16-byte loads
    for (int e = threadIdx.x; e < kVecs; e += blockDim.x) {
      const long long i = i0 + e / (kGridTile / 4);
      tile4[e] = *reinterpret_cast<const float4*>(
          S + i * n + j0 + 4 * (e % (kGridTile / 4)));
    }
  } else {
    for (int e = threadIdx.x; e < kGridTile * kGridTile; e += blockDim.x) {
      const long long i = i0 + e / kGridTile;
      const long long j = j0 + e % kGridTile;
      tile[e] = (i < j && j < n) ? S[i * n + j] : INFINITY;
    }
  }
  __syncthreads();
  const float c_kk = c_kk_ptr[0];
  const float m2ck = -2.0f * c_k_ptr[0];
  for (int h = threadIdx.x; h < n_h; h += blockDim.x) {
    const float a = a_h[h];
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int e = 0; e < kVecs; e += kGroup) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float4 s4 = tile4[e + g];
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int lane = 0; lane < 4; ++lane) {
          const float arg = s[lane] * a;
          const float e4 = ((3 - lane) * kGroup + g < kPolyTerms) ? exp2_poly(arg)
                                                                  : ex2_ftz(arg);
          acc[lane] = fmaf(e4, fmaf(m2ck, e4, c_kk), acc[lane]);
        }
      }
    }
    partials[(size_t)h * (size_t)count + blockIdx.x] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
}

}  // namespace repro_torch

// S: (n, n) row-major (only its strict upper triangle is read); a_h: (n_h,)
// = -log2(e) / (4 h^2); c_k, c_kk: one float each in device memory.  The
// launch sums the count triangle tiles begin .. begin + count - 1 of the
// n_tri = T(T+1)/2, T = ceil(n / 64) (0 and n_tri: the whole triangle; a
// share of it is one rank's part of a distributed grid); partials: n_h *
// count floats, count >= 1; out: (n_h,).  `threads` per block (a multiple
// of 32).  Returns the cudaError_t of the launches.
extern "C" int lscv_grid_sums_launch(const float* S, int n, const float* a_h,
                                     int n_h, const float* c_k,
                                     const float* c_kk, int threads,
                                     long long begin, long long count,
                                     float* partials, float* out,
                                     void* stream_ptr) {
  using namespace repro_torch;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n_tiles = (n + kGridTile - 1) / kGridTile;
  const long long n_tri = n_tiles * (n_tiles + 1) / 2;
  if (begin < 0 || count < 1 || begin + count > n_tri) return (int)cudaErrorInvalidValue;
  lscv_grid_tiles<<<(unsigned)count, threads, 0, stream>>>(
      S, n, a_h, n_h, c_k, c_kk, begin, count, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_tile_partials<<<(unsigned)n_h, 256, 0, stream>>>(partials, count, out);
  return (int)cudaGetLastError();
}
