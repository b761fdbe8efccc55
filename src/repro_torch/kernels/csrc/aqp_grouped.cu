// Factored GROUP BY box sums (eq. 11 over a family of boxes that differ only
// in one axis, the group column's code window), for F families of one
// synopsis in one launch, with the five moment sums of each entry's CI:
//   c_ig = shared_cnt_i * gPhi_ig
//   s_ig = shared_sm_i  * gPhi_ig        (target on a kept axis)
//        = shared_cnt_i * gmom_ig        (target == group axis)
//   out[f] = (sum_i c, sum_i s, sum_i c^2, sum_i s^2, sum_i c s) per category
//   shared_cnt_i = prod_{j != g_axis} dPhi_ij   (family f's shared box)
//   shared_sm_i  = the same product with the target axis's factor swapped
//                  for its first moment x dPhi - h dphi (eq. 10)
//   gPhi_ig      = dPhi of row i on the group axis over category g's window
//   gmom_ig      = its first moment x dPhi - h dphi
//
// Replaces the TPU kernel repro/kernels/aqp_grouped.py, aqp_grouped_sums (its
// pallas_call _kernel); the moment sums replace the separate CI pass over the
// families' fanned-out boxes (repro/core/aqp_ci.py, moments_box).
//
// Bound on the H100: operations.  Per row, the window terms cost two erfc
// per window (gmom's density difference comes from their exponentials), once
// for every family that shares the window table; the family terms two erfc
// per (family, kept axis); and each
// (family, category) 7 FP32 instructions: two products and the five sums.
// At n = 32768 with 104 families over 64 shared windows the last dominate
// (1.5e9 instructions against 0.4 MB of input).  One family per launch, as
// the TPU kernel runs, is launch latency: 0.08 ms a family against a bound
// below 0.001 ms.
//
// What the design does about it: the host sorts the families into tiles of
// up to kFamTile families that share (window table, group axis, kind: target
// on a kept axis or on the group axis), so a tile's window terms are formed
// once per row and its accumulate loop has no branch.  Block (row range,
// tile, category tile) walks its rows in sub-chunks of kSub: the sub-chunk's
// rows, its window terms (kSub x kCatTile) and its families' (shared_cnt,
// shared_sm) pairs go to shared memory, then thread (family group, category
// group) holds kFamRows families x kCatRows categories x 5 sums in registers
// and reads one 16-byte window load and kFamRows 8-byte broadcasts per row.
// Each block writes one partial per (family, sum, category); a second
// kernel adds a value's partials in range order, so a repeat query gives
// the same bits (no float atomics).  Phi differences come from the tail
// (common.cuh, phi_dens_diff), not as an erf difference, which cancels in the
// far tails.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kSub = 32;                        // rows per shared-memory sub-chunk
constexpr int kCatRows = 4;                     // categories per thread
constexpr int kCatGroups = 16;                  // category groups per block
constexpr int kCatTile = kCatRows * kCatGroups; // categories per block (blockIdx.z)
constexpr int kFamRows = 4;                     // families per thread
constexpr int kFamGroups = 8;                   // family groups per block
constexpr int kFamTile = kFamRows * kFamGroups; // families per tile (blockIdx.y)
constexpr int kThreads = kCatGroups * kFamGroups;
constexpr int kTileInts = 5;                    // win, g_axis, self, begin, count

// One tile's accumulate loop over a sub-chunk: acc[i][g][0..4] of family
// slot fg * kFamRows + i and category cg * kCatRows + g.
template <bool kSelf>
__device__ __forceinline__ void accumulate(const float4* __restrict__ gp4,
                                           const float4* __restrict__ gm4,
                                           const float2* __restrict__ fam, int fg,
                                           int cg, float (&acc)[kFamRows][kCatRows][5]) {
#pragma unroll 2
  for (int r = 0; r < kSub; ++r) {
    const float4 p4 = gp4[r * kCatGroups + cg];
    const float gp[kCatRows] = {p4.x, p4.y, p4.z, p4.w};
    float gm[kCatRows];
    if (kSelf) {
      const float4 m4 = gm4[r * kCatGroups + cg];
      gm[0] = m4.x; gm[1] = m4.y; gm[2] = m4.z; gm[3] = m4.w;
    }
#pragma unroll
    for (int i = 0; i < kFamRows; ++i) {
      const float2 cs = fam[(fg * kFamRows + i) * kSub + r];
#pragma unroll
      for (int g = 0; g < kCatRows; ++g) {
        const float c = cs.x * gp[g];
        const float s = kSelf ? cs.x * gm[g] : cs.y * gp[g];
        float* a = acc[i][g];
        a[0] += c;
        a[1] += s;
        a[2] = fmaf(c, c, a[2]);
        a[3] = fmaf(s, s, a[3]);
        a[4] = fmaf(c, s, a[4]);
      }
    }
  }
}

// blockIdx.x = range of `range_rows` rows (a multiple of kSub), blockIdx.y =
// tile, blockIdx.z = category tile.  lo/hi: (F, D), wlo/whi: (W, Gmax),
// tiles: (n_tiles, kTileInts), order: (F,) family indices by tile, ftgt:
// (F,) targets.  partials: (gridDim.x, F, 5, Gmax).
template <int D>
__global__ void __launch_bounds__(kThreads)
grouped_tiles(const float* __restrict__ x, int n, const float* __restrict__ h,
              const float* __restrict__ lo, const float* __restrict__ hi,
              const float* __restrict__ wlo, const float* __restrict__ whi,
              int Gmax, const int* __restrict__ tiles,
              const int* __restrict__ order, const int* __restrict__ ftgt,
              int F, int range_rows, float* __restrict__ partials) {
  __shared__ float s_x[kSub * D];
  __shared__ __align__(16) float s_gp[kSub * kCatTile];
  __shared__ __align__(16) float s_gm[kSub * kCatTile];
  __shared__ __align__(16) float2 s_fam[kFamTile * kSub];
  __shared__ float s_lo[kFamTile * D], s_hi[kFamTile * D];
  __shared__ int s_tgt[kFamTile];
  __shared__ float s_wlo[kCatTile], s_whi[kCatTile];

  const int* tile = tiles + (size_t)blockIdx.y * kTileInts;
  const int win = tile[0], g_axis = tile[1], is_self = tile[2];
  const int fbegin = tile[3], fcount = tile[4];
  const int g0 = blockIdx.z * kCatTile;
  for (int e = threadIdx.x; e < kFamTile * D; e += kThreads) {
    const int i = e / D, j = e - i * D;
    const int f = i < fcount ? order[fbegin + i] : 0;
    s_lo[e] = lo[(size_t)f * D + j];
    s_hi[e] = hi[(size_t)f * D + j];
  }
  for (int i = threadIdx.x; i < kFamTile; i += kThreads)
    s_tgt[i] = i < fcount ? ftgt[order[fbegin + i]] : 0;
  for (int g = threadIdx.x; g < kCatTile; g += kThreads) {
    const int gg = min(g0 + g, Gmax - 1);
    s_wlo[g] = wlo[(size_t)win * Gmax + gg];
    s_whi[g] = whi[(size_t)win * Gmax + gg];
  }
  float ih[D];
#pragma unroll
  for (int j = 0; j < D; ++j) ih[j] = 1.0f / h[j];
  const float hg = h[g_axis], ihg = 1.0f / hg;

  const int cg = threadIdx.x % kCatGroups, fg = threadIdx.x / kCatGroups;
  float acc[kFamRows][kCatRows][5];
#pragma unroll
  for (int i = 0; i < kFamRows; ++i)
#pragma unroll
    for (int g = 0; g < kCatRows; ++g)
#pragma unroll
      for (int t = 0; t < 5; ++t) acc[i][g][t] = 0.0f;

  const int r_begin = blockIdx.x * range_rows;
  const int r_end = min(n, r_begin + range_rows);
  for (int base = r_begin; base < r_end; base += kSub) {
    const int rows = min(kSub, r_end - base);
    __syncthreads();               // the previous sub-chunk's reads are done
    for (int e = threadIdx.x; e < kSub * D; e += kThreads)
      s_x[e] = e < rows * D ? x[(size_t)base * D + e] : 0.0f;
    __syncthreads();
    // window terms: (row, category) entries of this tile's window table
    for (int e = threadIdx.x; e < kSub * kCatTile; e += kThreads) {
      const int r = e / kCatTile, g = e - r * kCatTile;
      float gp = 0.0f, gm = 0.0f;
      if (r < rows) {
        const float xg = s_x[r * D + g_axis];
        const float za = (s_wlo[g] - xg) * ihg;
        const float zb = (s_whi[g] - xg) * ihg;
        float d_phi;
        phi_dens_diff(za, zb, gp, d_phi);
        if (is_self) gm = xg * gp - hg * d_phi;
      }
      s_gp[e] = gp;
      s_gm[e] = gm;
    }
    // family terms: (shared_cnt, shared_sm) per (family, row)
    for (int e = threadIdx.x; e < kFamTile * kSub; e += kThreads) {
      const int i = e / kSub, r = e - i * kSub;
      float pc = 0.0f, ps = 0.0f;
      if (r < rows && i < fcount) {
        pc = 1.0f;
        ps = 1.0f;
        const int t = s_tgt[i];
#pragma unroll
        for (int j = 0; j < D; ++j) {
          if (j == g_axis) continue;
          const float xv = s_x[r * D + j];
          const float za = (s_lo[i * D + j] - xv) * ih[j];
          const float zb = (s_hi[i * D + j] - xv) * ih[j];
          float dP, d_phi;
          phi_dens_diff(za, zb, dP, d_phi);
          pc *= dP;
          ps *= (j == t) ? xv * dP - h[j] * d_phi : dP;
        }
      }
      s_fam[e] = make_float2(pc, ps);
    }
    __syncthreads();
    const float4* gp4 = reinterpret_cast<const float4*>(s_gp);
    const float4* gm4 = reinterpret_cast<const float4*>(s_gm);
    if (is_self) accumulate<true>(gp4, gm4, s_fam, fg, cg, acc);
    else accumulate<false>(gp4, gm4, s_fam, fg, cg, acc);
  }

#pragma unroll
  for (int i = 0; i < kFamRows; ++i) {
    const int slot = fg * kFamRows + i;
    if (slot >= fcount) continue;
    float* out = partials + ((size_t)blockIdx.x * F + order[fbegin + slot]) * 5 * Gmax;
#pragma unroll
    for (int g = 0; g < kCatRows; ++g) {
      const int gg = g0 + cg * kCatRows + g;
      if (gg >= Gmax) continue;
#pragma unroll
      for (int t = 0; t < 5; ++t) out[(size_t)t * Gmax + gg] = acc[i][g][t];
    }
  }
}

template <int D>
cudaError_t launch_d(const float* x, int n, const float* h, const float* lo,
                     const float* hi, const float* wlo, const float* whi, int Gmax,
                     const int* tiles, int n_tiles, const int* order,
                     const int* ftgt, int F, int range_rows, float* partials,
                     cudaStream_t stream) {
  const dim3 grid((n + range_rows - 1) / range_rows, n_tiles,
                  (Gmax + kCatTile - 1) / kCatTile);
  grouped_tiles<D><<<grid, kThreads, 0, stream>>>(x, n, h, lo, hi, wlo, whi, Gmax, tiles,
                                                  order, ftgt, F, range_rows, partials);
  return cudaGetLastError();
}

}  // namespace repro_torch

// x: (n, d) row-major, h: (d,), lo/hi: (F, d), wlo/whi: (W, Gmax); tiles:
// (n_tiles, 5) ints (window table, group axis, 1 if the target is the group
// axis, first index into order, family count <= 32), order: (F,) family
// indices tile by tile, ftgt: (F,) each family's target axis; 1 <= d <= 8,
// range_rows a multiple of 32.  partials holds ceil(n / range_rows) * F * 5
// * Gmax floats, out F * 5 * Gmax.  Returns the cudaError_t of the launches.
extern "C" int aqp_grouped_moments_launch(const float* x, int n, int d,
                                          const float* h, const float* lo,
                                          const float* hi, const float* wlo,
                                          const float* whi, int Gmax,
                                          const int* tiles, int n_tiles,
                                          const int* order, const int* ftgt, int F,
                                          int range_rows, float* partials,
                                          float* out, void* stream_ptr) {
  using namespace repro_torch;
  if (range_rows < kSub || range_rows % kSub) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (d) {
#define GROUPED_CASE(D_)                                                            \
    case D_: err = launch_d<D_>(x, n, h, lo, hi, wlo, whi, Gmax, tiles, n_tiles, order, \
                                ftgt, F, range_rows, partials, s); break;
    GROUPED_CASE(1) GROUPED_CASE(2) GROUPED_CASE(3) GROUPED_CASE(4)
    GROUPED_CASE(5) GROUPED_CASE(6) GROUPED_CASE(7) GROUPED_CASE(8)
#undef GROUPED_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int n_ranges = (n + range_rows - 1) / range_rows;
  const int width = F * 5 * Gmax;
  sum_partial_columns<<<(width + 255) / 256, 256, 0, s>>>(partials, n_ranges, width, out);
  return (int)cudaGetLastError();
}
