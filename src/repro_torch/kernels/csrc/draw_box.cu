// Kernel-centred quasi-MC box reduction of a full-H synopsis, for the whole
// sample and for S equal row chunks of it in one launch.  Draw j of sample
// row i is y_ij = x_i + L z_ij (L the lower Cholesky factor of H, z_ij the
// standard-normal draw of row i K + j of z), and for box b with SUM target
// axis t_b and row split s (s = 0 the whole sample, s = 1..S chunk s - 1):
//   cnt[s, b] = #{(i, j) : i in split s, lo_b <= y_ij <= hi_b on every axis}
//   sum[s, b] = sum of y_ij[t_b] over the same draws
// Chunk c holds rows [c r, (c + 1) r) with r = m / S (integer division); the
// rows past S r (the tail) enter only the whole sample.  The caller applies
// n_source / (m K) (the chunks: n_source / (r K)); the chunks are the
// batch-means replicates of the CI.
//
// Replaces no TPU kernel: the JAX package integrates full-H boxes only over
// Halton nodes on the boxes' hull (repro/kernels/qmc_reduce.py), which at
// d = 8 leaves most boxes with next to no node under the KDE's mass.  The
// kernel-centred estimator puts every draw where a row's kernel puts its
// mass, so no hull, clipping or node budget is needed.
//
// Bound on the H100: the FP32 pipe.  Per draw the affine map costs d(d+1)/2
// FMAs; per (draw, box) the closed-box test is 2d compares, then one add
// each for the count and the target sum.  At the main path's shape (m K =
// 1 048 576 draws, q = 128 boxes, d = 8) that is 2.5e9 operations against
// 0.5 MB of sample and boxes (the draws z are a constant of (m, K, d), read
// once: 33.5 MB).
//
// What the design does about it:
//  - a block forms the draws of one tile of sample rows once, into shared
//    memory (draw-major, each draw's axes padded to a multiple of 4 so a
//    thread reads them as 16-byte broadcast loads), and each thread then
//    walks every draw of the tile for one box held in registers: the
//    affine map is paid once a draw, not once a (draw, box);
//  - tiles never straddle a row split, so a tile's (count, sum) partial
//    belongs to one chunk; a second kernel adds each chunk's tiles in tile
//    order in double and the whole sample as the chunks' sums plus the
//    tail's, in that order.  No atomics: the same bits run to run.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kThreads = 128;      // threads of a tile block (one box each)
constexpr int kMaxSplits = 16;     // S <= kMaxSplits row chunks per launch
constexpr int kFinishBoxes = 32;   // boxes of a finishing block

// The sample rows of tile c: S splits of `split` rows, `per_split` tiles of
// at most `rows` rows each, then the tail [S split, m) likewise.
struct TileGrid {
  int m, rows, S, split, per_split;
  __device__ __forceinline__ void rows_of(int c, int* begin, int* count) const {
    if (c < S * per_split) {
      const int j = c / per_split, i = c - j * per_split;
      *begin = j * split + i * rows;
      *count = min(rows, split - i * rows);
    } else {
      *begin = S * split + (c - S * per_split) * rows;
      *count = min(rows, m - *begin);
    }
  }
};

// Stage 1.  Block c forms the draws of tile c into shared memory (dynamic,
// rows K DP floats), then thread t < q tests every draw against box t (and
// t + kThreads, ...) and writes the tile's partials[c][0][b] (count) and
// partials[c][1][b] (target sum).
template <int D>
__global__ void __launch_bounds__(kThreads)
draw_box_tiles(const float* __restrict__ x, const float* __restrict__ z,
               const float* __restrict__ l_chol, int draws, TileGrid grid,
               const float* __restrict__ lo, const float* __restrict__ hi,
               const int* __restrict__ tgt, int q, float* __restrict__ partials) {
  constexpr int DP = (D + 3) / 4 * 4;
  extern __shared__ __align__(16) float ys[];   // ys[e * DP + a]
  int begin, rows;
  grid.rows_of(blockIdx.x, &begin, &rows);
  const int nd = rows * draws;
  float l[D * (D + 1) / 2];                     // L's lower triangle, row by row
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) l[a * (a + 1) / 2 + b] = l_chol[a * D + b];
  }
  const size_t t0 = (size_t)begin * draws;
  for (int e = threadIdx.x; e < nd; e += blockDim.x) {
    const float* xi = x + (size_t)(begin + e / draws) * D;
    const float* zt = z + (t0 + e) * D;
    float zz[D];
#pragma unroll
    for (int b = 0; b < D; ++b) zz[b] = zt[b];
#pragma unroll
    for (int a = 0; a < DP; ++a) {
      float y = 0.0f;
      if (a < D) {
        float lz = l[a * (a + 1) / 2] * zz[0];
#pragma unroll
        for (int b = 1; b <= a; ++b) lz = fmaf(l[a * (a + 1) / 2 + b], zz[b], lz);
        y = xi[a] + lz;
      }
      ys[e * DP + a] = y;
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < q; b += blockDim.x) {
    float lb[D], ub[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      lb[a] = lo[(size_t)b * D + a];
      ub[a] = hi[(size_t)b * D + a];
    }
    const int t = tgt[b];
    float cnt = 0.0f, sum = 0.0f;
#pragma unroll 4
    for (int e = 0; e < nd; ++e) {
      float y[DP];
#pragma unroll
      for (int v = 0; v < DP / 4; ++v) {
        const float4 y4 = reinterpret_cast<const float4*>(ys + e * DP)[v];
        y[4 * v] = y4.x; y[4 * v + 1] = y4.y; y[4 * v + 2] = y4.z; y[4 * v + 3] = y4.w;
      }
      bool inside = true;
#pragma unroll
      for (int a = 0; a < D; ++a) inside &= (y[a] >= lb[a]) & (y[a] <= ub[a]);
      const float yt = ys[e * DP + t];
      if (inside) {
        cnt += 1.0f;
        sum += yt;
      }
    }
    partials[((size_t)blockIdx.x * 2) * q + b] = cnt;
    partials[((size_t)blockIdx.x * 2 + 1) * q + b] = sum;
  }
}

// Stage 2.  Block (x, s) takes kFinishBoxes boxes of statistic s (0 the
// count, 1 the sum); thread (i, j) adds the tiles of chunk j (j = S: the
// tail) of box x kFinishBoxes + i in tile order in double, then row j = 0
// adds the chunks in order and the tail last.  out: (2, S + 1, q), row 0
// the whole sample, row 1 + j chunk j.
__global__ void draw_box_finish(const float* __restrict__ partials, int q, TileGrid grid,
                                int n_tiles, double* __restrict__ out) {
  __shared__ double acc[kMaxSplits + 1][kFinishBoxes];
  const int b = blockIdx.x * kFinishBoxes + threadIdx.x;
  const int s = blockIdx.y, j = threadIdx.y, S = grid.S;
  const int first = j * grid.per_split;
  const int last = j < S ? first + grid.per_split : n_tiles;
  double v = 0.0;
  if (b < q) {
    for (int c = first; c < last; ++c) v += (double)partials[((size_t)c * 2 + s) * q + b];
  }
  acc[j][threadIdx.x] = v;
  __syncthreads();
  if (b >= q) return;
  const size_t row = (size_t)s * (S + 1);
  if (j < S) out[(row + 1 + j) * q + b] = v;
  if (j == 0) {
    double full = 0.0;
    for (int i = 0; i < S; ++i) full += acc[i][threadIdx.x];
    out[row * q + b] = full + acc[S][threadIdx.x];
  }
}

template <int D>
cudaError_t launch_d(const float* x, const float* z, const float* l_chol, int draws,
                     TileGrid grid, int n_tiles, const float* lo, const float* hi,
                     const int* tgt, int q, float* partials, double* out,
                     cudaStream_t stream) {
  constexpr int DP = (D + 3) / 4 * 4;
  const size_t smem = (size_t)grid.rows * draws * DP * sizeof(float);
  draw_box_tiles<D><<<n_tiles, kThreads, smem, stream>>>(x, z, l_chol, draws, grid, lo, hi,
                                                         tgt, q, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 fblocks((q + kFinishBoxes - 1) / kFinishBoxes, 2);
  const dim3 fthreads(kFinishBoxes, grid.S + 1);
  draw_box_finish<<<fblocks, fthreads, 0, stream>>>(partials, q, grid, n_tiles, out);
  return cudaGetLastError();
}

}  // namespace repro_torch

// x: (m, d), z: (m K, d), l_chol: (d, d) lower triangular, all row-major
// float32; lo/hi: (q, d) float32, tgt: (q,) int32; 1 <= d <= 8, m, q >= 1.
// S row chunks of m / S rows (0 <= S <= 16; S > 0 needs S <= m), each cut
// into tiles of `rows` rows (rows K d' floats of shared memory, d' = d
// rounded up to a multiple of 4, at most 48 KB), the tail likewise.
// partials holds n_tiles * 2 * q floats (n_tiles = S ceil((m / S) / rows) +
// ceil(tail / rows)); out (2, S + 1, q) doubles: the count sums, then the
// target sums.  Returns the cudaError_t of the launches.
extern "C" int draw_box_reduce_launch(const float* x, int m, int d, const float* z,
                                      int draws, const float* l_chol, const float* lo,
                                      const float* hi, const int* tgt, int q, int S,
                                      int rows, float* partials, double* out,
                                      void* stream_ptr) {
  using namespace repro_torch;
  if (m < 1 || q < 1 || draws < 1 || rows < 1 || S < 0 || S > kMaxSplits ||
      (S > 0 && S > m) || (size_t)rows * draws * ((d + 3) / 4 * 4) * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  TileGrid grid;
  grid.m = m;
  grid.rows = rows;
  grid.S = S;
  grid.split = S > 0 ? m / S : 0;
  grid.per_split = (grid.split + rows - 1) / rows;
  const int n_tiles = S * grid.per_split + (m - S * grid.split + rows - 1) / rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (d) {
#define DRAW_CASE(D_)                                                                      \
    case D_: err = launch_d<D_>(x, z, l_chol, draws, grid, n_tiles, lo, hi, tgt, q,      \
                                partials, out, s); break;
    DRAW_CASE(1) DRAW_CASE(2) DRAW_CASE(3) DRAW_CASE(4)
    DRAW_CASE(5) DRAW_CASE(6) DRAW_CASE(7) DRAW_CASE(8)
#undef DRAW_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
