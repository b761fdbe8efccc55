// Fused quasi-MC box reduction of a full-H synopsis (eq. 6 integrated over
// boxes on shared Halton nodes), for the whole sample and for K equal row
// chunks of it in one launch: for box q with SUM target axis t_q and row
// split s (s = 0 the whole sample, s = 1..K chunk s - 1),
//   cnt_sums[s, q] = sum_m 1_q(node_m) f_sm
//   sum_sums[s, q] = sum_m 1_q(node_m) node_m[t_q] f_sm
//   f_sm = sum_{i in split s} exp(log_norm - quad_mi / 2),
//   quad_mi = (node_m - x_i)^T H^-1 (node_m - x_i)
// Chunk j holds rows [j c, (j + 1) c) with c = n / K (integer division); the
// rows past K c (the tail) enter only the whole sample.  The caller applies
// vol(G) / m; the chunks are the batch-means replicates of the full-H CI.
//
// Replaces the TPU kernel repro/kernels/qmc_reduce.py, qmc_box_reduce (its
// pallas_call _kernel).
//
// Bound on the H100: the SFU at d = 1, the FP32 pipe from d = 2 on.  Per
// (node, row) the density costs d subtractions, the quadratic form and one
// 2^x: 1.07e9 pairs at m = n = 32768, against m d + n d floats of input.
// At d = 1 a pair is 4 FP32-pipe instructions and one MUFU.EX2 (16 per clock
// per SM against 128 FP32 lanes): the SFU binds; at d = 3 a pair is 16
// FP32-pipe instructions and the FP32 pipe binds.  The TPU grid (box tile,
// node tile, data tile) recomputes the m x n densities for every box tile;
// both sums are linear in f, so here the densities are formed once, and the
// K chunks' densities are partial sums of the same pass.
//
// What the design does about it:
//  - constants in log2 units: each thread folds -log2(e) / 2 into its copy
//    of H^-1 and log2(e) into log_norm, so a term is one ex2.approx.ftz
//    (common.cuh) of b + v . diff with no exp fix-ups and no separate
//    ln - quad / 2; a term below 2^-126 flushes to 0, far below the rtol
//    1e-5 of a node's density;
//  - register-blocked nodes: each thread holds kRows nodes, each row chunk
//    sits in shared memory axis by axis, so one 16-byte broadcast load per
//    axis feeds 4 rows to all kRows nodes of every thread;
//  - row splits: the chunk grid (blockIdx.y) never straddles a split, stage
//    1 writes one partial per (chunk, node), stage 2 adds a node's partials
//    split by split in chunk order and the whole sample as the splits'
//    sums plus the tail's, in that order, and stage 3 gives each (box, node
//    slice) one block that tests each node's indicator once and accumulates
//    the K + 1 (count, sum) pairs, reduced in a fixed tree, and a last pass
//    adds each box's slices in order.  No float atomics: the same bits run
//    to run.
// The quadratic form contracts v = H^-1 diff before the second dot (as the
// reference's einsum and the Pallas kernel do): an ill-conditioned LSCV_H
// makes H^-1 large with alternating signs, and v absorbs the cancellation
// at small magnitude.  An expansion in the node and row norms would cancel
// there, and a Cholesky whitening fails on an H that is not SPD.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kRows = 4;          // nodes per thread, in registers
constexpr int kMaxSplits = 16;    // K <= kMaxSplits row chunks per launch
constexpr int kBoxThreads = 256;  // threads of a stage-3 block (one box)
constexpr int kOutPad = (kMaxSplits + 1 + 3) / 4 * 4;   // a node's densities, padded
constexpr float kLog2e = 1.44269504088896340736f;

// The row range of chunk c of the split grid: K splits of `split` rows,
// `per_split` chunks each, then the tail [K split, n) in chunks of k rows.
struct ChunkGrid {
  int n, k, K, split, per_split;
  __device__ __forceinline__ void rows_of(int c, int* begin, int* rows) const {
    if (c < K * per_split) {
      const int j = c / per_split, i = c - j * per_split;
      *begin = j * split + i * k;
      *rows = min(k, split - i * k);
    } else {
      *begin = K * split + (c - K * per_split) * k;
      *rows = min(k, n - *begin);
    }
  }
};

// b + (H' diff) . diff for node p against row t of a 4-row group, H' the
// folded -log2(e)/2 H^-1: the exponent of the term in log2 units.
template <int D>
__device__ __forceinline__ float log2_term(const float* p, float (&xr)[D][4], int t,
                                           const float* c, float b) {
  float diff[D];
#pragma unroll
  for (int a = 0; a < D; ++a) diff[a] = p[a] - xr[a][t];
  float arg = b;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    float v = c[a * D] * diff[0];
#pragma unroll
    for (int e = 1; e < D; ++e) v = fmaf(c[a * D + e], diff[e], v);
    arg = fmaf(v, diff[a], arg);
  }
  return arg;
}

// Stage 1.  blockDim.x * kRows nodes per block (blockIdx.x), one chunk of at
// most k rows (blockIdx.y); dynamic shared memory D * k floats (k a multiple
// of 4).  Thread t holds nodes base + t + j blockDim.x, j < kRows.
// partials: (n_chunks, m).
template <int D>
__global__ void qmc_density_tiles(const float* __restrict__ nodes, int m,
                                  const float* __restrict__ x,
                                  const float* __restrict__ h_inv,
                                  const float* __restrict__ log_norm,
                                  ChunkGrid grid, float* __restrict__ partials) {
  extern __shared__ __align__(16) float xs[];   // xs[a * k + r]
  const int k = grid.k;
  int begin, rows;
  grid.rows_of(blockIdx.y, &begin, &rows);
  const int rows4 = (rows + 3) & ~3;
  for (int e = threadIdx.x; e < rows4 * D; e += blockDim.x) {
    const int r = e / D, a = e - r * D;
    xs[a * k + r] = r < rows ? x[(size_t)begin * D + e] : 0.0f;
  }
  const int base = blockIdx.x * blockDim.x * kRows + threadIdx.x;
  float p[kRows][D];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int i = min(base + j * (int)blockDim.x, m - 1);
#pragma unroll
    for (int a = 0; a < D; ++a) p[j][a] = nodes[(size_t)i * D + a];
  }
  float c[D * D];
#pragma unroll
  for (int e = 0; e < D * D; ++e) c[e] = (-0.5f * kLog2e) * h_inv[e];
  const float b = kLog2e * log_norm[0];
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
  __syncthreads();

  int r = 0;
  for (; r + 4 <= rows; r += 4) {
    float xr[D][4];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const float4 v = *reinterpret_cast<const float4*>(&xs[a * k + r]);
      xr[a][0] = v.x; xr[a][1] = v.y; xr[a][2] = v.z; xr[a][3] = v.w;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] += ex2_ftz(log2_term<D>(p[j], xr, t, c, b));
    }
  }
  if (r < rows) {                 // the chunk's last 1-3 rows: masked to 2^-inf = 0
    float xr[D][4];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const float4 v = *reinterpret_cast<const float4*>(&xs[a * k + r]);
      xr[a][0] = v.x; xr[a][1] = v.y; xr[a][2] = v.z; xr[a][3] = v.w;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float arg = log2_term<D>(p[j], xr, t, c, b);
        acc[j] += ex2_ftz(r + t < rows ? arg : -INFINITY);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int i = base + j * (int)blockDim.x;
    if (i < m) partials[(size_t)blockIdx.y * m + i] = acc[j];
  }
}

// Stage 2.  One thread per node i: f[i][1 + j] = chunk j's partials in
// chunk order, f[i][0] = ((f[i][1] + f[i][2]) + ... + f[i][K]) + the tail's
// partials in chunk order.  f: (m, n_pad), n_pad = K + 1 rounded up to a
// multiple of 4, so stage 3 reads a node's densities as 16-byte loads.
__global__ void qmc_split_densities(const float* __restrict__ partials, int m,
                                    ChunkGrid grid, int n_chunks, int n_pad,
                                    float* __restrict__ f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float full = 0.0f;
  for (int j = 0; j < grid.K; ++j) {
    float fj = 0.0f;
    for (int c = j * grid.per_split; c < (j + 1) * grid.per_split; ++c)
      fj += partials[(size_t)c * m + i];
    f[(size_t)i * n_pad + 1 + j] = fj;
    full += fj;
  }
  float tail = 0.0f;
  for (int c = grid.K * grid.per_split; c < n_chunks; ++c)
    tail += partials[(size_t)c * m + i];
  f[(size_t)i * n_pad] = full + tail;
  for (int o = grid.K + 1; o < n_pad; ++o) f[(size_t)i * n_pad + o] = 0.0f;
}

// Stage 3.  One block of kBoxThreads per box q (blockIdx.x) and slice of
// `per_slice` nodes (blockIdx.y): the slice's nodes strided over the
// threads, the indicator tested once per node, the K + 1 (count, sum) pairs
// accumulated in registers, then a fixed tree (warp shuffles, then the 8
// warp sums in order).  partials: (slices, 2, K + 1, q).
template <int D>
__global__ void __launch_bounds__(kBoxThreads)
qmc_box_tiles(const float* __restrict__ nodes, int m, int per_slice,
              const float4* __restrict__ f, int n_out, const float* __restrict__ lo,
              const float* __restrict__ hi, const int* __restrict__ tgt, int q,
              float* __restrict__ partials) {
  constexpr int kOut = kOutPad;
  __shared__ float warp_c[kOut][kBoxThreads / 32], warp_s[kOut][kBoxThreads / 32];
  const int n_vec = (n_out + 3) / 4;
  const int qi = blockIdx.x;
  float l[D], u[D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    l[a] = lo[(size_t)qi * D + a];
    u[a] = hi[(size_t)qi * D + a];
  }
  const int t = tgt[qi];
  float c[kOut], s[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) c[o] = s[o] = 0.0f;
  const int j_end = min(m, (int)(blockIdx.y + 1) * per_slice);
  for (int j = blockIdx.y * per_slice + threadIdx.x; j < j_end; j += blockDim.x) {
    bool inside = true;
    float tv = 0.0f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const float na = nodes[(size_t)j * D + a];
      inside = inside && na >= l[a] && na <= u[a];
      tv = (t == a) ? na : tv;
    }
    if (inside) {
#pragma unroll
      for (int v = 0; v < kOut / 4; ++v) {
        if (v < n_vec) {
          const float4 w4 = f[(size_t)j * n_vec + v];
          const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            c[4 * v + e] += w[e];
            s[4 * v + e] = fmaf(w[e], tv, s[4 * v + e]);
          }
        }
      }
    }
  }
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    if (o < n_out) {
      const float cw = warp_sum(c[o]), sw = warp_sum(s[o]);
      if ((threadIdx.x & 31) == 0) {
        warp_c[o][warp] = cw;
        warp_s[o][warp] = sw;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * n_out) {
    const bool is_sum = threadIdx.x >= n_out;
    const int o = is_sum ? threadIdx.x - n_out : threadIdx.x;
    float acc = 0.0f;
    for (int w = 0; w < kBoxThreads / 32; ++w) acc += is_sum ? warp_s[o][w] : warp_c[o][w];
    partials[((size_t)blockIdx.y * 2 * n_out + threadIdx.x) * q + qi] = acc;
  }
}

template <int D>
cudaError_t launch_d(const float* nodes, int m, const float* x, const float* h_inv,
                     const float* log_norm, const float* lo, const float* hi,
                     const int* tgt, int q, int threads, ChunkGrid grid,
                     int n_chunks, float* partials, float* f, int slices,
                     float* box_partials, float* out, cudaStream_t stream) {
  const int per_block = threads * kRows;
  const dim3 blocks((m + per_block - 1) / per_block, n_chunks);
  qmc_density_tiles<D><<<blocks, threads, (size_t)grid.k * D * sizeof(float), stream>>>(
      nodes, m, x, h_inv, log_norm, grid, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_pad = (grid.K + 1 + 3) / 4 * 4;
  qmc_split_densities<<<(m + 255) / 256, 256, 0, stream>>>(partials, m, grid, n_chunks, n_pad,
                                                           f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_slice = (m + slices - 1) / slices;
  qmc_box_tiles<D><<<dim3(q, slices), kBoxThreads, 0, stream>>>(
      nodes, m, per_slice, reinterpret_cast<const float4*>(f), grid.K + 1, lo, hi, tgt, q,
      box_partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = 2 * (grid.K + 1) * q;
  sum_partial_columns<<<(width + 255) / 256, 256, 0, stream>>>(box_partials, slices,
                                                               width, out);
  return cudaGetLastError();
}

}  // namespace repro_torch

// nodes: (m, d), x: (n, d), h_inv: (d, d), all row-major; log_norm: one
// float on the device; lo/hi: (q, d), tgt: (q,); 1 <= d <= 8.  K row chunks
// of n / K rows (0 <= K <= 16; K = 0: the whole sample only, K > 0 needs
// K <= n), each cut into chunks of k rows (k a multiple of 4), the tail
// likewise; `threads` per density block (a multiple of 32), kRows nodes
// each; stage 3 cuts the nodes into `slices` (1 <= slices <= m) per box.
// partials holds n_chunks * m floats (n_chunks = K ceil((n/K)/k) +
// ceil(tail/k)), f holds m (K + 1 rounded up to a multiple of 4) floats,
// 16-byte aligned, box_partials slices * 2 (K + 1) q, and
// out (2, K + 1, q): the count sums, then the sum sums.  Returns the
// cudaError_t of the launches.
extern "C" int qmc_box_reduce_launch(const float* nodes, int m, const float* x,
                                     int n, int d, const float* h_inv,
                                     const float* log_norm, const float* lo,
                                     const float* hi, const int* tgt, int q,
                                     int K, int k, int threads, float* partials,
                                     float* f, int slices, float* box_partials,
                                     float* out, void* stream_ptr) {
  using namespace repro_torch;
  if (K < 0 || K > kMaxSplits || (K > 0 && K > n) || k < 4 || k % 4 || slices < 1 ||
      slices > m)
    return (int)cudaErrorInvalidValue;
  ChunkGrid grid;
  grid.n = n;
  grid.k = k;
  grid.K = K;
  grid.split = K > 0 ? n / K : 0;
  grid.per_split = (grid.split + k - 1) / k;
  const int n_chunks = K * grid.per_split + (n - K * grid.split + k - 1) / k;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (d) {
#define QMC_CASE(D_)                                                              \
    case D_: err = launch_d<D_>(nodes, m, x, h_inv, log_norm, lo, hi, tgt, q, threads, \
                                grid, n_chunks, partials, f, slices, box_partials, out, \
                                s); break;
    QMC_CASE(1) QMC_CASE(2) QMC_CASE(3) QMC_CASE(4)
    QMC_CASE(5) QMC_CASE(6) QMC_CASE(7) QMC_CASE(8)
#undef QMC_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
