// Nearest / second-nearest medoid per row (top-2), float32.
//
// Replaces the TPU kernel src/repro/kernels/stream_g.py:165
// (stream_top2_kernel).  For every row x of [n, d] against the k medoid
// rows [k, d]: d1 = min_c d(x, med_c), assign = the FIRST c attaining d1,
// d2 = min over the other columns (so duplicate medoid rows give
// d2 == d1; d2 = +inf when k == 1).  The [n, k] block never reaches
// device memory.
//
// Bound on the H100: 2*n*k*d flops (0.94 GFLOP at n=60000, k=10,
// d=784) against reading x once (188 MB): memory-bound, about 56 us at
// 3.35 TB/s.  Design: one block per 128-row tile; the medoid rows are
// staged through shared memory 16 at a time by the shared dist_tile (a
// narrow tile, since k is small), and one thread per row scans the tile's
// columns in index order with strict comparisons, which gives the
// first-index tie rule of the TPU kernel and of engine._top2_block.
#include "dist_tile.cuh"

namespace {

constexpr int TM = 128, TN = 16, NT = (TM / 4) * (TN / 4);
static_assert(NT == TM, "one thread per row in the scan");

template <int M>
__global__ void __launch_bounds__(NT)
top2_kernel(const float* __restrict__ x, const float* __restrict__ med,
            float* __restrict__ d1, float* __restrict__ d2,
            int* __restrict__ assign, int64_t n, int k, int d) {
  __shared__ rt::TileSmem<TM, TN> s;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int row = threadIdx.x;
  float best = INFINITY, second = INFINITY;
  int arg = 0;
  for (int col0 = 0; col0 < k; col0 += TN) {
    rt::dist_tile<M, TM, TN>(x, med, n, k, d, row0, col0, s);
    const int nc = min(TN, k - col0);
    for (int j = 0; j < nc; ++j) {
      const float v = s.dt[row][j];
      if (v < best) {
        second = best;
        best = v;
        arg = col0 + j;
      } else if (v < second) {
        second = v;
      }
    }
    __syncthreads();  // dt is rewritten by the next tile
  }
  if (row0 + row < n) {
    d1[row0 + row] = best;
    d2[row0 + row] = second;
    assign[row0 + row] = arg;
  }
}

}  // namespace

extern "C" int rt_top2(const float* x, const float* med, float* d1, float* d2,
                       int* assign, int64_t n, int k, int d, int metric,
                       void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const unsigned grid = (unsigned)((n + TM - 1) / TM);
  cudaStream_t st = (cudaStream_t)stream;
  RT_METRIC_SWITCH(metric, M,
                   top2_kernel<M><<<grid, NT, 0, st>>>(x, med, d1, d2, assign,
                                                       n, k, d));
  return (int)cudaGetLastError();
}
