// Pairwise dissimilarity [m, d] x [r, d] -> [m, r] (float32).
//
// Replaces the TPU kernel src/repro/kernels/pairwise.py:74
// (pairwise_kernel).  Bound on the H100: for the predict shapes (many
// query rows, k medoid columns) it reads x once and writes m*r floats,
// so it is memory-bound when r is small and compute-bound (2*m*r*d FMA
// flops against 67 TFLOP/s float32) when r is large.  Design: one block
// per [64, 64] output tile through the shared dist_tile; the tile goes
// back to device memory row by row from shared memory, so the stores are
// coalesced; ragged edges are masked here.  There is no feature-axis
// split: the tile loops over any d.
#include "dist_tile.cuh"

namespace {

constexpr int TM = 64, TN = 64, NT = (TM / 4) * (TN / 4);

template <int M>
__global__ void __launch_bounds__(NT)
pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, int64_t m, int64_t r, int d) {
  __shared__ rt::TileSmem<TM, TN> s;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int64_t col0 = (int64_t)blockIdx.y * TN;
  rt::dist_tile<M, TM, TN>(x, y, m, r, d, row0, col0, s);
  for (int e = threadIdx.x; e < TM * TN; e += NT) {
    const int i = e / TN, j = e % TN;
    if (row0 + i < m && col0 + j < r) out[(row0 + i) * r + col0 + j] = s.dt[i][j];
  }
}

}  // namespace

extern "C" int rt_pairwise(const float* x, const float* y, float* out,
                           int64_t m, int64_t r, int d, int metric,
                           void* stream) {
  if (m <= 0 || r <= 0) return cudaSuccess;
  dim3 grid((unsigned)((m + TM - 1) / TM), (unsigned)((r + TN - 1) / TN));
  cudaStream_t st = (cudaStream_t)stream;
  RT_METRIC_SWITCH(metric, M,
                   pairwise_kernel<M><<<grid, NT, 0, st>>>(x, y, out, m, r, d));
  return (int)cudaGetLastError();
}
