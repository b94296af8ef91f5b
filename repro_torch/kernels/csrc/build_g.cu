// Fused BUILD arm statistics (paper Eq. 6), float32.
//
// Replaces the TPU kernel src/repro/kernels/build_g.py:42
// (build_g_kernel).  For every candidate row x of [m, d] against a
// reference batch y [B, d]:
//   g_j = (isinf(dnear_j) ? d(x, y_j) : min(d(x, y_j) - dnear_j, 0)) * w_j
//   sums = sum_j g_j,  sq = sum_j g_j^2,  cross = sum_j g_j * lead_g_j
// and only the three [m] vectors reach device memory.
//
// Bound on the H100: 2*m*B*d flops of distance work (9.4 GFLOP at
// m=60000, B=100, d=784) against 67 TFLOP/s float32 without tensor
// cores, while x is read once (188 MB at 3.35 TB/s): compute-bound.
// Design: one block per 64-row tile walks the whole B-batch in 64-column
// tiles of the shared dist_tile.  The [64, 64] distance tile stays in
// shared memory; four threads per row fold it into per-thread register
// partials (columns sub, sub+4, ...), and the four partials are added in
// a fixed order at the end.  No atomics, so every run gives the same
// bits.  The isinf(dnear) branch is the TPU kernel's.
#include "dist_tile.cuh"

namespace {

constexpr int TM = 64, TN = 64, NT = (TM / 4) * (TN / 4), SUBS = NT / TM;

template <int M>
__global__ void __launch_bounds__(NT)
build_g_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ dnear, const float* __restrict__ w,
               const float* __restrict__ lg, float* __restrict__ sums,
               float* __restrict__ sq, float* __restrict__ cross, int64_t m,
               int64_t b, int d) {
  __shared__ rt::TileSmem<TM, TN> s;
  __shared__ float red[3][SUBS][TM];
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int row = threadIdx.x % TM;
  const int sub = threadIdx.x / TM;
  float ps = 0.f, pq = 0.f, pc = 0.f;
  for (int64_t col0 = 0; col0 < b; col0 += TN) {
    rt::dist_tile<M, TM, TN>(x, y, m, b, d, row0, col0, s);
    const int nc = b - col0 < TN ? (int)(b - col0) : TN;
    for (int j = sub; j < nc; j += SUBS) {
      const float dv = s.dt[row][j];
      const float dn = dnear[col0 + j];
      float g = isinf(dn) ? dv : fminf(dv - dn, 0.f);
      g = g * w[col0 + j];
      ps += g;
      pq += g * g;
      pc += g * lg[col0 + j];
    }
    __syncthreads();  // dt is rewritten by the next tile
  }
  red[0][sub][row] = ps;
  red[1][sub][row] = pq;
  red[2][sub][row] = pc;
  __syncthreads();
  if (sub == 0 && row0 + row < m) {
    float a0 = red[0][0][row], a1 = red[1][0][row], a2 = red[2][0][row];
#pragma unroll
    for (int t = 1; t < SUBS; ++t) {
      a0 += red[0][t][row];
      a1 += red[1][t][row];
      a2 += red[2][t][row];
    }
    sums[row0 + row] = a0;
    sq[row0 + row] = a1;
    cross[row0 + row] = a2;
  }
}

}  // namespace

extern "C" int rt_build_g(const float* x, const float* y, const float* dnear,
                          const float* w, const float* lg, float* sums,
                          float* sq, float* cross, int64_t m, int64_t b, int d,
                          int metric, void* stream) {
  if (m <= 0) return cudaSuccess;
  const unsigned grid = (unsigned)((m + TM - 1) / TM);
  cudaStream_t st = (cudaStream_t)stream;
  RT_METRIC_SWITCH(metric, M,
                   build_g_kernel<M><<<grid, NT, 0, st>>>(
                       x, y, dnear, w, lg, sums, sq, cross, m, b, d));
  return (int)cudaGetLastError();
}
