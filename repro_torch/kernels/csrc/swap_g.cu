// Fused SWAP (FastPAM1, paper Eq. 12) arm statistics, float32.
//
// Replaces the TPU kernel src/repro/kernels/swap_g.py:85 (swap_g_kernel,
// tile math swap_stats_vals :40).  For every candidate row x of [m, d]
// against a reference batch y [B, d] with nearest/second-nearest medoid
// distances d1, d2, cluster ids a and {0,1} weights w:
//   base_j = (min(d, d1_j) - d1_j) * w_j
//   corr_j = min(d, d2_j) - min(d, d1_j)
//   sums [c, x] = sum_j base_j       + sum_{j: a_j = c} corr_j * w_j
//   sq   [c, x] = sum_j base_j^2     + sum_{j: a_j = c} (2 base_j corr_j + corr_j^2) * w_j
//   cross[c, x] = sum_j base_j lg_j  + sum_{j: a_j = c} corr_j * lg_j * w_j
// for all k medoid-arms c at once, written straight in the engine's
// [k, m] layout.
//
// Bound on the H100: the same 2*m*B*d distance flops as build_g
// (compute-bound at m=60000, B=100, d=784).  Design: the TPU kernel's
// one-hot [B, K] matrix product becomes a binned add.  The per-row base
// terms go to register scalars; corr, 2*base*corr+corr^2 and corr*lg go
// to a shared-memory bin [k] per (row, thread) chosen by a_j.  Each of the
// four threads of a row owns its bins, so there are no atomics, and the
// bins are added in a fixed order at the end: the same function with k
// times less work than the one-hot product, the same bits on every run.
// The bins take 3*k*256 floats of dynamic shared memory, which caps k at
// RT_SWAP_K_MAX (dist_tile.cuh); the wrapper refuses larger k.
#include "dist_tile.cuh"

namespace {

constexpr int TM = 64, TN = 64, NT = (TM / 4) * (TN / 4), SUBS = NT / TM;

template <int M>
__global__ void __launch_bounds__(NT)
swap_g_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ d1, const float* __restrict__ d2,
              const int* __restrict__ assign, const float* __restrict__ w,
              const float* __restrict__ lg, float* __restrict__ sums,
              float* __restrict__ sq, float* __restrict__ cross, int64_t m,
              int64_t b, int d, int k) {
  __shared__ rt::TileSmem<TM, TN> s;
  __shared__ float red[3][SUBS][TM];
  extern __shared__ float bins[];  // [SUBS][3][k][TM]
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int row = threadIdx.x % TM;
  const int sub = threadIdx.x / TM;
  float* mine = bins + (size_t)sub * 3 * k * TM;  // this thread: [3][k][TM]
  for (int e = threadIdx.x; e < SUBS * 3 * k * TM; e += NT) bins[e] = 0.f;
  float bs = 0.f, bq = 0.f, bc = 0.f;
  for (int64_t col0 = 0; col0 < b; col0 += TN) {
    rt::dist_tile<M, TM, TN>(x, y, m, b, d, row0, col0, s);
    const int nc = b - col0 < TN ? (int)(b - col0) : TN;
    for (int j = sub; j < nc; j += SUBS) {
      const int64_t jj = col0 + j;
      const float dv = s.dt[row][j];
      const float a1 = d1[jj], a2 = d2[jj], wj = w[jj], lj = lg[jj];
      const float m1 = fminf(dv, a1);
      const float base = (m1 - a1) * wj;
      const float corr = fminf(dv, a2) - m1;
      bs += base;
      bq += base * base;
      bc += base * lj;
      const int c = assign[jj];
      if (c >= 0 && c < k) {
        mine[(0 * k + c) * TM + row] += corr * wj;
        mine[(1 * k + c) * TM + row] += (2.f * base * corr + corr * corr) * wj;
        mine[(2 * k + c) * TM + row] += (corr * lj) * wj;
      }
    }
    __syncthreads();  // dt is rewritten by the next tile
  }
  red[0][sub][row] = bs;
  red[1][sub][row] = bq;
  red[2][sub][row] = bc;
  __syncthreads();
  float* outs[3] = {sums, sq, cross};
  for (int e = threadIdx.x; e < 3 * k * TM; e += NT) {
    const int i = e % TM;
    const int c = (e / TM) % k;
    const int q = e / (TM * k);
    if (row0 + i >= m) continue;
    float base = red[q][0][i];
    float bin = bins[(q * k + c) * TM + i];
#pragma unroll
    for (int t = 1; t < SUBS; ++t) {
      base += red[q][t][i];
      bin += bins[(((size_t)t * 3 + q) * k + c) * TM + i];
    }
    outs[q][(int64_t)c * m + row0 + i] = base + bin;
  }
}

}  // namespace

extern "C" int rt_swap_g_k_max() { return RT_SWAP_K_MAX; }

extern "C" int rt_swap_g(const float* x, const float* y, const float* d1,
                         const float* d2, const int* assign, const float* w,
                         const float* lg, float* sums, float* sq, float* cross,
                         int64_t m, int64_t b, int d, int k, int metric,
                         void* stream) {
  if (k < 1 || k > RT_SWAP_K_MAX) return (int)cudaErrorInvalidValue;
  if (m <= 0) return cudaSuccess;
  const unsigned grid = (unsigned)((m + TM - 1) / TM);
  const size_t smem = (size_t)SUBS * 3 * k * TM * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  RT_METRIC_SWITCH(metric, M, {
    cudaError_t e = cudaFuncSetAttribute(
        swap_g_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    swap_g_kernel<M><<<grid, NT, smem, st>>>(x, y, d1, d2, assign, w, lg, sums,
                                             sq, cross, m, b, d, k);
  });
  return (int)cudaGetLastError();
}
