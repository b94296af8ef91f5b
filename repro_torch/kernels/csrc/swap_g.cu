// Fused SWAP (FastPAM1, paper Eq. 12) arm statistics, float32: two kernels.
//
// swap_g replaces the TPU kernel src/repro/kernels/swap_g.py:85
// (swap_g_kernel), swap_g_from_cache the TPU kernel :118
// (swap_g_from_cache_kernel, body _kernel_cached :76); both reduce their
// distances with the tile math of swap_stats_vals (:40), here
// swap_tile.cuh.  For every candidate row x against a reference batch of
// B columns with nearest/second-nearest medoid distances d1, d2, cluster
// ids a and {0,1} weights w:
//   base_j = (min(d, d1_j) - d1_j) * w_j
//   corr_j = min(d, d2_j) - min(d, d1_j)
//   sums [c, x] = sum_j base_j       + sum_{j: a_j = c} corr_j * w_j
//   sq   [c, x] = sum_j base_j^2     + sum_{j: a_j = c} (2 base_j corr_j + corr_j^2) * w_j
//   cross[c, x] = sum_j base_j lg_j  + sum_{j: a_j = c} corr_j * lg_j * w_j
// for all k medoid-arms c at once, written straight in the engine's
// [k, m] layout.  swap_g computes d(x, y_j) from x [m, d] and y [B, d];
// swap_g_from_cache reads it from a resident [m, B] block of the PIC
// column ring (row stride ld: a column slice of the ring, or the whole
// ring in the carried-moment repair) and does no distance work.
//
// swap_g's bound on the H100: the same 2*m*B*d distance flops as build_g
// (compute-bound at m=60000, B=100, d=784).  swap_g_from_cache's: its
// bytes, m*B*4 read (24 MB for one round at m=60000, B=100; 14.4 GB for
// the full ring at B=60000) plus 3*k*m*4 written.
//
// Design: the TPU kernel's one-hot [B, K] matrix product becomes a
// binned add.  The per-row base terms go to register scalars; corr,
// 2*base*corr+corr^2 and corr*lg go to a shared-memory bin [k] per (row,
// thread) chosen by a_j.  Each of the four threads of a row owns its
// bins, so there are no atomics, and the bins are added in a fixed order
// at the end: the same function with k times less work than the one-hot
// product, the same bits on every run.  Both kernels walk B in 64-column
// tiles with the same thread-to-column map and call the same column and
// fold routines, so given equal distances their outputs are equal bit for
// bit.  swap_g_from_cache stages each [64, 64] block of the ring through
// shared memory with loads coalesced along its rows; it skips a tile
// whose weights are all 0 and does not read a weight-0 column (in the
// carried-moment repair most weights are 0), and it walks any B: there
// is no CACHE_B_MAX chunking.  All offsets are int64 (the full ring at
// n = 60000 holds 3.6e9 floats).  The bins take 3*k*256 floats of dynamic
// shared memory, which caps k at RT_SWAP_K_MAX (dist_tile.cuh); the C
// entries refuse larger k.
#include "dist_tile.cuh"
#include "swap_tile.cuh"

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
    for (int j = sub; j < nc; j += SUBS)
      rt::swap_col<TM>(s.dt[row][j], col0 + j, d1, d2, assign, w, lg, k, row,
                       mine, bs, bq, bc);
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
    outs[q][(int64_t)c * m + row0 + i] =
        rt::swap_fold_at<TM, SUBS>(red, bins, k, q, c, i);
  }
}

__global__ void __launch_bounds__(NT)
swap_g_from_cache_kernel(const float* __restrict__ dxy, int64_t ld,
                         const float* __restrict__ d1,
                         const float* __restrict__ d2,
                         const int* __restrict__ assign,
                         const float* __restrict__ w,
                         const float* __restrict__ lg,
                         float* __restrict__ sums, float* __restrict__ sq,
                         float* __restrict__ cross, int64_t m, int64_t b,
                         int k) {
  __shared__ float dt[TM][TN + 1];
  __shared__ float red[3][SUBS][TM];
  extern __shared__ float bins[];  // [SUBS][3][k][TM]
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int row = threadIdx.x % TM;
  const int sub = threadIdx.x / TM;
  float* mine = bins + (size_t)sub * 3 * k * TM;  // this thread: [3][k][TM]
  for (int e = threadIdx.x; e < SUBS * 3 * k * TM; e += NT) bins[e] = 0.f;
  float bs = 0.f, bq = 0.f, bc = 0.f;
  for (int64_t col0 = 0; col0 < b; col0 += TN) {
    const int nc = b - col0 < TN ? (int)(b - col0) : TN;
    // A tile whose weights are all 0 adds nothing: skip it whole.
    const int tj = threadIdx.x % TN;
    if (!__syncthreads_or(tj < nc && w[col0 + tj] != 0.f)) continue;
    // Stage the [TM, nc] block, a warp reading 32 consecutive columns of
    // one row; weight-0 columns and rows past m are not read.
    for (int e = threadIdx.x; e < TM * TN; e += NT) {
      const int i = e / TN, j = e % TN;
      const int64_t gr = row0 + i;
      float v = 0.f;
      if (gr < m && j < nc && w[col0 + j] != 0.f) v = dxy[gr * ld + col0 + j];
      dt[i][j] = v;
    }
    __syncthreads();
    for (int j = sub; j < nc; j += SUBS)
      rt::swap_col<TM>(dt[row][j], col0 + j, d1, d2, assign, w, lg, k, row,
                       mine, bs, bq, bc);
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
    outs[q][(int64_t)c * m + row0 + i] =
        rt::swap_fold_at<TM, SUBS>(red, bins, k, q, c, i);
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

extern "C" int rt_swap_g_from_cache(const float* dxy, int64_t ld,
                                    const float* d1, const float* d2,
                                    const int* assign, const float* w,
                                    const float* lg, float* sums, float* sq,
                                    float* cross, int64_t m, int64_t b, int k,
                                    void* stream) {
  if (k < 1 || k > RT_SWAP_K_MAX || b < 1 || ld < b)
    return (int)cudaErrorInvalidValue;
  if (m <= 0) return cudaSuccess;
  const unsigned grid = (unsigned)((m + TM - 1) / TM);
  const size_t smem = (size_t)SUBS * 3 * k * TM * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      swap_g_from_cache_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  swap_g_from_cache_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      dxy, ld, d1, d2, assign, w, lg, sums, sq, cross, m, b, k);
  return (int)cudaGetLastError();
}
