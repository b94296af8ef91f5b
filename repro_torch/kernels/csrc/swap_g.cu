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
// The fold: the TPU kernel's one-hot [B, K] matrix product becomes a
// binned add.  Per row, four owners, one per residue of the column index
// mod 4, each walk their residue's columns in increasing order (across
// column tiles) with swap_tile.cuh's column routine: the base terms go to
// register partials, corr, 2*base*corr+corr^2 and corr*lg to the owner's
// shared-memory bins [k] chosen by a_j.  No atomics; the four owners'
// partials and bins are added 0 + 1 + 2 + 3 at the end (swap_fold_ld):
// the same function with k times less work than the one-hot product, the
// same bits on every run, in every SWAP kernel of the port.
//
// swap_g: two shape rules in rt_swap_g (rt_swap_g_route).
// * B <= 104, every k (the main path: B = 100): the pipelined,
//   register-blocked mainloop of dist_mainloop.cuh (WideTile: 128 rows x
//   104 columns a block, 128 threads, whose pairs have dist_tile's bits)
//   computes the batch as one column tile.  The finished [128, 105] tile
//   goes to shared memory over the stages (53,760 B), the batch's w, d1,
//   d2, lg and a beside it, and the 128 threads fold it as the owners
//   (row, residue) of R rows at a time, a warp per residue: R = 32 rows
//   a group for k <= 32, 16 for k > 32.  A group's bins live only during
//   its fold, beside the tile: at most 106,528 B of shared memory, two
//   blocks an SM.
// * B > 104: the 64 x 64 tile of dist_tile.cuh (swap_g_tile_kernel),
//   whose per-thread bins take 3,072 k B and persist across its column
//   tiles.  No fit of the port sends such a batch (ROADMAP B11).
// Both fold in the same order, so they give equal bits.
//
// swap_g_from_cache walks B in 64-column tiles with the 64-row map above
// and stages each [64, 64] block of the ring through shared memory with
// loads coalesced along its rows; it skips a tile whose weights are all
// 0 and does not read a weight-0 column (in the carried-moment repair
// most weights are 0), and it walks any B: there is no CACHE_B_MAX
// chunking.  All offsets are int64 (the full ring at n = 60000 holds
// 3.6e9 floats).  The bins cap k at RT_SWAP_K_MAX (dist_tile.cuh); the C
// entries refuse larger k.
#include <stdint.h>

#include "dist_mainloop.cuh"
#include "dist_tile.cuh"
#include "swap_tile.cuh"

namespace {

constexpr int TM = 64, TN = 64, NT = (TM / 4) * (TN / 4), SUBS = NT / TM;

using W = rt::WideTile;
constexpr int DT_LD = W::BN + 1;       // the distance tile's row stride
constexpr int DT = W::BM * DT_LD;      // its floats, over the stages
constexpr int VEC = 5 * W::BN;         // the batch's w, d1, d2, lg, a
constexpr int ONE_TILE_B = W::BN;      // B up to this is one column tile
static_assert(DT + VEC <= W::NORMS, "tile and vectors fit in the stages");

// Floats of one group's fold state: bins [SUBS][3][k][R], red [3][SUBS][R].
__host__ __device__ constexpr size_t group_floats(int k, int R) {
  return (size_t)(SUBS * 3 * k + 3 * SUBS) * R;
}

// The group's statistics to the [k, m] outputs: rows row0 .. row0 + R.
__device__ __forceinline__ void swap_group_out(const float* st, int k, int R,
                                               int64_t row0, int64_t m,
                                               float* const (&outs)[3]) {
  const float* red = st + (size_t)SUBS * 3 * k * R;
  for (int e = threadIdx.x; e < 3 * k * R; e += W::NT) {
    const int i = e % R, c = (e / R) % k, q = e / (R * k);
    if (row0 + i >= m) continue;
    outs[q][(int64_t)c * m + row0 + i] =
        rt::swap_fold_ld<SUBS>(red, st, k, R, q, c, i);
  }
}

// B <= 104: the batch is one column tile of the mainloop; each group's
// state goes beside the distance tile and the batch's vectors for the
// length of its fold.
template <int M>
__global__ void __launch_bounds__(W::NT, W::MINB)
swap_g_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ d1, const float* __restrict__ d2,
              const int* __restrict__ assign, const float* __restrict__ w,
              const float* __restrict__ lg, float* __restrict__ sums,
              float* __restrict__ sq, float* __restrict__ cross, int64_t m,
              int b, int d, int k, int R, bool vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* dt = smem;  // [BM][DT_LD] over the stages, after the mainloop
  float* const outs[3] = {sums, sq, cross};
  const int64_t row0 = (int64_t)blockIdx.x * W::BM;
  const int tx = W::tx(), ty = W::ty();
  const size_t gsz = group_floats(k, R);
  // Owner (row gi of the group, residue sub); threads past 4R idle.
  const int gi = threadIdx.x % R, sub = threadIdx.x / R;
  // The batch's vectors, staged over the stages beside dt.
  float* const cw = smem + DT;
  float* const cd1 = cw + W::BN;
  float* const cd2 = cd1 + W::BN;
  float* const clg = cd2 + W::BN;
  int* const ca = reinterpret_cast<int*>(clg + W::BN);
  float* const st = smem + DT + VEC;  // one group's bins, then red
  float4* const st4 = reinterpret_cast<float4*>(st);
  float* const red = st + (size_t)SUBS * 3 * k * R;
  float acc[W::RM][W::RN];
  rt::dist_mainloop<M, W>(x, y, m, b, d, row0, 0, vec, smem, acc);
  rt::dist_finish<M, W, false>(smem, acc);
#pragma unroll
  for (int i = 0; i < W::RM; ++i)
#pragma unroll
    for (int j = 0; j < W::RN; ++j)
      dt[(ty + W::TY * i) * DT_LD + tx + W::TX * j] = acc[i][j];
  for (int j = threadIdx.x; j < b; j += W::NT) {
    cw[j] = w[j];
    cd1[j] = d1[j];
    cd2[j] = d2[j];
    clg[j] = lg[j];
    ca[j] = assign[j];
  }
  __syncthreads();  // the groups' state goes over the norms
  for (int g = 0; g < W::BM / R; ++g) {
    for (size_t e = threadIdx.x; e < gsz / 4; e += W::NT)
      st4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    if (sub < SUBS) {
      float bs = 0.f, bq = 0.f, bc = 0.f;
      float* mine = st + (size_t)sub * 3 * k * R;
      const float* drow = dt + (g * R + gi) * DT_LD;
      // swap_col over the staged vectors: a weight-0 column adds only
      // zeros and is skipped.
#pragma unroll 4
      for (int j = sub; j < b; j += SUBS) {
        const float wj = cw[j];
        if (wj == 0.f) continue;
        rt::swap_col_vals(drow[j], wj, cd1[j], cd2[j], clg[j], ca[j], k, R,
                          gi, mine, bs, bq, bc);
      }
      red[(0 * SUBS + sub) * R + gi] = bs;
      red[(1 * SUBS + sub) * R + gi] = bq;
      red[(2 * SUBS + sub) * R + gi] = bc;
    }
    __syncthreads();
    swap_group_out(st, k, R, row0 + g * R, m, outs);
    __syncthreads();  // the next group's state goes over this one
  }
}

// B > 104: the 64 x 64 dist_tile, per-thread bins
// of the whole 64-row tile in dynamic shared memory.
template <int M>
__global__ void __launch_bounds__(NT)
swap_g_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ d1, const float* __restrict__ d2,
                   const int* __restrict__ assign,
                   const float* __restrict__ w, const float* __restrict__ lg,
                   float* __restrict__ sums, float* __restrict__ sq,
                   float* __restrict__ cross, int64_t m, int64_t b, int d,
                   int k) {
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
        rt::swap_fold_ld<SUBS>(&red[0][0][0], bins, k, TM, q, c, i);
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
        rt::swap_fold_ld<SUBS>(&red[0][0][0], bins, k, TM, q, c, i);
  }
}

template <int M>
cudaError_t launch_swap_g(const float* x, const float* y, const float* d1,
                          const float* d2, const int* assign, const float* w,
                          const float* lg, float* sums, float* sq,
                          float* cross, int64_t m, int b, int d, int k,
                          cudaStream_t st) {
  const int R = k <= 32 ? 32 : 16;
  const size_t beside =
      (DT + VEC) * sizeof(float) + group_floats(k, R) * sizeof(float);
  const size_t smem = W::SMEM > beside ? W::SMEM : beside;
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  const cudaError_t e = cudaFuncSetAttribute(
      swap_g_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((m + W::BM - 1) / W::BM);
  swap_g_kernel<M><<<grid, W::NT, smem, st>>>(x, y, d1, d2, assign, w, lg,
                                              sums, sq, cross, m, b, d, k, R,
                                              vec);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_swap_g_tile(const float* x, const float* y,
                               const float* d1, const float* d2,
                               const int* assign, const float* w,
                               const float* lg, float* sums, float* sq,
                               float* cross, int64_t m, int64_t b, int d,
                               int k, cudaStream_t st) {
  const size_t smem = (size_t)SUBS * 3 * k * TM * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      swap_g_tile_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((m + TM - 1) / TM);
  swap_g_tile_kernel<M><<<grid, NT, smem, st>>>(x, y, d1, d2, assign, w, lg,
                                                sums, sq, cross, m, b, d, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_swap_g_k_max() { return RT_SWAP_K_MAX; }

// Which kernel a shape runs (0: the mainloop's one-tile fold, 1: the
// 64 x 64 dist_tile): the shape rules of the header.
extern "C" int rt_swap_g_route(int64_t b) { return b <= ONE_TILE_B ? 0 : 1; }

extern "C" int rt_swap_g(const float* x, const float* y, const float* d1,
                         const float* d2, const int* assign, const float* w,
                         const float* lg, float* sums, float* sq, float* cross,
                         int64_t m, int64_t b, int d, int k, int metric,
                         void* stream) {
  if (k < 1 || k > RT_SWAP_K_MAX) return (int)cudaErrorInvalidValue;
  if (m <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (b < 1) {  // no column: every statistic is 0
    float* const outs[3] = {sums, sq, cross};
    for (float* o : outs) {
      const cudaError_t e =
          cudaMemsetAsync(o, 0, (size_t)k * m * sizeof(float), st);
      if (e != cudaSuccess) return (int)e;
    }
    return cudaSuccess;
  }
  const int route = rt_swap_g_route(b);
  RT_METRIC_SWITCH(metric, M, {
    if (route == 0)
      return (int)launch_swap_g<M>(x, y, d1, d2, assign, w, lg, sums, sq,
                                   cross, m, (int)b, d, k, st);
    return (int)launch_swap_g_tile<M>(x, y, d1, d2, assign, w, lg, sums, sq,
                                      cross, m, b, d, k, st);
  });
  return cudaSuccess;
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
