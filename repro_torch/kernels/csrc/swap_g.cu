// Fresh SWAP (FastPAM1, paper Eq. 12) arm statistics, float32: one
// kernel for a reference batch (swap_g) and for the whole reference set
// (stream_swap_g).
//
// Replaces the TPU kernels src/repro/kernels/swap_g.py:85
// (swap_g_kernel) and src/repro/kernels/stream_g.py:115
// (stream_swap_g_kernel), whose tile math is swap_stats_vals
// (swap_g.py:40), here swap_tile.cuh.  For every candidate row x of
// [m, d] against reference rows y_j of [r, d] with nearest /
// second-nearest medoid distances d1, d2, cluster ids a and weights w:
//   base_j = (min(d, d1_j) - d1_j) * w_j
//   corr_j = min(d, d2_j) - min(d, d1_j)
//   sums [c, x] = sum_j base_j      + sum_{a_j = c} corr_j w_j
//   sq   [c, x] = sum_j base_j^2    + sum_{a_j = c} (2 base_j corr_j + corr_j^2) w_j
//   cross[c, x] = sum_j base_j lg_j + sum_{a_j = c} corr_j lg_j w_j
// for all k medoid-arms c at once, written straight in the engine's
// [k, m] layout; only these outputs reach device memory.
//
// The walk: the references are cut into reference tiles of `period`
// columns, walked in order; each tile's statistics are summed on their
// own and added to the outputs in walk order, from 0.  stream_swap_g's
// period is 512 (REF_TILE, the engine's _EXACT_CHUNK: a 60,000-term sum
// is 118 sums of 512 terms); swap_g's is B, the whole batch, one tile.
// So at r = B <= 512 the two give equal bits.
//
// Bound on the H100: 2*m*r*d flops of distance work against 67 TFLOP/s
// float32 without tensor cores (swap_g at m = 60,000, B = 100, d = 784:
// 0.14 ms; stream_swap_g at m = r = 60,000: 84 ms), while x and y are
// read once: compute-bound.
//
// Design.  One block per row tile of x runs the pipelined,
// register-blocked mainloop of dist_mainloop.cuh (128 threads, 104
// columns, dist_math.cuh's bits for every pair; 128 rows, or 64 or 32 at
// the tile tuner's pick) over each reference tile in 104-column tiles,
// the last clipped to the reference tile (rows of y past it are
// zero-filled, not read; 104 = 0 mod 4, so a column's residue in its
// tile is its global one).  The finished [BM, 105] tile goes to shared
// memory over the stages, the tile's w, d1, d2, lg and a beside it, and
// the block folds it in BM / 32 groups of R = 32 rows: thread t is the
// owner (row t % 32, residue t / 32), a warp
// per residue, and adds the residue's columns in increasing order with
// swap_tile.cuh's column routine: base terms to three partials, cluster
// terms to its bins [3][k] chosen by a_j.  At a reference tile's end the
// group's statistics are red0 + red1 + red2 + red3 + (bin0 + bin1 + bin2
// + bin3) (swap_fold_ld).  No atomics: the same bits on every run.
//
// Where the bins live, for any k.  A group holds the bins of KC <= 32
// clusters at once, beside the tile in the freed stages (1,536 KC bytes);
// for k > 32 it walks its columns once per chunk of 32 clusters, each
// walk adding only its chunk's bins, so every bin gets the same adds in
// the same order at every k.  The base partials persist in shared memory
// beside the stages (6 KB).  A reference tile of one column tile (every
// swap_g batch of B <= 104, the fits' B = 100) needs nothing more.  A
// wider one (stream_swap_g; swap_g at B > 104) carries each group's bins
// from one column tile to the next in a global scratch [4][4][3][k][32]
// floats per block (6,144 k bytes), read and written a chunk at a time as
// float4s, 128 contiguous bytes a warp; the grid is then one resident
// block per slot (two an SM), each walking row tiles in turn, so the
// scratch is slots x 6,144 k bytes (16 MB at k = 10, inside the 50 MB
// L2).  The caller owns it: rt_swap_g_scratch gives its size in floats
// (0 where the launch needs none), the launcher allocates it on the
// launch's stream (PyTorch's allocator, so a peak-memory count sees
// it) and every launching entry takes it with its size; a launch that
// needs more than it was given returns cudaErrorInvalidValue.  No entry
// allocates device memory.
//
// sq and cross may be NULL (the exact pass reads only the sums): their
// stores are skipped, and the sums keep their bits.
// Dynamic shared memory at 128 rows: 81,312 B at k <= 10, at most
// 111,136 B (k >= 32): two blocks an SM at every k.  A row's columns
// take the same order at every row tile, so the row tiles' bits agree.
//
// The run flag.  rt_swap_g takes `run` (NULL: run), the device-resident
// search's "still running" flag: where it reads 0 every block returns
// before its first load, so a round enqueued after the search stopped
// costs a launch and leaves the outputs unwritten (the caller discards
// them).  Nothing else changes, so a flag of 1 gives the bits of NULL.
// rt_stream_swap_g takes it too: there it is the exact fallback's flag.
//
// The lane axis (rt_swap_g_lanes, fit_batch).  L independent fits padded
// to [L, n_pad, d] run as one launch: blockIdx.y is the lane, each lane
// with its own batch [B, d], d1 / d2 / assign / w / lg [B], run flag and
// row count rows[l] <= n_pad, and outputs [L, k, n_pad].  A block offsets
// every pointer to its lane (and its scratch to its own (lane, block)
// slot) and walks the lane's ceil(rows[l] / 128) row tiles with the
// single launch's body; every block of a lane whose flag reads 0 returns
// at once, and the unwritten outputs are for the caller to discard.  A
// row tile is computed by one block whatever the grid, so lane l gives
// the bits of rt_swap_g on its own [rows[l], d] slice; rt_swap_g and
// rt_stream_swap_g are the same kernel with one lane.
#include <stdint.h>

#include "dist_mainloop.cuh"
#include "swap_tile.cuh"

namespace {

constexpr int SUBS = 4;               // owners per row: residues mod 4
constexpr int R = 32;                 // rows of a fold group
constexpr int KC_MAX = 32;            // clusters a group's bins hold at once
constexpr int64_t REF_TILE = 512;     // stream_swap_g's period

// The fold's layout over a row tile W (dist_mainloop.cuh's
// with_row_tile: 128, 64 or 32 rows of 104 columns, 128 threads; a row's
// columns are in the same order in each, so every row tile gives the
// same bits).
template <class W>
struct Fold {
  static constexpr int GROUPS = W::BM / R;
  static constexpr int DT_LD = W::BN + 1;    // the distance tile's row stride
  static constexpr int DT = W::BM * DT_LD;   // its floats, over the stages
  static constexpr int VEC = 5 * W::BN;      // the tile's w, d1, d2, lg, a
  static constexpr int GRED = 3 * SUBS * R;  // one group's base partials
  static_assert(W::BM % R == 0, "whole fold groups");
  static_assert(SUBS * R == W::NT, "the block's threads are a group's owners");
  static_assert(W::BN % SUBS == 0 && REF_TILE % SUBS == 0,
                "a column's residue in its tile is its global one");
  static_assert(DT + VEC <= W::NORMS, "tile and vectors fit in the stages");
  static_assert((DT + VEC) % 4 == 0, "the bins are float4-aligned");
};

__host__ __device__ constexpr int bin_floats(int kc) {
  return SUBS * 3 * kc * R;
}

// Where the groups' base partials start: past the mainloop's stages and
// norms and past the tile, vectors and bins of a fold.
template <class W>
__host__ __device__ constexpr int red_offset(int kc) {
  return W::NORMS + W::ROWS > Fold<W>::DT + Fold<W>::VEC + bin_floats(kc)
             ? W::NORMS + W::ROWS
             : Fold<W>::DT + Fold<W>::VEC + bin_floats(kc);
}

// The launch's dynamic shared memory at k clusters.
template <class W>
size_t swap_smem(int k) {
  const int kc = k < KC_MAX ? k : KC_MAX;
  return (size_t)(red_offset<W>(kc) + Fold<W>::GROUPS * Fold<W>::GRED) *
         sizeof(float);
}

template <int M, class W>
__global__ void __launch_bounds__(W::NT, W::MINB)
swap_g_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ d1, const float* __restrict__ d2,
              const int* __restrict__ assign, const float* __restrict__ w,
              const float* __restrict__ lg, float* __restrict__ sums,
              float* __restrict__ sq, float* __restrict__ cross, int64_t m,
              int64_t r, int d, int k, int64_t period, bool vec,
              float* __restrict__ scratch, const int* __restrict__ run,
              const int* __restrict__ rows, int64_t n_pad) {
  using F = Fold<W>;
  constexpr int GROUPS = F::GROUPS, DT_LD = F::DT_LD, DT = F::DT;
  constexpr int VEC = F::VEC, GRED = F::GRED;
  const int lane = blockIdx.y;
  if (run != nullptr && run[lane] == 0) return;  // a masked round or lane
  if (rows != nullptr) m = rows[lane];
  x += lane * n_pad * d;
  y += lane * r * d;
  d1 += lane * r;
  d2 += lane * r;
  assign += lane * r;
  w += lane * r;
  lg += lane * r;
  sums += lane * k * n_pad;
  if (sq != nullptr) sq += lane * k * n_pad;
  if (cross != nullptr) cross += lane * k * n_pad;
  extern __shared__ float4 smem4[];
  const int kc = k < KC_MAX ? k : KC_MAX;
  float* smem = reinterpret_cast<float*>(smem4);
  float* const dt = smem;  // [BM][DT_LD] over the stages, after a mainloop
  float* const cw = smem + DT;
  float* const cd1 = cw + W::BN;
  float* const cd2 = cd1 + W::BN;
  float* const clg = cd2 + W::BN;
  int* const ca = reinterpret_cast<int*>(clg + W::BN);
  float* const bins = smem + DT + VEC;  // a group's [SUBS][3][kcc][R]
  float4* const bins4 = reinterpret_cast<float4*>(bins);
  float* const red = smem + red_offset<W>(kc);  // [GROUPS][3][SUBS][R]
  float* const outs[3] = {sums, sq, cross};
  // This block's bins between column tiles: [GROUPS][SUBS][3][k][R].
  float4* const keep4 =
      scratch == nullptr
          ? nullptr
          : reinterpret_cast<float4*>(
                scratch + ((size_t)lane * gridDim.x + blockIdx.x) * W::BM *
                              SUBS * 3 * k);
  const int tx = W::tx(), ty = W::ty();
  const int gi = threadIdx.x % R, sub = threadIdx.x / R;
  const int64_t ntiles = (m + W::BM - 1) / W::BM;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t row0 = tile * W::BM;
    for (int64_t t0 = 0; t0 < r; t0 += period) {
      const int64_t t1 = period < r - t0 ? t0 + period : r;
      for (int64_t col0 = t0; col0 < t1; col0 += W::BN) {
        const bool first = col0 == t0, last = col0 + W::BN >= t1;
        const int nc = t1 - col0 < W::BN ? (int)(t1 - col0) : W::BN;
        float acc[W::RM][W::RN];
        rt::dist_mainloop<M, W>(x, y, m, t1, d, row0, col0, vec, smem, acc);
        rt::dist_finish<M, W, false>(smem, acc);
#pragma unroll
        for (int i = 0; i < W::RM; ++i)
#pragma unroll
          for (int j = 0; j < W::RN; ++j)
            dt[(ty + W::TY * i) * DT_LD + tx + W::TX * j] = acc[i][j];
        for (int j = threadIdx.x; j < nc; j += W::NT) {
          cw[j] = w[col0 + j];
          cd1[j] = d1[col0 + j];
          cd2[j] = d2[col0 + j];
          clg[j] = lg[col0 + j];
          ca[j] = assign[col0 + j];
        }
        __syncthreads();  // the bins go over the norms
        for (int g = 0; g < GROUPS; ++g) {
          float* const gred = red + g * GRED;
          for (int c0 = 0; c0 < k; c0 += kc) {
            const int kcc = k - c0 < kc ? k - c0 : kc;
            const int seg4 = kcc * R / 4;  // float4s of one (owner, q) row
            // Segment s = sub * 3 + q holds clusters c0 .. c0 + kcc.
            for (int e = threadIdx.x; e < SUBS * 3 * seg4; e += W::NT) {
              const int s = e / seg4, o = e % seg4;
              bins4[e] = first ? make_float4(0.f, 0.f, 0.f, 0.f)
                               : keep4[((size_t)(g * SUBS * 3 + s) * k + c0) *
                                           (R / 4) + o];
            }
            __syncthreads();
            float bs = 0.f, bq = 0.f, bc = 0.f;
            if (!first) {
              bs = gred[(0 * SUBS + sub) * R + gi];
              bq = gred[(1 * SUBS + sub) * R + gi];
              bc = gred[(2 * SUBS + sub) * R + gi];
            }
            float* const mine = bins + (size_t)sub * 3 * kcc * R;
            const float* drow = dt + (g * R + gi) * DT_LD;
            // A weight-0 column adds only zeros and is skipped; a column
            // of another chunk adds to no bin here.
#pragma unroll 4
            for (int j = sub; j < nc; j += SUBS) {
              const float wj = cw[j];
              if (wj == 0.f) continue;
              rt::swap_col_vals(drow[j], wj, cd1[j], cd2[j], clg[j],
                                ca[j] - c0, kcc, R, gi, mine, bs, bq, bc);
            }
            if (c0 == 0) {  // the base partials are the first chunk's
              gred[(0 * SUBS + sub) * R + gi] = bs;
              gred[(1 * SUBS + sub) * R + gi] = bq;
              gred[(2 * SUBS + sub) * R + gi] = bc;
            }
            __syncthreads();
            if (last) {
              // The reference tile's sum, added to the output in walk order.
              for (int e = threadIdx.x; e < 3 * kcc * R; e += W::NT) {
                const int i = e % R, c = (e / R) % kcc, q = e / (R * kcc);
                const int64_t row = row0 + g * R + i;
                if (row >= m || outs[q] == nullptr) continue;
                float* o = outs[q] + (int64_t)(c0 + c) * n_pad + row;
                *o = (t0 == 0 ? 0.f : *o) +
                     rt::swap_fold_ld<SUBS>(gred, bins, kcc, R, q, c, i);
              }
            } else {
              for (int e = threadIdx.x; e < SUBS * 3 * seg4; e += W::NT) {
                const int s = e / seg4, o = e % seg4;
                keep4[((size_t)(g * SUBS * 3 + s) * k + c0) * (R / 4) + o] =
                    bins4[e];
              }
            }
            __syncthreads();  // the next chunk's bins go over these
          }
        }
      }
    }
  }
}

// A launch's grid over a reference set of r rows walked in tiles of
// `period`, for `lanes` lanes of m rows each, in row tile W, and the bin
// scratch it needs in floats (0: none).  Sets the kernel's shared-memory
// attribute, as the launch needs it.
template <int M, class W>
cudaError_t swap_g_plan(int64_t m, int64_t r, int k, int64_t period,
                        int lanes, int64_t* grid, int64_t* floats) {
  const size_t smem = swap_smem<W>(k);
  cudaError_t e = cudaFuncSetAttribute(
      swap_g_kernel<M, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int64_t ntiles = (m + W::BM - 1) / W::BM;
  *grid = ntiles;
  *floats = 0;
  if ((period < r ? period : r) > W::BN) {
    // Bins cross column tiles: one block a resident slot, a scratch each.
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, swap_g_kernel<M, W>, W::NT, smem);
    if (e != cudaSuccess) return e;
    const int64_t slots = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    const int64_t per_lane = slots / lanes > 1 ? slots / lanes : 1;
    *grid = ntiles < per_lane ? ntiles : per_lane;
    *floats = (int64_t)lanes * *grid * W::BM * SUBS * 3 * k;
  }
  return cudaSuccess;
}

// Launch over a reference set of r rows walked in tiles of `period`, for
// `lanes` lanes of m rows each (rows: each lane's count, NULL: m), in row
// tile W, with the caller's bin scratch of `scratch_floats` floats.
template <int M, class W>
cudaError_t launch_swap_g(const float* x, const float* y, const float* d1,
                          const float* d2, const int* assign, const float* w,
                          const float* lg, float* sums, float* sq,
                          float* cross, int64_t m, int64_t r, int d, int k,
                          int64_t period, const int* run, const int* rows,
                          int lanes, float* scratch, int64_t scratch_floats,
                          cudaStream_t st) {
  if (lanes > 65535) return cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  int64_t grid = 0, need = 0;
  cudaError_t e = swap_g_plan<M, W>(m, r, k, period, lanes, &grid, &need);
  if (e != cudaSuccess) return e;
  if (need > 0 && (scratch == nullptr || scratch_floats < need))
    return cudaErrorInvalidValue;
  swap_g_kernel<M, W><<<dim3((unsigned)grid, (unsigned)lanes), W::NT,
                        swap_smem<W>(k), st>>>(
      x, y, d1, d2, assign, w, lg, sums, sq, cross, m, r, d, k, period, vec,
      need > 0 ? scratch : nullptr, run, rows, m);
  return cudaGetLastError();
}

// Every entry's body: zeros for no column, else one launch in row tile
// `shape`.
int swap_entry(const float* x, const float* y, const float* d1,
               const float* d2, const int* assign, const float* w,
               const float* lg, float* sums, float* sq, float* cross,
               int64_t m, int64_t r, int d, int k, int64_t period,
               int metric, const int* run, const int* rows, int64_t lanes,
               float* scratch, int64_t scratch_floats, int shape,
               void* stream) {
  return rt::with_row_tile(shape, [&](auto tile) -> int {
    using W = decltype(tile);
    if (k < 1) return cudaErrorInvalidValue;
    if (m <= 0 || lanes <= 0) return cudaSuccess;
    cudaStream_t st = (cudaStream_t)stream;
    if (r < 1) {  // no column: every statistic is 0
      float* const outs[3] = {sums, sq, cross};
      for (float* o : outs) {
        if (o == nullptr) continue;
        const cudaError_t e = cudaMemsetAsync(
            o, 0, (size_t)lanes * k * m * sizeof(float), st);
        if (e != cudaSuccess) return e;
      }
      return cudaSuccess;
    }
    RT_METRIC_SWITCH(metric, M, {
      return launch_swap_g<M, W>(x, y, d1, d2, assign, w, lg, sums, sq,
                                 cross, m, r, d, k, period, run, rows,
                                 (int)lanes, scratch, scratch_floats, st);
    });
    return cudaSuccess;
  });
}

// The bin scratch, in floats, of a launch of row tile `shape` with these
// extents (0 where it needs none).
int swap_scratch(int64_t m, int64_t r, int k, int64_t period, int metric,
                 int64_t lanes, int shape, int64_t* floats) {
  *floats = 0;
  return rt::with_row_tile(shape, [&](auto tile) -> int {
    using W = decltype(tile);
    if (k < 1 || lanes > 65535) return cudaErrorInvalidValue;
    if (m <= 0 || lanes <= 0 || r < 1) return cudaSuccess;
    int64_t grid = 0;
    RT_METRIC_SWITCH(metric, M, {
      return swap_g_plan<M, W>(m, r, k, period, (int)lanes, &grid, floats);
    });
    return cudaErrorInvalidValue;
  });
}

// Row tile `shape`'s rows, columns, threads and blocks an SM (l2, at k
// clusters) into info[0..3], for the tuner's wave model.
int swap_shape(int shape, int k, int* info) {
  return rt::with_row_tile(shape, [&](auto tile) -> int {
    using W = decltype(tile);
    if (k < 1) return cudaErrorInvalidValue;
    int per_sm = 0;
    const cudaError_t e = rt::blocks_per_sm(swap_g_kernel<rt::L2, W>, W::NT,
                                            swap_smem<W>(k), &per_sm);
    if (e != cudaSuccess) return e;
    return rt::shape_info<W>(info, per_sm);
  });
}

}  // namespace

// The _tiled entries take the row tile the caller resolved (the tile
// tuner, through ops.py; dist_mainloop.cuh's with_row_tile); rt_swap_g,
// rt_swap_g_lanes and rt_stream_swap_g keep the wide tile.  Every entry
// takes the bin scratch (NULL where rt_swap_g_scratch says 0 floats) and
// its size in floats after the run flag.

// swap_g: a batch of b reference columns, one reference tile.
extern "C" int rt_swap_g_tiled(const float* x, const float* y,
                               const float* d1, const float* d2,
                               const int* assign, const float* w,
                               const float* lg, float* sums, float* sq,
                               float* cross, int64_t m, int64_t b, int d,
                               int k, int metric, const int* run,
                               float* scratch, int64_t scratch_floats,
                               int shape, void* stream) {
  return swap_entry(x, y, d1, d2, assign, w, lg, sums, sq, cross, m, b, d, k,
                    b, metric, run, nullptr, 1, scratch, scratch_floats,
                    shape, stream);
}

extern "C" int rt_swap_g(const float* x, const float* y, const float* d1,
                         const float* d2, const int* assign, const float* w,
                         const float* lg, float* sums, float* sq, float* cross,
                         int64_t m, int64_t b, int d, int k, int metric,
                         const int* run, float* scratch,
                         int64_t scratch_floats, void* stream) {
  return rt_swap_g_tiled(x, y, d1, d2, assign, w, lg, sums, sq, cross, m, b,
                         d, k, metric, run, scratch, scratch_floats, 0,
                         stream);
}

// The lane axis: x [lanes, n_pad, d], y [lanes, b, d], d1 / d2 / assign /
// w / lg [lanes, b], outputs [lanes, k, n_pad]; run and rows [lanes]
// (NULL: every lane runs, over all n_pad rows).
extern "C" int rt_swap_g_lanes_tiled(const float* x, const float* y,
                                     const float* d1, const float* d2,
                                     const int* assign, const float* w,
                                     const float* lg, float* sums, float* sq,
                                     float* cross, int64_t lanes,
                                     int64_t n_pad, int64_t b, int d, int k,
                                     int metric, const int* rows,
                                     const int* run, float* scratch,
                                     int64_t scratch_floats, int shape,
                                     void* stream) {
  return swap_entry(x, y, d1, d2, assign, w, lg, sums, sq, cross, n_pad, b,
                    d, k, b, metric, run, rows, lanes, scratch,
                    scratch_floats, shape, stream);
}

extern "C" int rt_swap_g_lanes(const float* x, const float* y,
                               const float* d1, const float* d2,
                               const int* assign, const float* w,
                               const float* lg, float* sums, float* sq,
                               float* cross, int64_t lanes, int64_t n_pad,
                               int64_t b, int d, int k, int metric,
                               const int* rows, const int* run,
                               float* scratch, int64_t scratch_floats,
                               void* stream) {
  return rt_swap_g_lanes_tiled(x, y, d1, d2, assign, w, lg, sums, sq, cross,
                               lanes, n_pad, b, d, k, metric, rows, run,
                               scratch, scratch_floats, 0, stream);
}

// stream_swap_g: all r reference rows, in 512-column reference tiles.
extern "C" int rt_stream_swap_g_tiled(const float* x, const float* y,
                                      const float* d1, const float* d2,
                                      const int* assign, const float* w,
                                      const float* lg, float* sums, float* sq,
                                      float* cross, int64_t m, int64_t r,
                                      int d, int k, int metric,
                                      const int* run, float* scratch,
                                      int64_t scratch_floats, int shape,
                                      void* stream) {
  if (r < 1) return (int)cudaErrorInvalidValue;
  return swap_entry(x, y, d1, d2, assign, w, lg, sums, sq, cross, m, r, d, k,
                    REF_TILE, metric, run, nullptr, 1, scratch,
                    scratch_floats, shape, stream);
}

extern "C" int rt_stream_swap_g(const float* x, const float* y,
                                const float* d1, const float* d2,
                                const int* assign, const float* w,
                                const float* lg, float* sums, float* sq,
                                float* cross, int64_t m, int64_t r, int d,
                                int k, int metric, const int* run,
                                float* scratch, int64_t scratch_floats,
                                void* stream) {
  return rt_stream_swap_g_tiled(x, y, d1, d2, assign, w, lg, sums, sq, cross,
                                m, r, d, k, metric, run, scratch,
                                scratch_floats, 0, stream);
}

// The bin scratch of a launch, in floats, into *floats (0: the launch
// needs none): m rows a lane, r reference rows walked in tiles of
// `period` (b for swap_g and its lane form, 512 for stream_swap_g),
// `lanes` lanes (1 for the single entries), row tile `shape`.
extern "C" int rt_swap_g_scratch(int64_t m, int64_t r, int k, int64_t period,
                                 int metric, int64_t lanes, int shape,
                                 int64_t* floats) {
  return swap_scratch(m, r, k, period, metric, lanes, shape, floats);
}

// The shape queries of swap_g and stream_swap_g (one kernel: the same
// occupancy; stream_swap_g's grid is then one block a slot).
extern "C" int rt_swap_g_shape(int shape, int k, int* info) {
  return swap_shape(shape, k, info);
}

extern "C" int rt_stream_swap_g_shape(int shape, int k, int* info) {
  return swap_shape(shape, k, info);
}
