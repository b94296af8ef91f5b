// Nearest / second-nearest medoid per row (top-2), float32.
//
// Replaces the TPU kernel src/repro/kernels/stream_g.py:165
// (stream_top2_kernel, its pallas_call at :179).  For every row x of
// [n, d] against the k medoid rows [k, d]: d1 = min_c d(x, med_c),
// assign = the FIRST c attaining d1, d2 = min over the other columns (so
// duplicate medoid rows give d2 == d1; d2 = +inf when k == 1).  Any
// k >= 1.  The [n, k] block never reaches device memory.
//
// The distances are the pipelined mainloop's (dist_mainloop.cuh), whose
// chains, norms and epilogue are dist_math.cuh's: a (row, medoid) pair
// gets the bits pairwise.cu gives it, so pairwise's row minima are d1
// and d2 exactly.
//
// Bounds on the H100 at n = 60,000, d = 784 (2*n*k*d flops against
// 67 TFLOP/s float32; x read once, 188 MB, against 3.35 TB/s):
//   k = 10:  0.94 GFLOP, 0.014 ms < 0.056 ms of bytes: memory-bound;
//   k = 65:  6.1 GFLOP, 0.091 ms: compute-bound;
//   k = 200: 18.8 GFLOP, 0.281 ms: compute-bound.
// A block holds BM rows of x and walks the medoids in BN-column tiles,
// in index order, with its rows fixed: x is staged once a column tile,
// not once per 16 medoids.  Four shapes; the tile tuner
// (repro_torch/core/tuning.py, through rt_top2_tiled) and rt_top2 take
// the one whose walk, ceil(k / BN) column tiles at the tile's measured
// time, is shortest (SHAPE_US here, tuning.TOP2_TILE_US there):
// * the narrow tile, 64 x 16, 2 x 4 pairs a thread, four blocks an SM:
//   k <= 16 (the default fit, predict).  x streams once through the
//   cp.async ring; the medoid rows come from L2.  The limit besides HBM
//   is the shared-memory pipe: 6 float4 reads (24 wavefronts a warp) per
//   32 FMAs a thread, a third of the FMA rate, 16 columns computed for
//   k = 10.
// * 128 x 40 (8 x 5 pairs, 13 float4 reads per 160 FMAs): k of 17-40,
//   73-80, 105-120, 145-160.
// * 128 x 72 (8 x 9 pairs, 17 reads per 288 FMAs): k of 41-72, 121-144;
//   at k = 65 10 % of its columns are padding, not the wide tile's 38 %.
// * the wide tile, 128 x 104 (8 x 13 pairs, 21 reads per 416 FMAs): k of
//   81-104, 161-208; k = 200 walks two column tiles.
// Past 208 each k takes whichever walk is shortest.  The 128-row shapes
// run two blocks an SM (up to 255 registers).
// Columns past k are masked to +inf before the scan; rows past n are
// computed from zeros and not stored; d % 4 != 0 or an unaligned base
// takes the mainloop's 4-byte copies.
//
// The reduction.  A thread owns the columns tx + TX*j of each column
// tile and scans them in increasing index with strict <, keeping (best,
// arg, second) per row, as one thread scanning all columns would.  The
// TX threads of a row (consecutive lanes of one warp) then merge their
// triples by shuffles, lexicographically on (value, index); lane
// i % TX keeps row i's running triple in registers across the column
// tiles and merges each tile's into it the same way.
// Why this equals the sequential scan: over a sequence of values the
// strict-< scan returns best = the minimum, arg = the smallest index
// attaining it (a later equal value never passes best < v), and second
// = the minimum of the multiset with one copy of best removed (an equal
// value passes the second test); NaNs fail both tests and are skipped.
// So the scan of a column set S is a function of S alone, not of its
// order: the lexicographic minimum (b, a) of its (value, index) pairs
// and the least value of the other pairs.  For disjoint S and T with
// results (b, a, s) and (b', a', s'), if (b', a') < (b, a) the union's
// minimum pair is (b', a') and its other pairs are T's others plus all
// of S, whose least is min(s', b); otherwise symmetrically (b, a,
// min(s, b')).  That is the merge.  A set whose values are all +inf or
// NaN keeps the initial (+inf, none, +inf); a row with no finite value
// gets assign 0, as the sequential scan's initial arg.
//
// The lane axis (rt_top2_lanes, fit_batch).  L independent fits padded to
// [L, n_pad, d] against their own medoids [L, k, d] run as one launch:
// blockIdx.y is the lane, rows[l] <= n_pad its row count, and the outputs
// are [L, n_pad].  A block offsets every pointer to its lane and runs the
// single launch's body with n = rows[l]; blocks past rows[l] return at
// once, and the outputs past a lane's rows stay unwritten.  Lane l gives
// the bits of rt_top2 on its own slice; rt_top2 is the same kernel with
// one lane.
#include <stdint.h>

#include "dist_mainloop.cuh"

namespace {

using Narrow = rt::NarrowTile;                      // 64 x 16
using Mid40 = rt::Mainloop<16, 8, 8, 5, 16, 4, 2>;  // 128 x 40
using Mid72 = rt::Mainloop<16, 8, 8, 9, 16, 4, 2>;  // 128 x 72
using Wide = rt::WideTile;                          // 128 x 104
constexpr int SHAPES = 4;
constexpr int SHAPE_BN[SHAPES] = {Narrow::BN, Mid40::BN, Mid72::BN, Wide::BN};
// One column tile's time over n = 60,000 rows, d = 784, l2, in us
// (chip_ab.py on an H100, each shape timed at every k).
constexpr int SHAPE_US[SHAPES] = {100, 153, 233, 310};
constexpr int NO_ARG = 0x7fffffff;  // no column passed the scan yet

// The shape whose walk over k medoids is shortest (the narrower on a tie).
int pick_shape(int k) {
  int best = 0;
  int64_t best_us = INT64_MAX;
  for (int s = 0; s < SHAPES; ++s) {
    const int64_t us =
        ((int64_t)k + SHAPE_BN[s] - 1) / SHAPE_BN[s] * SHAPE_US[s];
    if (us < best_us) {
      best = s;
      best_us = us;
    }
  }
  return best;
}

__device__ __forceinline__ void scan_step(float v, int c, float& best,
                                          int& arg, float& second) {
  if (v < best) {
    second = best;
    best = v;
    arg = c;
  } else if (v < second) {
    second = v;
  }
}

// Merge the triple of a disjoint column set into (best, arg, second).
__device__ __forceinline__ void merge(float ob, int oa, float os, float& best,
                                      int& arg, float& second) {
  if (ob < best || (ob == best && oa < arg)) {
    second = fminf(os, best);
    best = ob;
    arg = oa;
  } else {
    second = fminf(second, ob);
  }
}

template <int M, class C>
__global__ void __launch_bounds__(C::NT, C::MINB)
top2_kernel(const float* __restrict__ x, const float* __restrict__ med,
            float* __restrict__ d1, float* __restrict__ d2,
            int* __restrict__ assign, int64_t n, int k, int d, bool vec,
            const int* __restrict__ rows, int64_t n_pad) {
  const int fit = blockIdx.y;  // the lane of the lane axis
  if (rows != nullptr) n = rows[fit];
  const int64_t a0 = (int64_t)blockIdx.x * C::BM;
  if (a0 >= n) return;  // past the lane's rows: the whole block
  x += fit * n_pad * d;
  med += (int64_t)fit * k * d;
  d1 += fit * n_pad;
  d2 += fit * n_pad;
  assign += fit * n_pad;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int OWN = (C::RM + C::TX - 1) / C::TX;  // rows a lane keeps
  static_assert(32 % C::TX == 0, "a row's lanes share a warp");
  const int tx = C::tx(), ty = C::ty();
  float run_b[OWN], run_s[OWN];
  int run_a[OWN];
#pragma unroll
  for (int q = 0; q < OWN; ++q) {
    run_b[q] = INFINITY;
    run_s[q] = INFINITY;
    run_a[q] = NO_ARG;
  }
  for (int b0 = 0; b0 < k; b0 += C::BN) {
    float acc[C::RM][C::RN];
    rt::dist_mainloop<M, C>(x, med, n, k, d, a0, b0, vec, smem, acc);
    rt::dist_finish<M, C, false>(smem, acc);
    float best[C::RM], second[C::RM];
    int arg[C::RM];
#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      best[i] = INFINITY;
      second[i] = INFINITY;
      arg[i] = NO_ARG;
    }
#pragma unroll
    for (int j = 0; j < C::RN; ++j) {
      const int c = b0 + tx + C::TX * j;
#pragma unroll
      for (int i = 0; i < C::RM; ++i)
        scan_step(c < k ? acc[i][j] : INFINITY, c, best[i], arg[i],
                  second[i]);
    }
#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
#pragma unroll
      for (int o = 1; o < C::TX; o <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[i], o);
        const int oa = __shfl_xor_sync(0xffffffffu, arg[i], o);
        const float os = __shfl_xor_sync(0xffffffffu, second[i], o);
        merge(ob, oa, os, best[i], arg[i], second[i]);
      }
      if (i % C::TX == tx)
        merge(best[i], arg[i], second[i], run_b[i / C::TX], run_a[i / C::TX],
              run_s[i / C::TX]);
    }
  }
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    const int64_t row = a0 + ty + C::TY * i;
    if (i % C::TX == tx && row < n) {
      const int q = i / C::TX;
      d1[row] = run_b[q];
      d2[row] = run_s[q];
      assign[row] = run_a[q] == NO_ARG ? 0 : run_a[q];
    }
  }
}

template <int M, class C>
cudaError_t launch(const float* x, const float* med, float* d1, float* d2,
                   int* assign, int64_t n, int k, int d, bool vec,
                   const int* rows, int lanes, cudaStream_t st) {
  const dim3 grid((unsigned)((n + C::BM - 1) / C::BM), (unsigned)lanes);
  auto kernel = top2_kernel<M, C>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, C::NT, C::SMEM, st>>>(x, med, d1, d2, assign, n, k, d, vec,
                                       rows, n);
  return cudaGetLastError();
}

// The shapes of the _tiled entries, by index (tuning.TOP2_SHAPES): 0
// the narrow tile (64 x 16), 1 Mid40, 2 Mid72, 3 the wide tile.
template <class F>
int with_shape(int shape, F&& f) {
  switch (shape) {
    case 0:
      return f(Narrow{});
    case 1:
      return f(Mid40{});
    case 2:
      return f(Mid72{});
    case 3:
      return f(Wide{});
  }
  return (int)cudaErrorInvalidValue;
}

// One launch over `lanes` lanes of n rows (rows: each lane's count, NULL:
// n for every lane) in shape `shape`.
int top2(const float* x, const float* med, float* d1, float* d2, int* assign,
         int64_t n, int k, int d, int metric, const int* rows, int lanes,
         int shape, void* stream) {
  return with_shape(shape, [&](auto tile) -> int {
    using C = decltype(tile);
    if (k < 1 || lanes > 65535) return cudaErrorInvalidValue;
    if (n <= 0 || lanes <= 0) return cudaSuccess;
    const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)med % 16 == 0;
    cudaStream_t st = (cudaStream_t)stream;
    RT_METRIC_SWITCH(metric, M, {
      return launch<M, C>(x, med, d1, d2, assign, n, k, d, vec, rows, lanes,
                          st);
    });
    return cudaSuccess;
  });
}

}  // namespace

// The _tiled entries take the shape the caller resolved (the tile tuner's
// pick by k, through ops.py); rt_top2 and rt_top2_lanes keep choosing it
// by k here (pick_shape).
extern "C" int rt_top2_tiled(const float* x, const float* med, float* d1,
                             float* d2, int* assign, int64_t n, int k, int d,
                             int metric, int shape, void* stream) {
  return top2(x, med, d1, d2, assign, n, k, d, metric, nullptr, 1, shape,
              stream);
}

extern "C" int rt_top2(const float* x, const float* med, float* d1, float* d2,
                       int* assign, int64_t n, int k, int d, int metric,
                       void* stream) {
  return rt_top2_tiled(x, med, d1, d2, assign, n, k, d, metric,
                       pick_shape(k), stream);
}

// The lane axis: x [lanes, n_pad, d], med [lanes, k, d], outputs
// [lanes, n_pad]; rows [lanes] (NULL: n_pad rows in every lane).
extern "C" int rt_top2_lanes_tiled(const float* x, const float* med,
                                   float* d1, float* d2, int* assign,
                                   int64_t lanes, int64_t n_pad, int k, int d,
                                   int metric, const int* rows, int shape,
                                   void* stream) {
  return top2(x, med, d1, d2, assign, n_pad, k, d, metric, rows, (int)lanes,
              shape, stream);
}

extern "C" int rt_top2_lanes(const float* x, const float* med, float* d1,
                             float* d2, int* assign, int64_t lanes,
                             int64_t n_pad, int k, int d, int metric,
                             const int* rows, void* stream) {
  return rt_top2_lanes_tiled(x, med, d1, d2, assign, lanes, n_pad, k, d,
                             metric, rows, pick_shape(k), stream);
}

// Shape `shape`'s rows, columns, threads and blocks an SM (l2) into
// info[0..3], for the tuner.
extern "C" int rt_top2_shape(int shape, int k, int* info) {
  (void)k;
  return with_shape(shape, [&](auto tile) -> int {
    using C = decltype(tile);
    int per_sm = 0;
    const cudaError_t e =
        rt::blocks_per_sm(top2_kernel<rt::L2, C>, C::NT, C::SMEM, &per_sm);
    if (e != cudaSuccess) return e;
    return rt::shape_info<C>(info, per_sm);
  });
}
