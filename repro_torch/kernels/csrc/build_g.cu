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
// cores (0.14 ms), while x is read once (188 MB at 3.35 TB/s, 0.056 ms):
// compute-bound.  Design: one block per row tile (128 rows, or 64 or 32
// at the tile tuner's pick) runs the pipelined, register-blocked
// mainloop of dist_mainloop.cuh over the batch in 104-column tiles (one
// tile for B <= 104, so x is staged once a round).  The finished
// [BM, 104] distance tile goes to shared memory over the free pipeline
// stages, and one thread per row folds it in a fixed order: for each
// row, four partials, one per residue of the column index mod 4, each
// over its columns in increasing order (across column tiles), added
// 0 + 1 + 2 + 3 at the end.  That is stream_build_g's fold over one
// 512-column reference tile, and the distances are the mainloop's bits
// (dist_math.cuh), so at B <= 512 the two kernels' sums are equal bit
// for bit, at every row tile of either.  No atomics: every run gives the
// same bits.  The isinf(dnear) branch is
// the TPU kernel's.
//
// The run flag.  `run` (NULL: run) is the device-resident search's "still
// running" flag: a round enqueued after the search stopped reads 0 there,
// and every block returns before its first load, so a masked round costs
// a launch and leaves the outputs unwritten (the caller discards them).
// The flag changes nothing else: arithmetic, tile and walk order are the
// same, so a flag of 1 gives the bits of NULL.
//
// The lane axis (rt_build_g_lanes, fit_batch).  L independent fits padded
// to [L, n_pad, d] run as one launch: blockIdx.y is the lane, each lane
// with its own batch [B, d], dnear / w / lg [B], run flag and row count
// rows[l] <= n_pad, and outputs [L, n_pad].  A block offsets every
// pointer to its lane and runs the single launch's body with m = rows[l]:
// blocks past rows[l] and every block of a lane whose flag reads 0
// return at once, and the unwritten outputs are for the caller to
// discard.  Lane l therefore gives the bits of rt_build_g on its own
// [rows[l], d] slice; rt_build_g is the same kernel with one lane.
#include <stdint.h>

#include "dist_mainloop.cuh"

namespace {

constexpr int SUBS = 4;  // partials per row: column residues mod 4

// W: the row tile (dist_mainloop.cuh's with_row_tile); its BN = 104 and
// TX, RN fix each row's column order, so every row tile gives the same
// bits.  Thread t < BM folds row t.
template <int M, class W>
__global__ void __launch_bounds__(W::NT, W::MINB)
build_g_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ dnear, const float* __restrict__ w,
               const float* __restrict__ lg, float* __restrict__ sums,
               float* __restrict__ sq, float* __restrict__ cross, int64_t m,
               int64_t b, int d, bool vec, const int* __restrict__ run,
               const int* __restrict__ rows, int64_t n_pad) {
  constexpr int DT_LD = W::BN + 1;  // the distance tile's row stride
  static_assert(W::BN % SUBS == 0, "a column keeps its residue across tiles");
  static_assert(W::NT >= W::BM, "one thread folds each row");
  static_assert(W::BM * DT_LD <= W::NORMS, "the tile fits in the stages");
  const int lane = blockIdx.y;
  if (run != nullptr && run[lane] == 0) return;  // a masked round or lane
  if (rows != nullptr) m = rows[lane];
  const int64_t row0 = (int64_t)blockIdx.x * W::BM;
  if (row0 >= m) return;  // past the lane's rows: the whole block
  x += lane * n_pad * d;
  y += lane * b * d;
  dnear += lane * b;
  w += lane * b;
  lg += lane * b;
  sums += lane * n_pad;
  sq += lane * n_pad;
  cross += lane * n_pad;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* dt = smem;  // [BM][DT_LD] over the stages, after each mainloop
  const int tx = W::tx(), ty = W::ty();
  const int row = threadIdx.x;
  const bool folds = row < W::BM;
  float p[SUBS][3];  // (sums, sq, cross) partials of each residue
#pragma unroll
  for (int s = 0; s < SUBS; ++s) p[s][0] = p[s][1] = p[s][2] = 0.f;
  for (int64_t col0 = 0; col0 < b; col0 += W::BN) {
    float acc[W::RM][W::RN];
    rt::dist_mainloop<M, W>(x, y, m, b, d, row0, col0, vec, smem, acc);
    rt::dist_finish<M, W, false>(smem, acc);
#pragma unroll
    for (int i = 0; i < W::RM; ++i)
#pragma unroll
      for (int j = 0; j < W::RN; ++j)
        dt[(ty + W::TY * i) * DT_LD + tx + W::TX * j] = acc[i][j];
    __syncthreads();
    const int nc = b - col0 < W::BN ? (int)(b - col0) : W::BN;
    if (folds) {
#pragma unroll
      for (int s = 0; s < SUBS; ++s)
        for (int j = s; j < nc; j += SUBS)
          rt::build_g_term(dt[row * DT_LD + j], dnear[col0 + j], w[col0 + j],
                           lg[col0 + j], p[s][0], p[s][1], p[s][2]);
    }
    __syncthreads();  // the next column tile stages over dt
  }
  if (folds && row0 + row < m) {
    float a[3];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      a[t] = p[0][t];
#pragma unroll
      for (int s = 1; s < SUBS; ++s) a[t] += p[s][t];
    }
    sums[row0 + row] = a[0];
    sq[row0 + row] = a[1];
    cross[row0 + row] = a[2];
  }
}

// One launch over `lanes` lanes of m rows (rows: each lane's count, NULL:
// m for every lane) in row tile `shape`.
int launch(const float* x, const float* y, const float* dnear, const float* w,
           const float* lg, float* sums, float* sq, float* cross, int64_t m,
           int64_t b, int d, int metric, const int* run, const int* rows,
           int lanes, int shape, void* stream) {
  return rt::with_row_tile(shape, [&](auto tile) -> int {
    using W = decltype(tile);
    if (m <= 0 || lanes <= 0) return cudaSuccess;
    if (lanes > 65535) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)((m + W::BM - 1) / W::BM), (unsigned)lanes);
    // Lane bases are whole rows apart, so every lane shares lane 0's
    // alignment when d % 4 == 0.
    const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)y % 16 == 0;
    cudaStream_t st = (cudaStream_t)stream;
    RT_METRIC_SWITCH(metric, M, {
      const cudaError_t e = cudaFuncSetAttribute(
          build_g_kernel<M, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)W::SMEM);
      if (e != cudaSuccess) return e;
      build_g_kernel<M, W><<<grid, W::NT, W::SMEM, st>>>(
          x, y, dnear, w, lg, sums, sq, cross, m, b, d, vec, run, rows, m);
    });
    return cudaGetLastError();
  });
}

}  // namespace

// The _tiled entries take the row tile the caller resolved (the tile
// tuner, through ops.py; dist_mainloop.cuh's with_row_tile);
// rt_build_g and rt_build_g_lanes keep the wide tile.
extern "C" int rt_build_g_tiled(const float* x, const float* y,
                                const float* dnear, const float* w,
                                const float* lg, float* sums, float* sq,
                                float* cross, int64_t m, int64_t b, int d,
                                int metric, const int* run, int shape,
                                void* stream) {
  return launch(x, y, dnear, w, lg, sums, sq, cross, m, b, d, metric, run,
                nullptr, 1, shape, stream);
}

extern "C" int rt_build_g(const float* x, const float* y, const float* dnear,
                          const float* w, const float* lg, float* sums,
                          float* sq, float* cross, int64_t m, int64_t b, int d,
                          int metric, const int* run, void* stream) {
  return rt_build_g_tiled(x, y, dnear, w, lg, sums, sq, cross, m, b, d,
                          metric, run, 0, stream);
}

// The lane axis: x [lanes, n_pad, d], y [lanes, b, d], dnear / w / lg
// [lanes, b], outputs [lanes, n_pad]; run and rows [lanes] (NULL: every
// lane runs, over all n_pad rows).
extern "C" int rt_build_g_lanes_tiled(const float* x, const float* y,
                                      const float* dnear, const float* w,
                                      const float* lg, float* sums, float* sq,
                                      float* cross, int64_t lanes,
                                      int64_t n_pad, int64_t b, int d,
                                      int metric, const int* rows,
                                      const int* run, int shape,
                                      void* stream) {
  return launch(x, y, dnear, w, lg, sums, sq, cross, n_pad, b, d, metric, run,
                rows, (int)lanes, shape, stream);
}

extern "C" int rt_build_g_lanes(const float* x, const float* y,
                                const float* dnear, const float* w,
                                const float* lg, float* sums, float* sq,
                                float* cross, int64_t lanes, int64_t n_pad,
                                int64_t b, int d, int metric, const int* rows,
                                const int* run, void* stream) {
  return rt_build_g_lanes_tiled(x, y, dnear, w, lg, sums, sq, cross, lanes,
                                n_pad, b, d, metric, rows, run, 0, stream);
}

// Row tile `shape`'s rows, columns, threads and blocks an SM (l2) into
// info[0..3], for the tuner's wave model.
extern "C" int rt_build_g_shape(int shape, int k, int* info) {
  (void)k;
  return rt::with_row_tile(shape, [&](auto tile) -> int {
    using W = decltype(tile);
    int per_sm = 0;
    const cudaError_t e = rt::blocks_per_sm(build_g_kernel<rt::L2, W>, W::NT,
                                            W::SMEM, &per_sm);
    if (e != cudaSuccess) return e;
    return rt::shape_info<W>(info, per_sm);
  });
}
