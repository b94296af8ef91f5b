// Streaming BUILD arm statistics over the WHOLE reference set, float32.
//
// Replaces the TPU kernel src/repro/kernels/stream_g.py:65
// (stream_build_g_kernel); its SWAP twin, stream_swap_g (:115), is
// swap_g.cu's kernel walked in 512-column reference tiles.  It computes
// build_g.cu's statistics for every candidate row x of [m, d] against a
// reference set y [r, d] of any size (r = n for the exact passes: the
// replacement-sampling fallback and every step of PAM):
//   g_j = (isinf(dnear_j) ? d : min(d - dnear_j, 0)) * w_j
//   sums = sum_j g_j, sq = sum_j g_j^2, cross = sum_j g_j lg_j     [m]
// Only these outputs reach device memory: no [m, r] or [m, 512] block.
//
// Accumulation order (the TPU kernels' contract): the reference set is
// walked in REF_TILE = 512-column tiles, the engine's _EXACT_CHUNK; each
// tile's statistics are summed on their own (four partials per row, one
// per column residue mod 4, added in a fixed order), and the tile sums
// are added to the running totals in walk order.  A 60,000-term sum is
// thus 118 sums of 512 terms, whose float32 error stays near the
// reference's.
// No atomics: the same bits on every run.
//
// Bound on the H100: 2*m*r*d flops of distance work (5.6 TFLOP at
// m = r = 60000, d = 784) against 67 TFLOP/s float32 without tensor cores
// (84 ms), while x and y are read once (376 MB, 0.11 ms): compute-bound.
//
// Design: build_g.cu with the reference walk as an outer loop.  One
// block per row tile of x (128 rows, or 64 or 32 at the tile tuner's
// pick) runs the pipelined, register-blocked mainloop of
// dist_mainloop.cuh (the pairs' bits are dist_math.cuh's) over each
// 512-column reference tile in 104-column tiles;
// the fifth is clipped to the tile's last 96 columns (rows of y past the
// reference tile are zero-filled, not read), so no column tile straddles
// two reference tiles.  The finished [BM, 104] tile goes to shared
// memory over the stages and one thread per row folds it: four register
// partials, one per residue of the column index mod 4 (104 = 512 = 0
// mod 4, so a column's residue is its global one), each over its columns
// in increasing order, reset at every reference tile and added 0 + 1 +
// 2 + 3 at its end; the tile sum goes to running totals that start at 0,
// in walk order, kept in shared memory beside the stages.  At r <= 512
// that is build_g's fold, so the two kernels' sums are equal bit for bit.
//
// The run flag.  `run` (NULL: run) is the device-resident search's exact
// fallback flag (more than one survivor at the budget's end): where it
// reads 0 every block returns before its first load, so a search that
// resolves without the pass costs a launch, and the outputs are unwritten
// (the caller discards them).  A flag of 1 gives the bits of NULL.
#include <stdint.h>

#include "dist_mainloop.cuh"

namespace {

constexpr int64_t REF_TILE = 512;

__device__ __forceinline__ int64_t tile_end(int64_t t0, int64_t r) {
  return t0 + REF_TILE < r ? t0 + REF_TILE : r;
}

constexpr int SUBS_B = 4;  // BUILD partials per row: residues mod 4

// Dynamic shared memory: the mainloop's, then the running totals [3][BM].
template <class W>
constexpr size_t build_smem() {
  return W::SMEM + 3 * W::BM * sizeof(float);
}

// W: the row tile (dist_mainloop.cuh's with_row_tile); BN = 104 and TX,
// RN fix each row's column order, so every row tile gives the same bits.
// Thread t < BM folds row t.
template <int M, class W>
__global__ void __launch_bounds__(W::NT, W::MINB)
stream_build_g_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ dnear,
                      const float* __restrict__ w, const float* __restrict__ lg,
                      float* __restrict__ sums, float* __restrict__ sq,
                      float* __restrict__ cross, int64_t m, int64_t r, int d,
                      bool vec, const int* __restrict__ run) {
  constexpr int DT_LD = W::BN + 1;  // the distance tile's row stride
  static_assert(W::BN % SUBS_B == 0 && REF_TILE % SUBS_B == 0,
                "a column's residue in its tile is its global one");
  static_assert(W::NT >= W::BM, "one thread folds each row");
  static_assert(W::BM * DT_LD <= W::NORMS, "the tile fits in the stages");
  if (run != nullptr && *run == 0) return;  // no fallback: nothing to do
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* dt = smem;  // [BM][DT_LD] over the stages, after each mainloop
  const int64_t row0 = (int64_t)blockIdx.x * W::BM;
  const int tx = W::tx(), ty = W::ty();
  const int row = threadIdx.x;
  const bool folds = row < W::BM;
  // This row's running totals; only its own thread touches them.
  float* tot = smem + W::NORMS + W::ROWS + (folds ? row : 0);
  if (folds) {
#pragma unroll
    for (int t = 0; t < 3; ++t) tot[t * W::BM] = 0.f;
  }
  for (int64_t t0 = 0; t0 < r; t0 += REF_TILE) {
    const int64_t t1 = tile_end(t0, r);
    float p[SUBS_B][3];  // (sums, sq, cross) partials of each residue
#pragma unroll
    for (int s = 0; s < SUBS_B; ++s) p[s][0] = p[s][1] = p[s][2] = 0.f;
    for (int64_t col0 = t0; col0 < t1; col0 += W::BN) {
      float acc[W::RM][W::RN];
      rt::dist_mainloop<M, W>(x, y, m, t1, d, row0, col0, vec, smem, acc);
      rt::dist_finish<M, W, false>(smem, acc);
#pragma unroll
      for (int i = 0; i < W::RM; ++i)
#pragma unroll
        for (int j = 0; j < W::RN; ++j)
          dt[(ty + W::TY * i) * DT_LD + tx + W::TX * j] = acc[i][j];
      __syncthreads();
      const int nc = t1 - col0 < W::BN ? (int)(t1 - col0) : W::BN;
      if (folds) {
#pragma unroll
        for (int s = 0; s < SUBS_B; ++s)
          for (int j = s; j < nc; j += SUBS_B)
            rt::build_g_term(dt[row * DT_LD + j], dnear[col0 + j],
                             w[col0 + j], lg[col0 + j], p[s][0], p[s][1],
                             p[s][2]);
      }
      __syncthreads();  // the next column tile stages over dt
    }
    if (folds) {
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        float a = p[0][t];
#pragma unroll
        for (int s = 1; s < SUBS_B; ++s) a += p[s][t];
        tot[t * W::BM] += a;
      }
    }
  }
  if (folds && row0 + row < m) {
    sums[row0 + row] = tot[0];
    sq[row0 + row] = tot[W::BM];
    cross[row0 + row] = tot[2 * W::BM];
  }
}

}  // namespace

// The _tiled entry takes the row tile the caller resolved (the tile
// tuner, through ops.py; dist_mainloop.cuh's with_row_tile);
// rt_stream_build_g keeps the wide tile.
extern "C" int rt_stream_build_g_tiled(const float* x, const float* y,
                                       const float* dnear, const float* w,
                                       const float* lg, float* sums,
                                       float* sq, float* cross, int64_t m,
                                       int64_t r, int d, int metric,
                                       const int* run, int shape,
                                       void* stream) {
  return rt::with_row_tile(shape, [&](auto tile) -> int {
    using W = decltype(tile);
    if (r < 1) return cudaErrorInvalidValue;
    if (m <= 0) return cudaSuccess;
    const unsigned grid = (unsigned)((m + W::BM - 1) / W::BM);
    const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)y % 16 == 0;
    cudaStream_t st = (cudaStream_t)stream;
    const size_t smem = build_smem<W>();
    RT_METRIC_SWITCH(metric, M, {
      const cudaError_t e = cudaFuncSetAttribute(
          stream_build_g_kernel<M, W>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      stream_build_g_kernel<M, W><<<grid, W::NT, smem, st>>>(
          x, y, dnear, w, lg, sums, sq, cross, m, r, d, vec, run);
    });
    return cudaGetLastError();
  });
}

extern "C" int rt_stream_build_g(const float* x, const float* y,
                                 const float* dnear, const float* w,
                                 const float* lg, float* sums, float* sq,
                                 float* cross, int64_t m, int64_t r, int d,
                                 int metric, const int* run, void* stream) {
  return rt_stream_build_g_tiled(x, y, dnear, w, lg, sums, sq, cross, m, r, d,
                                 metric, run, 0, stream);
}

// Row tile `shape`'s rows, columns, threads and blocks an SM (l2) into
// info[0..3], for the tuner's wave model.
extern "C" int rt_stream_build_g_shape(int shape, int k, int* info) {
  (void)k;
  return rt::with_row_tile(shape, [&](auto tile) -> int {
    using W = decltype(tile);
    int per_sm = 0;
    const cudaError_t e = rt::blocks_per_sm(
        stream_build_g_kernel<rt::L2, W>, W::NT, build_smem<W>(), &per_sm);
    if (e != cudaSuccess) return e;
    return rt::shape_info<W>(info, per_sm);
  });
}
