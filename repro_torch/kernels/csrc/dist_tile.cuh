// Shared distance tile of the SWAP and top-2 kernels (sm_90a, float32).
//
// Replaces the TPU device function src/repro/kernels/pairwise.py:34
// (dist_tile): a [TM, TN] block of dissimilarities between TM rows of x
// and TN rows of y, both row-major with d features.
//
// Design: features are staged through shared memory in DK-wide chunks,
// transposed so that the compute loop reads consecutive addresses across
// a warp.  Each thread keeps a 4x4 register micro-tile with a strided
// layout (rows ty + i*TM/4, columns tx + j*TN/4), so a warp's shared reads
// are conflict-free or broadcasts.  l2/l2sq/cosine accumulate the dot
// product plus both row norms; l1 accumulates |x - y|.  Rows, columns and
// features beyond the edges are staged as zeros, which leaves every dot,
// norm and abs-sum unchanged; the caller masks the ragged rows/columns.
// No TF32 and no tensor cores: plain float32 FMAs, the JAX clamps
// (max(., 0) before sqrt, rsqrt(max(|.|^2, 1e-30)) for cosine).
//
// The tile lands in shared memory (dt[TM][TN + 1]) so each caller runs
// its own reduction over it in a fixed order.  Its arithmetic is the
// helpers of dist_math.cuh, which the pipelined mainloop
// (dist_mainloop.cuh) calls too: both give a (row, column) pair the same
// bits.  Only top2 (stream_g.cu) still runs on this tile; every other
// distance kernel runs on the mainloop.
#pragma once

#include "dist_math.cuh"

namespace rt {

constexpr int DK = 16;  // feature chunk staged per step

template <int TM, int TN>
struct TileSmem {
  float xs[DK][TM + 1];
  float ys[DK][TN + 1];
  float xx[TM];
  float yy[TN];
  float dt[TM][TN + 1];
};

// Fill s.dt with d(x[row0 + i], y[col0 + j]) for i < TM, j < TN.  All
// NT = (TM/4)*(TN/4) threads of the block must call it.  Ends synchronised.
template <int M, int TM, int TN>
__device__ __forceinline__ void dist_tile(const float* __restrict__ x,
                                          const float* __restrict__ y,
                                          int64_t m, int64_t r, int d,
                                          int64_t row0, int64_t col0,
                                          TileSmem<TM, TN>& s) {
  constexpr int TX = TN / 4;
  constexpr int NT = (TM / 4) * TX;
  constexpr int NRM = (TM + TN + NT - 1) / NT;  // norm rows per thread
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float nrm[NRM];
#pragma unroll
  for (int q = 0; q < NRM; ++q) nrm[q] = 0.f;

  for (int k0 = 0; k0 < d; k0 += DK) {
    // Stage x[row0:row0+TM, k0:k0+DK] and y[...] transposed, zero-filled.
    for (int e = tid; e < TM * DK; e += NT) {
      const int i = e / DK, c = e % DK;
      const int64_t gr = row0 + i;
      const int gc = k0 + c;
      s.xs[c][i] = (gr < m && gc < d) ? x[gr * d + gc] : 0.f;
    }
    for (int e = tid; e < TN * DK; e += NT) {
      const int j = e / DK, c = e % DK;
      const int64_t gr = col0 + j;
      const int gc = k0 + c;
      s.ys[c][j] = (gr < r && gc < d) ? y[gr * d + gc] : 0.f;
    }
    __syncthreads();
    if (M != L1) {
#pragma unroll
      for (int q = 0; q < NRM; ++q) {
        const int t = tid + q * NT;
        if (t < TM) {
#pragma unroll
          for (int c = 0; c < DK; ++c) nrm[q] = norm_step(nrm[q], s.xs[c][t]);
        } else if (t < TM + TN) {
#pragma unroll
          for (int c = 0; c < DK; ++c)
            nrm[q] = norm_step(nrm[q], s.ys[c][t - TM]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < DK; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s.xs[c][ty + i * (TM / 4)];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s.ys[c][tx + j * TX];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = dist_step<M>(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  if (M != L1) {
#pragma unroll
    for (int q = 0; q < NRM; ++q) {
      const int t = tid + q * NT;
      if (t < TM)
        s.xx[t] = nrm[q];
      else if (t < TM + TN)
        s.yy[t - TM] = nrm[q];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int li = ty + i * (TM / 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lj = tx + j * TX;
      s.dt[li][lj] = dist_epilogue<M>(acc[i][j], s.xx[li], s.yy[lj]);
    }
  }
  __syncthreads();
}

}  // namespace rt
