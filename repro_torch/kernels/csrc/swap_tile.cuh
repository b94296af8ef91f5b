// The SWAP (FastPAM1, paper Eq. 12) statistics of a [TM, TN] distance
// tile, shared by every SWAP kernel of the port (swap_g.cu's two kernels
// and stream_stats.cu's stream_swap_g), so a block of distances gives
// the same bits whichever kernel reduced it.  Counterpart of the JAX
// package's swap_stats_vals (src/repro/kernels/swap_g.py:40), shared by
// its fresh, cached and streaming kernels alike.
//
// Layout: NT threads per block, TM rows; thread t owns row t % TM and
// every SUBS-th column of a tile from t / TM on.  It keeps its base terms
// in three register partials and its cluster terms in its own bins
// mine[3][k][TM] (at column `row`), so no two threads write one address.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Add reference column jj's terms, given its distance dv to this row:
//   base = (min(dv, d1) - d1) * w,  corr = min(dv, d2) - min(dv, d1)
//   partials += base, base^2, base * lg
//   bins[c]  += corr * w, (2 base corr + corr^2) * w, corr * lg * w
// with c = assign[jj].  Every term carries the factor w, so a weight-0
// column adds only zeros: it is skipped before its vectors are read.
template <int TM>
__device__ __forceinline__ void swap_col(
    float dv, int64_t jj, const float* __restrict__ d1,
    const float* __restrict__ d2, const int* __restrict__ assign,
    const float* __restrict__ w, const float* __restrict__ lg, int k,
    int row, float* mine, float& bs, float& bq, float& bc) {
  const float wj = w[jj];
  if (wj == 0.f) return;
  const float a1 = d1[jj], a2 = d2[jj], lj = lg[jj];
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

// Statistic q (0 sums, 1 sq, 2 cross) of arm (medoid c, row i): the SUBS
// threads' base partials red[q][t][i] plus their bins for c, added in
// thread order.
template <int TM, int SUBS>
__device__ __forceinline__ float swap_fold_at(const float (&red)[3][SUBS][TM],
                                              const float* bins, int k, int q,
                                              int c, int i) {
  float base = red[q][0][i];
  float bin = bins[(q * k + c) * TM + i];
#pragma unroll
  for (int t = 1; t < SUBS; ++t) {
    base += red[q][t][i];
    bin += bins[(((size_t)t * 3 + q) * k + c) * TM + i];
  }
  return base + bin;
}

}  // namespace rt
