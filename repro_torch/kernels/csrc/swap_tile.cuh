// The SWAP (FastPAM1, paper Eq. 12) column routine and fold, shared by
// every SWAP kernel of the port (swap_g.cu's swap_g / stream_swap_g and
// swap_g_from_cache.cu), so a block of distances gives the same bits
// whichever kernel reduced it.  Counterpart of the JAX package's
// swap_stats_vals (src/repro/kernels/swap_g.py:40), shared by its fresh,
// cached and streaming kernels alike.
//
// Layout: a fold of R rows has SUBS = 4 owners per row, one per residue
// of the column index mod 4; owner (row, sub) adds its residue's columns
// in increasing order.  It keeps its base terms in three register
// partials and its cluster terms in its own bins mine[3][kc][R] (at
// column `row`), so no two threads write one address.  A kernel may hold
// the bins of a chunk of kc clusters at a time and walk its columns once
// per chunk (the cluster id shifted by the chunk's first, so other
// chunks' columns add to no bin): every bin still gets its adds in
// column order.  Both kernels fold 32 rows at a time, a warp per
// residue, and end with swap_fold_ld (bin stride ld = R).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Add a reference column's terms, given its distance dv to this row,
// its weight wj != 0, d1, d2, leader value lj and cluster c:
//   base = (min(dv, d1) - d1) * w,  corr = min(dv, d2) - min(dv, d1)
//   partials += base, base^2, base * lg
//   bins[c]  += corr * w, (2 base corr + corr^2) * w, corr * lg * w
__device__ __forceinline__ void swap_col_vals(float dv, float wj, float a1,
                                              float a2, float lj, int c,
                                              int k, int ld, int row,
                                              float* mine, float& bs,
                                              float& bq, float& bc) {
  const float m1 = fminf(dv, a1);
  const float base = (m1 - a1) * wj;
  const float corr = fminf(dv, a2) - m1;
  bs += base;
  bq += base * base;
  bc += base * lj;
  if (c >= 0 && c < k) {
    mine[(0 * k + c) * ld + row] += corr * wj;
    mine[(1 * k + c) * ld + row] += (2.f * base * corr + corr * corr) * wj;
    mine[(2 * k + c) * ld + row] += (corr * lj) * wj;
  }
}

// Statistic q (0 sums, 1 sq, 2 cross) of arm (medoid c, row i): the SUBS
// owners' base partials red[q][t][i] plus their bins for c, added in
// owner order.  red is [3][SUBS][ld], bins [SUBS][3][k][ld].
template <int SUBS>
__device__ __forceinline__ float swap_fold_ld(const float* red,
                                              const float* bins, int k,
                                              int ld, int q, int c, int i) {
  float base = red[(q * SUBS) * ld + i];
  float bin = bins[(q * k + c) * ld + i];
#pragma unroll
  for (int t = 1; t < SUBS; ++t) {
    base += red[(q * SUBS + t) * ld + i];
    bin += bins[(((size_t)t * 3 + q) * k + c) * ld + i];
  }
  return base + bin;
}

}  // namespace rt
