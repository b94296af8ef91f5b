// The arithmetic every distance kernel of the port shares (sm_90a,
// float32): the metric ids, one feature step of a dot product, an
// abs-sum or a squared norm, the epilogue that turns them into a
// dissimilarity, and one column of the BUILD statistics.
//
// The bit contract.  The one distance routine, the pipelined mainloop
// (dist_mainloop.cuh), calls these helpers and nothing else for its
// arithmetic, in every tile shape, so a (row, column) pair gets the same
// bits from every kernel:
//   l2, l2sq, cosine: the dot product is one fmaf chain over features
//     0, 1, ..., d-1 from 0; each row norm is the same chain of squares;
//   l1: one chain of += |a - b| in feature order;
//   zero-padded features and edges add exact zeros (no chain is ever -0);
//   the epilogue is the JAX clamp: max((xx + yy) - 2 dot, 0), then sqrt
//   for l2; 1 - dot rsqrt(max(xx, 1e-30)) rsqrt(max(yy, 1e-30)) for cosine.
// In a distance, every product that meets an add has its rounding
// spelled out (fmaf, __fmul_rn, __fmaf_rn): nvcc fused the cosine epilogue's product and
// subtraction at some unrolled call sites and not at others (two of
// top2's tiles), which gave one pair two sets of bits.  The fused forms
// here are the ones every kernel computed before.  The l2 epilogue needs
// none (2 v is exact), and written as fmaf it cost pairwise's wide tile
// 14 registers, spills and 2 % of its time.  No split of the feature
// sum, no reassociation, no tensor cores: the accept rule's float32
// margins rest on these bits.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

enum Metric : int { L2 = 0, L2SQ = 1, COSINE = 2, L1 = 3 };

// Feature step of the pair (a from the x row, b from the y row).
template <int M>
__device__ __forceinline__ float dist_step(float acc, float a, float b) {
  if (M == L1) return acc + fabsf(a - b);
  return fmaf(a, b, acc);
}

// Feature step of a row's squared norm.
__device__ __forceinline__ float norm_step(float nrm, float v) {
  return fmaf(v, v, nrm);
}

// The dissimilarity from a finished chain and the two rows' norms (xx of
// the x row, yy of the y row; unused for l1).
template <int M>
__device__ __forceinline__ float dist_epilogue(float acc, float xx, float yy) {
  float v = acc;
  if (M == L2 || M == L2SQ) {
    // 2 v is exact, so fused or not this is round((xx + yy) - 2 v).
    v = fmaxf((xx + yy) - 2.f * v, 0.f);
    if (M == L2) v = sqrtf(v);
  } else if (M == COSINE) {
    v = __fmaf_rn(-__fmul_rn(v, rsqrtf(fmaxf(xx, 1e-30f))),
                  rsqrtf(fmaxf(yy, 1e-30f)), 1.f);
  }
  return v;
}

// One reference column of the BUILD statistics (paper Eq. 6), shared by
// build_g.cu and stream_stats.cu so equal distances fold to equal bits:
//   g = (isinf(dnear) ? dv : min(dv - dnear, 0)) * w
//   ps += g,  pq += g^2,  pc += g * lg
__device__ __forceinline__ void build_g_term(float dv, float dn, float w,
                                             float lg, float& ps, float& pq,
                                             float& pc) {
  float g = isinf(dn) ? dv : fminf(dv - dn, 0.f);
  g = g * w;
  ps += g;
  pq += g * g;
  pc += g * lg;
}

// Dispatch a kernel template on the runtime metric id.
#define RT_METRIC_SWITCH(metric, M, ...)      \
  switch (metric) {                           \
    case rt::L2: {                            \
      constexpr int M = rt::L2;               \
      __VA_ARGS__;                            \
    } break;                                  \
    case rt::L2SQ: {                          \
      constexpr int M = rt::L2SQ;             \
      __VA_ARGS__;                            \
    } break;                                  \
    case rt::COSINE: {                        \
      constexpr int M = rt::COSINE;           \
      __VA_ARGS__;                            \
    } break;                                  \
    case rt::L1: {                            \
      constexpr int M = rt::L1;               \
      __VA_ARGS__;                            \
    } break;                                  \
    default:                                  \
      return cudaErrorInvalidValue;           \
  }

}  // namespace rt
