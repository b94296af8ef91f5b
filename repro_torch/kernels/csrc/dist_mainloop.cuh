// Pipelined, register-blocked distance mainloop for Hopper (sm_90a,
// float32), the distance work of every distance kernel of the port:
// pairwise.cu, build_g.cu, swap_g.cu (swap_g and stream_swap_g),
// stream_stats.cu (stream_build_g) and stream_g.cu (top2).
//
// Replaces, for those kernels, the TPU device function
// src/repro/kernels/pairwise.py:34 (dist_tile).  Every chain, norm and
// epilogue is a helper of dist_math.cuh, run in the contract's order
// (see there), so a (row, column) pair gets the same float32 bits in
// every kernel and at every tile shape.  No split of the feature sum,
// no atomics, no tensor cores.
//
// What bounds it: 2*BM*BN*d FMA flops per tile against the card's
// float32 rate (67 TFLOP/s); the operands are read once per tile.  At
// the main path's [60,000 x 100 x 784] that is 9.4 GFLOP against 188 MB
// of x: compute-bound, 0.14 ms.  What the design does about it:
//
// * Register blocking.  A block owns a [BM, BN] tile of pairs; thread
//   (ty, tx) owns an RM x RN micro-tile, rows ty + TY*i and columns
//   tx + TX*j.  Both operands stay K-contiguous in shared memory
//   ([row][LD] per stage), so a thread reads 4 consecutive features of a
//   row as one float4 and runs 4 sequential steps: each chain keeps its
//   feature order and no transpose is needed while staging.  An 8 x 13
//   micro-tile does 416 FMAs per 21 float4 loads.  LD = BK + 4 with
//   LD / 4 odd puts 8 consecutive rows' float4s in distinct bank groups.
// * An asynchronous feature pipeline.  Features pass in BK-wide chunks
//   through a ring of STAGES shared-memory stages filled by cp.async
//   (16-byte copies when d % 4 == 0 and both bases are 16-byte aligned,
//   4-byte copies otherwise; rows and features past the edges are
//   zero-filled without a read, which adds exact zeros to every chain).
//   The copies of the next STAGES - 1 chunks are in flight while the
//   current one is computed, and a chunk costs one barrier.
// * Norms on the way.  Thread t runs the norm chains of staged rows t,
//   t + NT, ... over each chunk as it passes (one float4 at a time), so
//   no half of the block waits for the other.
//
// The finished chains stay in registers (dist_finish makes them
// dissimilarities); the caller stores or folds them.
#pragma once

#include "dist_math.cuh"

namespace rt {

// A block shape: TY x TX threads, RM x RN pairs each, BK features per
// stage, STAGES stages, MINB blocks per SM for __launch_bounds__.
template <int TY_, int TX_, int RM_, int RN_, int BK_, int STAGES_, int MINB_>
struct Mainloop {
  static constexpr int TY = TY_, TX = TX_, RM = RM_, RN = RN_;
  static constexpr int BK = BK_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int BM = TY * RM, BN = TX * RN, NT = TY * TX;
  static constexpr int LD = BK + 4;                // floats per staged row
  static constexpr int ROWS = BM + BN;             // staged rows per chunk
  static constexpr int STAGE = ROWS * LD;          // floats per stage
  static constexpr int NORMS = STAGES * STAGE;     // norms [ROWS] after them
  static constexpr size_t SMEM = (size_t)(NORMS + ROWS) * sizeof(float);
  static_assert(BK % 8 == 0, "LD / 4 odd: conflict-free float4 reads");
  static_assert(STAGES >= 2, "a ring");
  static constexpr int NRM = (ROWS + NT - 1) / NT;  // norm chains a thread
  // The calling thread's place in the micro-tile grid.
  __device__ static int tx() { return threadIdx.x % TX; }
  __device__ static int ty() { return threadIdx.x / TX; }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of features [k0, k0 + BK) of rows a0.. of a [ma, d]
// (staged rows 0..BM-1) and b0.. of b [mb, d] (staged rows BM..) into
// one stage.  All NT threads call it.  With 16-byte copies thread t
// copies float4 t % V of rows t / V, t / V + NT / V, ... of each side,
// so its addresses advance by a fixed stride.
template <class C>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            int64_t ma, int64_t mb, int d,
                                            int64_t a0, int64_t b0, int k0,
                                            bool vec, float* st) {
  if (vec) {
    constexpr int V = C::BK / 4, RP = C::NT / V;  // rows per pass
    static_assert(C::NT % V == 0, "whole rows per pass");
    const int c = (threadIdx.x % V) * 4, r0 = threadIdx.x / V;
    const bool kin = k0 + c < d;
#pragma unroll
    for (int q = 0; q < (C::BM + RP - 1) / RP; ++q) {
      const int rr = r0 + q * RP;
      if (C::BM % RP != 0 && rr >= C::BM) break;
      const bool ok = kin && a0 + rr < ma;
      cp_async16(st + rr * C::LD + c, ok ? a + (a0 + rr) * d + k0 + c : a,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int q = 0; q < (C::BN + RP - 1) / RP; ++q) {
      const int rr = r0 + q * RP;
      if (C::BN % RP != 0 && rr >= C::BN) break;
      const bool ok = kin && b0 + rr < mb;
      cp_async16(st + (C::BM + rr) * C::LD + c,
                 ok ? b + (b0 + rr) * d + k0 + c : b, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < C::ROWS * C::BK; e += C::NT) {
      const int rr = e / C::BK, c = e % C::BK;
      const bool on_a = rr < C::BM;
      const int64_t g = on_a ? a0 + rr : b0 + (rr - C::BM);
      const float* base = on_a ? a : b;
      const bool ok = g < (on_a ? ma : mb) && k0 + c < d;
      cp_async4(st + rr * C::LD + c, ok ? base + g * d + k0 + c : base,
                ok ? 4 : 0);
    }
  }
}

// Run the chains of the block's pairs: rows a0 + ty + TY*i of a [ma, d]
// against rows b0 + tx + TX*j of b [mb, d].  acc gets the raw dot
// products (abs-sums for l1); the norms of the staged rows land in
// smem[NORMS:], a's first (not for l1).  All NT threads call it; it ends
// synchronised with the stages free for the caller.
template <int M, class C>
__device__ __forceinline__ void dist_mainloop(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              int64_t ma, int64_t mb, int d,
                                              int64_t a0, int64_t b0, bool vec,
                                              float* smem,
                                              float (&acc)[C::RM][C::RN]) {
  const int tid = threadIdx.x;
  const int tx = C::tx(), ty = C::ty();
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RN; ++j) acc[i][j] = 0.f;
  float nrm[C::NRM];
#pragma unroll
  for (int q = 0; q < C::NRM; ++q) nrm[q] = 0.f;
  const int nk = (d + C::BK - 1) / C::BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk)
      stage_chunk<C>(a, b, ma, mb, d, a0, b0, s * C::BK, vec,
                     smem + s * C::STAGE);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    // Chunk c has landed for every thread, and every thread is done with
    // chunk c - 1, whose stage the next copies overwrite.
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    const int nx = c + C::STAGES - 1;
    if (nx < nk)
      stage_chunk<C>(a, b, ma, mb, d, a0, b0, nx * C::BK, vec,
                     smem + (nx % C::STAGES) * C::STAGE);
    cp_async_commit();
    const float* st = smem + (c % C::STAGES) * C::STAGE;
#pragma unroll
    for (int q = 0; q < C::NRM; ++q) {
      const int t = tid + q * C::NT;
      if (M == L1 || (C::ROWS % C::NT != 0 && t >= C::ROWS)) break;
      const float* p = st + t * C::LD;
#pragma unroll
      for (int kk = 0; kk < C::BK; kk += 4) {
        const float4 v = *reinterpret_cast<const float4*>(p + kk);
        nrm[q] = norm_step(nrm[q], v.x);
        nrm[q] = norm_step(nrm[q], v.y);
        nrm[q] = norm_step(nrm[q], v.z);
        nrm[q] = norm_step(nrm[q], v.w);
      }
    }
    const float* as = st + ty * C::LD;
    const float* bs = st + (C::BM + tx) * C::LD;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 4) {
      float4 av[C::RM];
#pragma unroll
      for (int i = 0; i < C::RM; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + i * C::TY * C::LD + kk);
#pragma unroll
      for (int j = 0; j < C::RN; ++j) {
        const float4 bv =
            *reinterpret_cast<const float4*>(bs + j * C::TX * C::LD + kk);
#pragma unroll
        for (int i = 0; i < C::RM; ++i) {
          acc[i][j] = dist_step<M>(acc[i][j], av[i].x, bv.x);
          acc[i][j] = dist_step<M>(acc[i][j], av[i].y, bv.y);
          acc[i][j] = dist_step<M>(acc[i][j], av[i].z, bv.z);
          acc[i][j] = dist_step<M>(acc[i][j], av[i].w, bv.w);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int q = 0; q < C::NRM; ++q) {
    const int t = tid + q * C::NT;
    if (M != L1 && t < C::ROWS) smem[C::NORMS + t] = nrm[q];
  }
  __syncthreads();
}

// Turn the chains into dissimilarities in place.  SWAP_AB: the
// mainloop's a-side rows are y rows and its b-side rows x rows, so the
// norms go to the epilogue the other way round (the chains themselves are
// symmetric: fmaf(a, b, c) == fmaf(b, a, c), |a - b| == |b - a|).
template <int M, class C, bool SWAP_AB>
__device__ __forceinline__ void dist_finish(const float* smem,
                                            float (&acc)[C::RM][C::RN]) {
  const float* nr = smem + C::NORMS;
  const int tx = C::tx(), ty = C::ty();
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    const float na = nr[ty + C::TY * i];
#pragma unroll
    for (int j = 0; j < C::RN; ++j) {
      const float nb = nr[C::BM + tx + C::TX * j];
      acc[i][j] = SWAP_AB ? dist_epilogue<M>(acc[i][j], nb, na)
                          : dist_epilogue<M>(acc[i][j], na, nb);
    }
  }
}

// The shapes the kernels share, the candidates the tile tuner
// (repro_torch/core/tuning.py) picks among; every kernel file launches a
// shape by the index its _tiled entry is given.  Top2 adds 40- and
// 72-column ones of its own.
//
// Wide (pairwise, build_g, swap_g, stream_build_g, stream_swap_g, top2
// at some k past 80): 104 columns hold a whole B = 100 batch (4 %
// padding) and, being 0 mod 4, keep a column's residue mod 4 across
// column tiles, which the folds rely on; 8 x 13 pairs a thread need 21
// float4 loads per 416 FMAs (8 x 7: 15 per 224) and up to 255 registers,
// hence 128 threads and two blocks an SM; 16 features a stage, four
// stages.  Its row tiles: the statistics kernels and their folds vary
// only the row side (RM, so BM = 16 RM), never TX, RN or BN, which fix
// each row's column order; a tile of fewer rows gives a grid that leaves
// SMs idle (an 8,000-row round: 63 tiles of 128 rows on 132 SMs) more
// blocks.  They keep two blocks an SM: at three (168 registers) the
// folds spilled.
using WideTile = Mainloop<16, 8, 8, 13, 16, 4, 2>;  // 128 x 104
using Wide64 = Mainloop<16, 8, 4, 13, 16, 4, 2>;    // 64 x 104
using Wide32 = Mainloop<16, 8, 2, 13, 16, 4, 2>;    // 32 x 104
// pairwise's 128-column tiles (it writes each pair on its own, so its
// column tile may vary), so a [n x 128] block (a sharded round's) is one
// column tile, not two of 104.  At 128 rows, 16 x 16 threads of 8 x 8
// pairs (16 float4 loads per 256 FMAs, 254 registers, one block an SM):
// the wide tile's threads with 8 x 16 pairs ran 3 % faster but spilled
// 108 bytes at 255 registers.  At 64 and 32 rows the wide tile's threads
// with 16 pairs across, three blocks an SM, no spill.
using Col128 = Mainloop<16, 16, 8, 8, 16, 4, 1>;     // 128 x 128
using Col128x64 = Mainloop<16, 8, 4, 16, 16, 4, 3>;  // 64 x 128
using Col128x32 = Mainloop<16, 8, 2, 16, 16, 4, 3>;  // 32 x 128
// Narrow (pairwise, top2): 16 columns or fewer (predict's and the
// default fit's k medoids, or the few x rows of a d_near or leader row
// with the operands swapped).
using NarrowTile = Mainloop<32, 4, 2, 4, 32, 4, 4>;

// Call f with the row tile of shape index `shape` of the statistics
// kernels (build_g, swap_g, stream_build_g, stream_swap_g: 0 the wide
// tile, 1 Wide64, 2 Wide32), as f(Tile{}); an index the library was not
// built with returns cudaErrorInvalidValue, and no other shape is taken.
template <class F>
inline int with_row_tile(int shape, F&& f) {
  switch (shape) {
    case 0:
      return f(WideTile{});
    case 1:
      return f(Wide64{});
    case 2:
      return f(Wide32{});
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks of `kernel` an SM holds at `threads` threads and `smem` bytes
// of dynamic shared memory (the attribute set first, as a launch does).
template <class K>
inline cudaError_t blocks_per_sm(K kernel, int threads, size_t smem,
                                 int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads,
                                                       smem);
}

// A shape query's answer: rows, columns, threads and blocks an SM.
template <class C>
inline cudaError_t shape_info(int* info, int per_sm) {
  info[0] = C::BM;
  info[1] = C::BN;
  info[2] = C::NT;
  info[3] = per_sm;
  return cudaSuccess;
}

}  // namespace rt
