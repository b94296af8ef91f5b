// SWAP (FastPAM1, paper Eq. 12) arm statistics from a resident block of
// distances, float32.
//
// Replaces the TPU kernel src/repro/kernels/swap_g.py:118
// (swap_g_from_cache_kernel, body _kernel_cached :76): swap_g.cu's
// statistics, read from an [m, B] block of the PIC column ring (row
// stride ld: a column slice of the ring, or the whole ring in the
// carried-moment repair) with no distance work.  It walks any B (the TPU
// wrapper's CACHE_B_MAX chunking is a VMEM limit the card does not have);
// all offsets are int64 (the full ring at n = 60,000 holds 3.6e9 floats).
//
// Bound on the H100: its bytes, the columns the weights need read once
// (m * 4 bytes a weighted column), plus 3*k*m*4 written: 24 MB for a
// round at m = 60,000, B = 100; for the repair, the weighted share of the
// ring (about 5 %) of the 14.4 GB a full read would take.
//
// Design.  Every term carries the factor w, so a weight-0 column adds
// nothing, and in the repair most weights are 0: the kernel reads only
// the weighted columns.  A block owns 32 rows; warp s is the owner of
// residue s (column index mod 4) for all of them, a lane per row, and
// works alone: it scans its residue's weights 256 columns at a time
// (eight loads a lane in flight, a ballot each) into a list of its
// weighted columns in increasing order, gathers their distances for the
// 32 rows and their w, d1, d2, lg and a into shared memory, 32 columns a
// batch, with cp.async, and folds a batch while the next one is in
// flight (two buffers).  The lane adds its columns in that order with
// swap_tile.cuh's column routine (base terms to three register partials,
// cluster terms to its bins [3][k] chosen by a_j) and the block ends
// with red0 + red1 + red2 + red3 + (bin0 + bin1 + bin2 + bin3)
// (swap_fold_ld): the order of swap_g.cu, so equal distances give
// swap_g's bits.  The bins of at most 32 clusters live in shared memory
// at once; for k > 32 the warp walks its list again per chunk of 32
// clusters, gathering only the chunk's columns (the base partials come
// from the first walk), so every bin gets the same adds in the same
// order at every k.  No atomics, no global scratch: 59,904 B of shared
// memory at k <= 10, at most 93,696 B.
//
// The run flag.  `run` (NULL: run) is the device-resident search's "still
// running" flag: where it reads 0 every block returns before its first
// load and the outputs are unwritten (the caller discards them).  Nothing
// else changes, so a flag of 1 gives the bits of NULL.
//
// The lane axis (rt_swap_g_from_cache_lanes, the PIC fit_batch).  L
// independent fits run as one launch: blockIdx.y is the lane, each lane
// with its own block of distances at dxy + l * lane_stride + col[l] (rows
// ld apart: a round's slot of the lane ring [L, n_pad, (W+1)*B], a
// recycled round's scratch columns, or the whole ring in the repair), its
// d1 / d2 / assign / w / lg [B], row count rows[l], run flag, and outputs
// [k, n_pad] at l * k * n_pad.  A block offsets its pointers to its lane
// and runs the single launch's body with m = rows[l]; blocks past it and
// every block of a lane whose flag reads 0 return at once.  Lane l thus
// gives the bits of rt_swap_g_from_cache on its own block;
// rt_swap_g_from_cache is the same kernel with one lane.  A per-lane
// column offset, not a staging copy, is how a recycled lane's block is
// read: one launch serves every lane with no copy.
#include <limits.h>
#include <stdint.h>

#include "dist_mainloop.cuh"
#include "swap_tile.cuh"

namespace {

constexpr int R = 32;              // rows a block: a lane each
constexpr int SUBS = 4;            // warps: one per residue mod 4
constexpr int NT = SUBS * 32;
constexpr int KC_MAX = 32;         // clusters whose bins are held at once
constexpr int SCAN = 8;            // weights a lane reads per scan
constexpr int LCAP = SCAN * 32;    // a warp's list: one scan's columns
constexpr int BATCH = 32;          // columns a gather brings
constexpr int DLD = BATCH + 1;     // the gathered tile's row stride
constexpr int BUF = R * DLD + 5 * BATCH;  // tile [R][DLD], w d1 d2 lg a
constexpr int WARP = 2 * BUF + LCAP;      // a warp's buffers and list

// Refill the warp's list once all of it is gathered: the columns
// j = s + 4q, q0 <= q < q0 + 256, with w_j != 0 (and, past the first
// cluster chunk, a_j in [c0, c0 + kcc)), in increasing order.
__device__ __forceinline__ void scan_columns(const float* __restrict__ w,
                                             const int* __restrict__ assign,
                                             int64_t nq, int s, int lane,
                                             int c0, int kcc, int64_t& q0,
                                             int* list, int& nl, int& pos) {
  while (pos == nl && q0 < nq) {
    __syncwarp();  // every lane has gathered from the list
    float wv[SCAN];
    int av[SCAN];
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      const int64_t q = q0 + lane + 32 * u;
      wv[u] = q < nq ? w[s + 4 * q] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SCAN; ++u)
      av[u] = c0 > 0 && wv[u] != 0.f ? assign[s + 4 * (q0 + lane + 32 * u)]
                                     : c0;
    nl = 0;
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      const bool take =
          wv[u] != 0.f && (unsigned)(av[u] - c0) < (unsigned)kcc;
      const unsigned mask = __ballot_sync(0xffffffffu, take);
      if (take)
        list[nl + __popc(mask & ((1u << lane) - 1u))] =
            (int)(s + 4 * (q0 + lane + 32 * u));
      nl += __popc(mask);
    }
    q0 += 32 * SCAN;
    pos = 0;
    __syncwarp();  // the list is visible to every lane
  }
}

// Start the copies of the next batch of listed columns into buf: lane p
// copies column list[pos + p]'s vectors and its distances for the 32
// rows (rows past m are zero-filled, not read).  Returns the batch's
// size, 0 when the list is spent; always commits one copy group.
__device__ __forceinline__ int gather_batch(
    const float* __restrict__ dxy, int64_t ld, int64_t m, int64_t row0,
    const float* __restrict__ d1, const float* __restrict__ d2,
    const int* __restrict__ assign, const float* __restrict__ w,
    const float* __restrict__ lg, const int* list, int nl, int& pos,
    int lane, float* buf) {
  const int cnt = nl - pos < BATCH ? nl - pos : BATCH;
  if (lane < cnt) {
    const int j = list[pos + lane];
    float* v = buf + R * DLD;
    rt::cp_async4(v + lane, w + j, 4);
    rt::cp_async4(v + BATCH + lane, d1 + j, 4);
    rt::cp_async4(v + 2 * BATCH + lane, d2 + j, 4);
    rt::cp_async4(v + 3 * BATCH + lane, lg + j, 4);
    rt::cp_async4(v + 4 * BATCH + lane,
                  reinterpret_cast<const float*>(assign + j), 4);
#pragma unroll 8
    for (int i = 0; i < R; ++i) {
      const bool ok = row0 + i < m;
      rt::cp_async4(buf + i * DLD + lane, ok ? dxy + (row0 + i) * ld + j : dxy,
                    ok ? 4 : 0);
    }
  }
  pos += cnt;
  rt::cp_async_commit();
  return cnt;
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
                         int k, const int* __restrict__ run,
                         int64_t lane_stride, const int64_t* __restrict__ col,
                         const int* __restrict__ rows) {
  // m is the padded row count: the outputs' stride between clusters.
  const int64_t ln = blockIdx.y, ldk = m;
  if (run != nullptr && run[ln] == 0) return;  // a masked round or lane
  if (rows != nullptr) m = rows[ln];
  const int64_t row0 = (int64_t)blockIdx.x * R;
  if (row0 >= m) return;  // past the lane's rows: the whole block
  dxy += ln * lane_stride + (col != nullptr ? col[ln] : 0);
  d1 += ln * b;
  d2 += ln * b;
  assign += ln * b;
  w += ln * b;
  lg += ln * b;
  sums += ln * k * ldk;
  sq += ln * k * ldk;
  cross += ln * k * ldk;
  extern __shared__ float4 smem4[];
  const int kc = k < KC_MAX ? k : KC_MAX;
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x % 32, s = threadIdx.x / 32;
  float* const bins = smem;                      // [SUBS][3][kcc][R]
  float* const red = bins + SUBS * 3 * kc * R;   // [3][SUBS][R]
  float* const buf0 = red + 3 * SUBS * R + s * WARP;
  int* const list = reinterpret_cast<int*>(buf0 + 2 * BUF);
  float* const outs[3] = {sums, sq, cross};
  const int64_t nq = b > s ? (b - s + 3) / 4 : 0;  // residue-s columns
  for (int c0 = 0; c0 < k; c0 += kc) {
    const int kcc = k - c0 < kc ? k - c0 : kc;
    float* const mine = bins + (size_t)s * 3 * kcc * R;
    for (int e = lane; e < 3 * kcc * R; e += 32) mine[e] = 0.f;
    float bs = 0.f, bq = 0.f, bc = 0.f;
    int64_t q0 = 0;
    int nl = 0, pos = 0, cur = 0;
    scan_columns(w, assign, nq, s, lane, c0, kcc, q0, list, nl, pos);
    int cnt = gather_batch(dxy, ld, m, row0, d1, d2, assign, w, lg, list, nl,
                           pos, lane, buf0);
    while (cnt > 0) {
      scan_columns(w, assign, nq, s, lane, c0, kcc, q0, list, nl, pos);
      const int next = gather_batch(dxy, ld, m, row0, d1, d2, assign, w, lg,
                                    list, nl, pos, lane,
                                    buf0 + (cur ^ 1) * BUF);
      rt::cp_async_wait<1>();
      __syncwarp();  // the current batch has landed for every lane
      const float* bt = buf0 + cur * BUF;
      const float* drow = bt + lane * DLD;
      const float* v = bt + R * DLD;
      for (int p = 0; p < cnt; ++p)
        rt::swap_col_vals(drow[p], v[p], v[BATCH + p], v[2 * BATCH + p],
                          v[3 * BATCH + p],
                          __float_as_int(v[4 * BATCH + p]) - c0, kcc, R, lane,
                          mine, bs, bq, bc);
      __syncwarp();  // every lane is done with the buffer it refills next
      cur ^= 1;
      cnt = next;
    }
    rt::cp_async_wait<0>();
    if (c0 == 0) {  // the base partials are the first chunk's
      red[(0 * SUBS + s) * R + lane] = bs;
      red[(1 * SUBS + s) * R + lane] = bq;
      red[(2 * SUBS + s) * R + lane] = bc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 3 * kcc * R; e += NT) {
      const int i = e % R, c = (e / R) % kcc, q = e / (R * kcc);
      if (row0 + i >= m) continue;
      outs[q][(int64_t)(c0 + c) * ldk + row0 + i] =
          rt::swap_fold_ld<SUBS>(red, bins, kcc, R, q, c, i);
    }
    __syncthreads();  // the next chunk's bins go over these
  }
}

size_t cached_smem(int k) {
  const int kc = k < KC_MAX ? k : KC_MAX;
  return (size_t)(SUBS * 3 * kc * R + 3 * SUBS * R + SUBS * WARP) *
         sizeof(float);
}

// One launch over `lanes` lanes of m (padded) rows.  The kernel has one
// shape, index 0 (32 rows a block); any other index is refused.
int launch(const float* dxy, int64_t lane_stride, int64_t ld,
           const int64_t* col, const float* d1, const float* d2,
           const int* assign, const float* w, const float* lg, float* sums,
           float* sq, float* cross, int64_t lanes, int64_t m, int64_t b, int k,
           const int* rows, const int* run, int shape, void* stream) {
  if (shape != 0 || k < 1 || b < 1 || ld < b || b > INT_MAX ||
      lanes > 65535)
    return (int)cudaErrorInvalidValue;
  if (m <= 0 || lanes <= 0) return cudaSuccess;
  const size_t smem = cached_smem(k);
  cudaError_t e = cudaFuncSetAttribute(
      swap_g_from_cache_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((m + R - 1) / R), (unsigned)lanes);
  swap_g_from_cache_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      dxy, ld, d1, d2, assign, w, lg, sums, sq, cross, m, b, k, run,
      lane_stride, col, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// The _tiled entries take the shape the tile tuner resolved (always 0,
// this kernel's one shape); rt_swap_g_from_cache and its lane form are
// the same launches.
extern "C" int rt_swap_g_from_cache_tiled(const float* dxy, int64_t ld,
                                          const float* d1, const float* d2,
                                          const int* assign, const float* w,
                                          const float* lg, float* sums,
                                          float* sq, float* cross, int64_t m,
                                          int64_t b, int k, const int* run,
                                          int shape, void* stream) {
  return launch(dxy, 0, ld, nullptr, d1, d2, assign, w, lg, sums, sq, cross,
                1, m, b, k, nullptr, run, shape, stream);
}

extern "C" int rt_swap_g_from_cache(const float* dxy, int64_t ld,
                                    const float* d1, const float* d2,
                                    const int* assign, const float* w,
                                    const float* lg, float* sums, float* sq,
                                    float* cross, int64_t m, int64_t b, int k,
                                    const int* run, void* stream) {
  return rt_swap_g_from_cache_tiled(dxy, ld, d1, d2, assign, w, lg, sums, sq,
                                    cross, m, b, k, run, 0, stream);
}

// The lane axis: lane l's block at dxy + l * lane_stride + col[l] (col
// NULL: 0), rows ld apart; d1 / d2 / assign / w / lg [lanes, b]; outputs
// [lanes, k, m]; rows and run [lanes] (NULL: m rows, every lane runs).
// col[l] + b must not pass the row's ld floats.
extern "C" int rt_swap_g_from_cache_lanes_tiled(
    const float* dxy, int64_t lane_stride, int64_t ld, const int64_t* col,
    const float* d1, const float* d2, const int* assign, const float* w,
    const float* lg, float* sums, float* sq, float* cross, int64_t lanes,
    int64_t m, int64_t b, int k, const int* rows, const int* run, int shape,
    void* stream) {
  return launch(dxy, lane_stride, ld, col, d1, d2, assign, w, lg, sums, sq,
                cross, lanes, m, b, k, rows, run, shape, stream);
}

extern "C" int rt_swap_g_from_cache_lanes(
    const float* dxy, int64_t lane_stride, int64_t ld, const int64_t* col,
    const float* d1, const float* d2, const int* assign, const float* w,
    const float* lg, float* sums, float* sq, float* cross, int64_t lanes,
    int64_t m, int64_t b, int k, const int* rows, const int* run,
    void* stream) {
  return rt_swap_g_from_cache_lanes_tiled(dxy, lane_stride, ld, col, d1, d2,
                                          assign, w, lg, sums, sq, cross,
                                          lanes, m, b, k, rows, run, 0,
                                          stream);
}

// The one shape's rows (32), columns (0: it walks any B), threads and
// blocks an SM at k clusters into info[0..3].
extern "C" int rt_swap_g_from_cache_shape(int shape, int k, int* info) {
  if (shape != 0 || k < 1) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t e = rt::blocks_per_sm(swap_g_from_cache_kernel, NT,
                                          cached_smem(k), &per_sm);
  if (e != cudaSuccess) return (int)e;
  info[0] = R;
  info[1] = 0;
  info[2] = NT;
  info[3] = per_sm;
  return cudaSuccess;
}
