// Pairwise dissimilarity [m, d] x [r, d] -> [m, r] (float32).
//
// Replaces the TPU kernel src/repro/kernels/pairwise.py:74
// (pairwise_kernel).  Bound on the H100: 2*m*r*d FMA flops against
// 67 TFLOP/s float32, or reading x and y once and writing m*r floats at
// 3.35 TB/s, whichever is longer.  A PIC round's fresh block [60,000 x
// 100 x 784] is compute-bound (0.14 ms); predict's [10,000 x 10], a
// d_near row [1 x 60,000] and a leader row [1 x 100] are memory- or
// latency-bound.
//
// Design: the pipelined, register-blocked mainloop of dist_mainloop.cuh,
// whose bits are dist_math.cuh's, in the shape whose index the caller
// passes to rt_pairwise_tiled (repro_torch/core/tuning.py resolves it):
// * r > 16 and m > 16: a wide tile, 128, 64 or 32 rows by 104 columns (a
//   whole B = 100 batch, so x is staged once per round) or by 128 (a
//   sharded round's B = 128 in one column tile);
// * r <= 16 (predict): the narrow tile, 64 rows x 16 columns;
// * m <= 16 (d_near and leader rows): the narrow tile with the operands
//   swapped, y's rows down the tile and x's across, so a block is not
//   nearly all padding; each thread stores its column of out.
// rt_pairwise keeps the choice it has always made (the 128 x 104 wide
// tile, else a narrow one by r and m).
// The finished tile goes to device memory through shared memory, so
// consecutive threads store consecutive floats of a row of out; ragged
// rows and columns are masked.  There is no feature-axis split: the
// mainloop loops over any d.
//
// Output row stride and run flag.  out's rows are ldo floats apart (ldo
// >= r), so a PIC round's fresh block is written straight into its slot
// of the column ring (cols[:, s:s+B], ldo = W*B).  `run` (NULL: run) is
// the device-resident search's flag: where it reads 0 every block returns
// before its first load and out is left as it was, which is what keeps a
// masked round, or a round that must not be written through, from
// touching the ring.  Neither changes the arithmetic, tile or order, so
// ldo = r and a flag of 1 give the bits of the plain launch.
//
// The lane axis (rt_pairwise_lanes, the PIC fit_batch).  L independent
// problems x [L, m, d] against y [L, r, d] run as one launch: blockIdx.z
// is the lane, each lane with its own row counts mrows[l] <= m and
// rrows[l] <= r, its run flag, and its output at out + l * lane_out +
// ocol[l] (rows ldo apart).  So one launch writes every lane's fresh PIC
// block into its slot of the lane ring (ocol[l] the slot's first column)
// or, for a recycled round, into the ring's scratch columns, while a
// served lane's flag reads 0; and it computes every lane's d_near row
// ([1 x n_l]).  A block offsets its pointers to its lane and runs the
// single launch's body on the lane's extents: blocks past them, and every
// block of a lane whose flag reads 0, return at once.  The tile is chosen
// from the padded extents; a pair's bits do not depend on the tile, so
// lane l gives the bits of rt_pairwise on its own slices; rt_pairwise is
// the same kernel with one lane.
#include <stdint.h>

#include "dist_mainloop.cuh"

namespace {

// SWAP_AB: the tile's rows are y rows and its columns x rows.  m and r
// are the padded extents (each lane's x and y are m * d and r * d floats
// apart); mrows / rrows (NULL: m / r) the lane's own.
template <int M, class C, bool SWAP_AB>
__global__ void __launch_bounds__(C::NT, C::MINB)
pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, int64_t m, int64_t r, int64_t ldo,
                int d, bool vec, const int* __restrict__ run,
                const int* __restrict__ mrows, const int* __restrict__ rrows,
                const int64_t* __restrict__ ocol, int64_t lane_out) {
  const int64_t lane = blockIdx.z;
  if (run != nullptr && run[lane] == 0) return;  // masked: out is untouched
  x += lane * m * d;
  y += lane * r * d;
  out += lane * lane_out + (ocol != nullptr ? ocol[lane] : 0);
  if (mrows != nullptr) m = mrows[lane];
  if (rrows != nullptr) r = rrows[lane];
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int64_t ma = SWAP_AB ? r : m, mb = SWAP_AB ? m : r;
  const int64_t a0 = (int64_t)blockIdx.x * C::BM;
  const int64_t b0 = (int64_t)blockIdx.y * C::BN;
  if (a0 >= ma || b0 >= mb) return;  // past the lane's extents
  float acc[C::RM][C::RN];
  rt::dist_mainloop<M, C>(SWAP_AB ? y : x, SWAP_AB ? x : y, ma, mb, d, a0,
                          b0, vec, smem, acc);
  rt::dist_finish<M, C, SWAP_AB>(smem, acc);
  // The tile goes to device memory through shared memory (over the free
  // stages), so consecutive threads store consecutive floats of out.
  constexpr int LDT = C::BN + 1;
  static_assert(C::BM * LDT <= C::NORMS, "the tile fits in the stages");
  float* dt = smem;
  const int tx = C::tx(), ty = C::ty();
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RN; ++j)
      dt[(ty + C::TY * i) * LDT + tx + C::TX * j] = acc[i][j];
  __syncthreads();
  for (int e = threadIdx.x; e < C::BM * C::BN; e += C::NT) {
    // SWAP_AB: out's rows run across the tile, so walk its rows fastest.
    const int i = SWAP_AB ? e % C::BM : e / C::BN;
    const int j = SWAP_AB ? e / C::BM : e % C::BN;
    const int64_t ga = a0 + i, gb = b0 + j;
    if (ga >= ma || gb >= mb) continue;
    out[SWAP_AB ? gb * ldo + ga : ga * ldo + gb] = dt[i * LDT + j];
  }
}

struct Lanes {
  int64_t lanes, lane_out;
  const int *mrows, *rrows;
  const int64_t* ocol;
};

template <int M, class C, bool SWAP_AB>
cudaError_t launch(const float* x, const float* y, float* out, int64_t m,
                   int64_t r, int64_t ldo, int d, bool vec, const int* run,
                   const Lanes& ln, cudaStream_t st) {
  const int64_t ma = SWAP_AB ? r : m, mb = SWAP_AB ? m : r;
  const dim3 grid((unsigned)((ma + C::BM - 1) / C::BM),
                  (unsigned)((mb + C::BN - 1) / C::BN), (unsigned)ln.lanes);
  auto kernel = pairwise_kernel<M, C, SWAP_AB>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, C::NT, C::SMEM, st>>>(x, y, out, m, r, ldo, d, vec, run,
                                       ln.mrows, ln.rrows, ln.ocol,
                                       ln.lane_out);
  return cudaGetLastError();
}

// The shapes of the _tiled entries, by index (tuning.PAIRWISE_SHAPES):
// 0 the narrow tile, 1 the narrow tile with the operands swapped, 2-4
// the wide tile's rows (128, 64, 32) at 104 columns, 5-7 the same rows
// at 128 columns.  A pair's bits do not depend on the shape.
template <class C_, bool SWAP_>
struct Shape {
  using C = C_;
  static constexpr bool SWAP = SWAP_;
};

template <class F>
int with_shape(int shape, F&& f) {
  switch (shape) {
    case 0:
      return f(Shape<rt::NarrowTile, false>{});
    case 1:
      return f(Shape<rt::NarrowTile, true>{});
    case 2:
      return f(Shape<rt::WideTile, false>{});
    case 3:
      return f(Shape<rt::Wide64, false>{});
    case 4:
      return f(Shape<rt::Wide32, false>{});
    case 5:
      return f(Shape<rt::Col128, false>{});
    case 6:
      return f(Shape<rt::Col128x64, false>{});
    case 7:
      return f(Shape<rt::Col128x32, false>{});
  }
  return (int)cudaErrorInvalidValue;
}

// The shape rt_pairwise has always taken: narrow for r <= 16, narrow with
// the operands swapped for m <= 16, else the wide tile.
int legacy_shape(int64_t m, int64_t r) {
  if (r <= rt::NarrowTile::BN) return 0;
  if (m <= rt::NarrowTile::BN) return 1;
  return 2;
}

int dispatch(const float* x, const float* y, float* out, int64_t m,
             int64_t r, int64_t ldo, int d, int metric, const int* run,
             const Lanes& ln, int shape, void* stream) {
  if (ldo < r || ln.lanes > 65535) return (int)cudaErrorInvalidValue;
  // Lane bases are whole rows apart, so every lane shares lane 0's
  // alignment when d % 4 == 0.
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return with_shape(shape, [&](auto s) -> int {
    using S = decltype(s);
    if (m <= 0 || r <= 0 || ln.lanes <= 0) return cudaSuccess;
    RT_METRIC_SWITCH(metric, M, {
      return (int)launch<M, typename S::C, S::SWAP>(x, y, out, m, r, ldo, d,
                                                    vec, run, ln, st);
    });
    return cudaSuccess;
  });
}

}  // namespace

// The entries below take the shape the caller resolved (the tile tuner,
// through ops.py); rt_pairwise and rt_pairwise_lanes keep the shape they
// have always chosen by m and r.
extern "C" int rt_pairwise_tiled(const float* x, const float* y, float* out,
                                 int64_t m, int64_t r, int64_t ldo, int d,
                                 int metric, const int* run, int shape,
                                 void* stream) {
  return dispatch(x, y, out, m, r, ldo, d, metric, run,
                  Lanes{1, 0, nullptr, nullptr, nullptr}, shape, stream);
}

extern "C" int rt_pairwise(const float* x, const float* y, float* out,
                           int64_t m, int64_t r, int64_t ldo, int d,
                           int metric, const int* run, void* stream) {
  return rt_pairwise_tiled(x, y, out, m, r, ldo, d, metric, run,
                           legacy_shape(m, r), stream);
}

// The lane axis: x [lanes, m, d], y [lanes, r, d]; lane l's output at
// out + l * lane_out + ocol[l], rows ldo apart; mrows, rrows and run
// [lanes] (NULL: m rows, r rows, every lane runs), ocol [lanes] int64
// (NULL: 0).  ocol[l] + rrows[l] must not pass the row's ldo floats.
extern "C" int rt_pairwise_lanes_tiled(const float* x, const float* y,
                                       float* out, int64_t lanes, int64_t m,
                                       int64_t r, int64_t lane_out,
                                       int64_t ldo, int d, int metric,
                                       const int* mrows, const int* rrows,
                                       const int64_t* ocol, const int* run,
                                       int shape, void* stream) {
  return dispatch(x, y, out, m, r, ldo, d, metric, run,
                  Lanes{lanes, lane_out, mrows, rrows, ocol}, shape, stream);
}

extern "C" int rt_pairwise_lanes(const float* x, const float* y, float* out,
                                 int64_t lanes, int64_t m, int64_t r,
                                 int64_t lane_out, int64_t ldo, int d,
                                 int metric, const int* mrows,
                                 const int* rrows, const int64_t* ocol,
                                 const int* run, void* stream) {
  return rt_pairwise_lanes_tiled(x, y, out, lanes, m, r, lane_out, ldo, d,
                                 metric, mrows, rrows, ocol, run,
                                 legacy_shape(m, r), stream);
}

// Shape `shape`'s rows, columns, threads and blocks an SM (l2) into
// info[0..3], for the tuner's wave model.
extern "C" int rt_pairwise_shape(int shape, int k, int* info) {
  (void)k;
  return with_shape(shape, [&](auto s) -> int {
    using S = decltype(s);
    using C = typename S::C;
    int per_sm = 0;
    const cudaError_t e = rt::blocks_per_sm(
        pairwise_kernel<rt::L2, C, S::SWAP>, C::NT, C::SMEM, &per_sm);
    if (e != cudaSuccess) return e;
    return rt::shape_info<C>(info, per_sm);
  });
}
