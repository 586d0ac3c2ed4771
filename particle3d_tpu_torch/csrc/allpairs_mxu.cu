// K5: the ghost-image triangular all-pairs sweep for Hopper (sm_90a).
//
// Replaces `_mxu_kernel` of particle3d_tpu/ops/pallas_allpairs_mxu.py
// (launched by `_mxu_call`): a triangular sweep over the unordered tile
// pairs (i, (i+k) mod nt), k = 0 .. nt/2, of [reals | ghost images] with
// plain (unwrapped) deltas in world units, and the force sums of both
// directions in factored form,
//
//   F_i = A_i[0:3] - p_i * A_i[3],   A_i = sum_j s_ij * (x_j, y_j, z_j, 1),
//
// which the TPU kernel forms as S @ [P|1] matmuls on its matrix unit.
//
// Operands (f32, contiguous; P = 8 or 16 feature columns, zero-padded by
// the wrapper, which leaves U.V unchanged):
//
//   p4 [Mp,4] = (x, y, z, 1), zero rows on padding; u, v [Mp,P];
//   r2row [Mp] (r^2, or -1 on invalid ghosts and padding); imask [Mp] (1 on
//   reals and valid ghosts, else 0) -> out_a_part [S,Mp,3] (the i-side of
//   k-span s, fixed up), out_b [nk,3,Mp] (the j-side of step k for tile
//   (i+k) mod nt, fixed up); Mp = nt * TILE.
//
// Geometry and guards, as in `_mxu_kernel`: exact mode takes d2 from the
// deltas; fast mode from the Gram form |p_i|^2 + |p_j|^2 + 2 - 2 p4_i.p4_j
// clamped at 0 (the ones column folded in). A pair counts iff d2 > 0 and
// d2 < r2row[j]; on the k = 0 diagonal the index diagonal is masked in
// both modes (fast mode's d2 is noise around 0 there) and the j-side is
// written as 0; for even nt the k = nt/2 step is skipped for i >= nt/2 on
// both sides; the j-side scale is 0 where imask of the receiver row is 0,
// so padded rows and invalid ghosts never act as its sources (a select
// where the TPU kernel multiplies: 0 * inf would be a NaN). Unlike the TPU
// kernel, a tile pair with a dead tile (no row with imask 1: the trailing
// invalid ghosts and padding, which the ghost compaction puts last; a
// block-wide vote on imask finds it) computes nothing and writes zeros:
// rows < N then lack only the (near-)zero terms that particle life's parked
// invalid-ghost pairs add (the plain version skips the same pairs).
//
// What bounds it: arithmetic throughput, like K2. Per unordered pair it
// does K2's work without the wrap, plus a fourth sum on each side (41 + 4P
// operations in exact mode, 45 + 4P in fast mode; the coefficients' 4P, and
// fast mode's 7 of the Gram product, at the TF32 rate; utils/bounds.py's
// `ops_mxu`), over the live rows; the operands are a few tens of MB and
// out_b ~5 GB at N = 262,144 in a world of 40. The design is K2's, on the
// same tile-pair sweep (tile_pair_mma.cuh): coefficient tiles on tensor
// cores in 3xTF32, the pairs evaluated in the accumulator layout, the four
// sums a side in FP32 FFMA with their lane reductions deferred, fixed up
// once a k-span (i-side) and once a tile pair (j-side). The k-sum is a
// fixed-order torch reduction outside; no float atomics anywhere, so a
// rerun is bit-identical.
//
// The factored sums and fast mode's Gram product stay in FP32 FFMA: the
// factored form subtracts two |p|-magnitude sums, so tensor-core products
// of S @ [P|1] would carry TF32's operand error into forces of the
// difference's size (docs/PERF.md, "MXU formulation").
#include <cuda_runtime.h>

#include <cstddef>

#include "tile_pair_mma.cuh"

namespace {

using namespace p3t;

template <int LAW, bool FAST, int PP>
__global__ void __launch_bounds__(TILE)
mxu_kernel(const float* __restrict__ p4, const float* __restrict__ u,
           const float* __restrict__ v, const float* __restrict__ r2row,
           const float* __restrict__ imask, const int nt, const int kspan,
           float* __restrict__ out_a_part, float* __restrict__ out_b,
           const PairParams pf) {
  tri_sweep_block<LAW, FAST ? K5_FAST : K5_EXACT, PP>(
      p4, u, v, r2row, imask, nullptr, 0, nt, kspan, out_a_part, out_b, pf);
}

struct MxuLaunch {
  dim3 grid;
  cudaStream_t stream;
  const float *p4, *u, *v, *r2row, *imask;
  int nt, kspan;
  float *out_a_part, *out_b;
  PairParams pf;
  template <int LAW, bool FAST, int PP>
  void run() const {
    mxu_kernel<LAW, FAST, PP><<<grid, TILE, 0, stream>>>(
        p4, u, v, r2row, imask, nt, kspan, out_a_part, out_b, pf);
  }
};

}  // namespace

// Plain C entry point (loaded with ctypes). `params` points to the 14
// floats of pack_params in host memory; `splits` is the size of the
// partial-sum axis the caller allocated. Returns cudaGetLastError() after
// the launch (0: accepted), or cudaErrorInvalidValue for operands no
// instantiation takes.
extern "C" int p3t_allpairs_mxu(const float* p4, const float* u,
                                const float* v, const float* r2row,
                                const float* imask, int nt, int p,
                                const float* params, float* out_a_part,
                                int splits, float* out_b, int law, int fast,
                                void* stream) {
  const int nk = nt / 2 + 1;
  if (nt < 1 || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MxuLaunch f;
  f.grid = dim3(nt, splits);
  f.stream = static_cast<cudaStream_t>(stream);
  f.p4 = p4;
  f.u = u;
  f.v = v;
  f.r2row = r2row;
  f.imask = imask;
  f.nt = nt;
  f.kspan = (nk + splits - 1) / splits;
  f.out_a_part = out_a_part;
  f.out_b = out_b;
  f.pf = p3t::unpack(params);
  return p3t::launched(p3t::dispatch(law, fast, p, f));
}
