// K2, K3, K4: all-pairs force sweeps for Hopper (sm_90a).
//
// Replaces three Pallas kernels of particle3d_tpu/ops/pallas_allpairs.py:
//
//   K3 `_kernel` (launched by `_call`)        -> rect_kernel
//      one-sided: receivers against a source set
//   K2 `_tri_kernel` / `_tri_body` (`_tri_call`) -> tri_kernel
//      triangular same-set sweep over unordered tile pairs (i, (i+k) mod nt),
//      k = 0 .. nt/2, optionally culled by a bit mask [nt, ceil(nk/32)]
//   K4 `_pairlist_kernel` (`_pairlist_call`)  -> pairlist_kernel
//      K2's tile-pair math over a worklist of surviving tile pairs, sorted
//      by receiver tile
//
// Operands (f32 unless noted, all contiguous; P = 8 or 16 feature columns,
// zero-padded by the wrapper, which leaves U.V unchanged):
//
//   K3: pos [N,3], u [N,P], src [M,3], v [M,P], r2row [M] (r^2, or -1 for
//       a masked source) -> out_part [S,N,3], summed over S by the wrapper
//   K2: pos [Np,3] (pre-scaled by 1/w in wrap mode), u, v [Np,P], r2row [Np]
//       (r^2/w^2 or -1 for padding), imask [Np], mask i32 [nt,nkw] or null
//       -> out_a_part [S,Np,3], out_b [nk,3,Np]; Np = nt * TILE
//   K4: K2's row operands, wj i32 [W] (source tile of each entry), row_start
//       i32 [nt+1] (entries of receiver tile i: [row_start[i], row_start[i+1]))
//       -> out_a_part [S,Np,3], out_b [W,3,TILE]
//
// Formulations differ as in the Pallas kernels. K3 wraps in world units,
// dx - rint(dx / w) * w (computed as dx * (1/w)), and gates with
// `gated_scale`. K2 and K4 wrap in box units, dx - rint(dx), gate
// d2 > 1e-12 (wrap) or > 0 (walls) and d2 < r2row in box units, then
// restore d2 with w^2 and the force sums with w; the two directional scales
// come from `pair_parts` once per unordered pair.
//
// What bounds them. Five-species particle life needs ~50 FP32 operations a
// pair one-sided (K3) and ~64 for both directions of an unordered pair (K2,
// K4; the counts are in utils/bounds.py), 2P and 4P of them the rank-1
// coefficients, against a few bytes of operands per particle: all three
// are bound by arithmetic throughput, not by device memory (K2 at
// N = 262,144 does 3.4e10 unordered pairs; its operands are ~20 MB, its
// j-side partials out_b ~3.2 GB at TILE = 128). All three run on one
// tile-pair sweep (tile_pair_mma.cuh): coefficient tiles on tensor cores in
// 3xTF32, each lane evaluating the pairs of its accumulator fragment, the
// i-side reduced over lanes once a block and the j-side once per column of
// the warp's rows, then across warps in shared memory in a fixed order. A
// block of 128 threads takes one receiver tile:
//
//   K3: a span of the source set's tiles, one-sided. A grid y-dimension
//       of S spans lets a few receivers fill the card; each span writes its
//       own partial sum (no atomics).
//   K2: a span of steps k, looping over k inside the block in place of the
//       TPU's sequential grid axis. Each (k, j) block of out_b is written
//       exactly once; the k-sum is a fixed-order torch reduction outside.
//   K4: a share of its tile's run of worklist entries (found from
//       row_start): a grid y-dimension of S shares splits the long runs
//       that the Morton order leaves on some tiles across blocks; each share
//       writes its own i-side partial, and each entry's j-side is written
//       once into out_b[s].
//
// No float atomics anywhere: a rerun is bit-identical.
//
// Double-count guards, exactly as in `_tri_body`: the k = 0 diagonal (and
// K4's self entries j == i) is one-sided, its j-side written as 0; for even
// nt the k = nt/2 step is skipped for i >= nt/2 on both sides; padded
// receiver rows are selected out of the j-side by imask. In mask mode a
// skipped (i, k) step writes zeros to its out_b block and k = 0 always runs.
#include <cuda_runtime.h>

#include <cstddef>

#include "tile_pair_mma.cuh"

namespace {

using namespace p3t;

// ---------------------------------------------------------------- K3

template <int LAW, bool WRAP, int PP>
__global__ void __launch_bounds__(TILE)
rect_kernel(const float* __restrict__ pos, const float* __restrict__ u,
            const int n, const float* __restrict__ src,
            const float* __restrict__ v, const float* __restrict__ r2row,
            const int m, const int span, float* __restrict__ out_part,
            const PairParams pf) {
  rect_sweep_block<LAW, WRAP ? K3_WRAP : K3_WALLS, PP>(
      pos, u, n, src, v, r2row, m, span, out_part, pf);
}

// -------------------------------------------------------------- K2

template <int LAW, bool WRAP, int PP>
__global__ void __launch_bounds__(TILE)
tri_kernel(const float* __restrict__ pos, const float* __restrict__ u,
           const float* __restrict__ v, const float* __restrict__ r2row,
           const float* __restrict__ imask, const int* __restrict__ mask,
           const int nkw, const int nt, const int kspan,
           float* __restrict__ out_a_part, float* __restrict__ out_b,
           const PairParams pf) {
  tri_sweep_block<LAW, WRAP ? K2_WRAP : K2_WALLS, PP>(
      pos, u, v, r2row, imask, mask, nkw, nt, kspan, out_a_part, out_b, pf);
}

// -------------------------------------------------------------- K4

template <int LAW, bool WRAP, int PP>
__global__ void __launch_bounds__(TILE)
pairlist_kernel(const float* __restrict__ pos, const float* __restrict__ u,
                const float* __restrict__ v, const float* __restrict__ r2row,
                const float* __restrict__ imask, const int* __restrict__ wj,
                const int* __restrict__ row_start, const int nt,
                float* __restrict__ out_a_part, float* __restrict__ out_b,
                const PairParams pf) {
  worklist_sweep_block<LAW, WRAP ? K2_WRAP : K2_WALLS, PP>(
      pos, u, v, r2row, imask, wj, row_start, nt, out_a_part, out_b, pf);
}

// ------------------------------------------------------------ launchers

struct RectLaunch {
  dim3 grid;
  cudaStream_t stream;
  const float *pos, *u, *src, *v, *r2row;
  int n, m, span;
  float* out_part;
  PairParams pf;
  template <int LAW, bool WRAP, int PP>
  void run() const {
    rect_kernel<LAW, WRAP, PP><<<grid, TILE, 0, stream>>>(
        pos, u, n, src, v, r2row, m, span, out_part, pf);
  }
};

struct TriLaunch {
  dim3 grid;
  cudaStream_t stream;
  const float *pos, *u, *v, *r2row, *imask;
  const int* mask;
  int nkw, nt, kspan;
  float *out_a_part, *out_b;
  PairParams pf;
  template <int LAW, bool WRAP, int PP>
  void run() const {
    tri_kernel<LAW, WRAP, PP><<<grid, TILE, 0, stream>>>(
        pos, u, v, r2row, imask, mask, nkw, nt, kspan, out_a_part, out_b, pf);
  }
};

struct PairlistLaunch {
  dim3 grid;
  cudaStream_t stream;
  const float *pos, *u, *v, *r2row, *imask;
  const int *wj, *row_start;
  int nt;
  float *out_a_part, *out_b;
  PairParams pf;
  template <int LAW, bool WRAP, int PP>
  void run() const {
    pairlist_kernel<LAW, WRAP, PP><<<grid, TILE, 0, stream>>>(
        pos, u, v, r2row, imask, wj, row_start, nt, out_a_part, out_b, pf);
  }
};

}  // namespace

// Plain C entry points (loaded with ctypes). `params` points to the 14
// floats of pack_params in host memory; `splits` is the size of the
// partial-sum axis the caller allocated. Each returns cudaGetLastError()
// after the launch (0: accepted), or cudaErrorInvalidValue for operands no
// instantiation takes.

extern "C" int p3t_allpairs_rect(const float* pos, const float* u, int n,
                                 const float* src, const float* v,
                                 const float* r2row, int m, int p,
                                 const float* params, float* out_part,
                                 int splits, int law, int wrap, void* stream) {
  if (n < 1 || m < 0 || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ntj = (m + TILE - 1) / TILE;
  RectLaunch f;
  f.grid = dim3((n + TILE - 1) / TILE, splits);
  f.stream = static_cast<cudaStream_t>(stream);
  f.pos = pos;
  f.u = u;
  f.src = src;
  f.v = v;
  f.r2row = r2row;
  f.n = n;
  f.m = m;
  f.span = (ntj + splits - 1) / splits;  // source tiles a block
  f.out_part = out_part;
  f.pf = p3t::unpack(params);
  return p3t::launched(p3t::dispatch(law, wrap, p, f));
}

extern "C" int p3t_allpairs_tri(const float* pos, const float* u,
                                const float* v, const float* r2row,
                                const float* imask, const int* mask, int nkw,
                                int nt, int p, const float* params,
                                float* out_a_part, int splits, float* out_b,
                                int law, int wrap, void* stream) {
  const int nk = nt / 2 + 1;
  if (nt < 1 || splits < 1 || (mask != nullptr && nkw < (nk + 31) / 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TriLaunch f;
  f.grid = dim3(nt, splits);
  f.stream = static_cast<cudaStream_t>(stream);
  f.pos = pos;
  f.u = u;
  f.v = v;
  f.r2row = r2row;
  f.imask = imask;
  f.mask = mask;
  f.nkw = nkw;
  f.nt = nt;
  f.kspan = (nk + splits - 1) / splits;
  f.out_a_part = out_a_part;
  f.out_b = out_b;
  f.pf = p3t::unpack(params);
  return p3t::launched(p3t::dispatch(law, wrap, p, f));
}

// K4: `splits` shares of each receiver tile's run of entries, one block
// each; out_a_part [splits, Np, 3]
extern "C" int p3t_allpairs_pairlist_spans(
    const float* pos, const float* u, const float* v, const float* r2row,
    const float* imask, const int* wj, const int* row_start, int nt, int p,
    const float* params, float* out_a_part, int splits, float* out_b, int law,
    int wrap, void* stream) {
  if (nt < 1 || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PairlistLaunch f;
  f.grid = dim3(nt, splits);
  f.stream = static_cast<cudaStream_t>(stream);
  f.pos = pos;
  f.u = u;
  f.v = v;
  f.r2row = r2row;
  f.imask = imask;
  f.wj = wj;
  f.row_start = row_start;
  f.nt = nt;
  f.out_a_part = out_a_part;
  f.out_b = out_b;
  f.pf = p3t::unpack(params);
  return p3t::launched(p3t::dispatch(law, wrap, p, f));
}
