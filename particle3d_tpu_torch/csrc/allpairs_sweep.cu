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
//       -> out_a [Np,3], out_b [W,3,TILE]
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
// j-side partials out_b ~3.2 GB at TILE = 128). The designs keep every
// operand a pair reads in registers or shared memory:
//
//   K3: the classic tiled N-body shape. One thread per receiver (128 a
//       block) holds its position, U and its sum in registers; source
//       chunks of 128 rows are staged in shared memory and read as
//       broadcasts. A grid y-dimension splits the sources into S spans so
//       that a few receivers still fill the card; each span writes its own
//       partial sum (no atomics).
//   K2: one block per receiver tile i and k-span, looping over k inside the
//       block in place of the TPU's sequential grid axis, on the tile-pair
//       sweep it shares with K5 (tile_pair_mma.cuh): coefficient tiles on
//       tensor cores in 3xTF32, each lane evaluating the pairs of its
//       accumulator fragment, the i-side reduced over lanes once a k-span
//       and the j-side once per column of the warp's rows, then across
//       warps in shared memory in a fixed order. Each (k, j) block of out_b
//       is written exactly once; the k-sum is a fixed-order torch reduction
//       outside. No float atomics anywhere: a rerun is bit-identical.
//   K4: one block per receiver tile walks that tile's run of worklist
//       entries (found from row_start) and writes each entry's j-side once
//       into out_b[s], on the earlier body `tile_pair` below: each of the 128
//       threads owns one receiver row, walks the staged source tile column
//       by column (broadcast reads) with FP32 dot products, and reduces the
//       j-side 8 columns at a time across the warp (9 shuffles a component),
//       then across the 4 warps in shared memory.
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

constexpr int RECT_THREADS = 128;  // K3 receivers per block
constexpr int RECT_CHUNK = 128;    // K3 source rows staged per pass

// ---------------------------------------------------------------- K3

template <int LAW, bool WRAP, int PP>
__global__ void __launch_bounds__(RECT_THREADS)
rect_kernel(const float* __restrict__ pos, const float* __restrict__ u,
            const int n, const float* __restrict__ src,
            const float* __restrict__ v, const float* __restrict__ r2row,
            const int m, const int span, float* __restrict__ out_part,
            const PairParams pf) {
  __shared__ float4 sp[RECT_CHUNK];  // x, y, z, r2 of the staged sources
  __shared__ __align__(16) float sv[RECT_CHUNK * PP];

  const int i = blockIdx.x * RECT_THREADS + threadIdx.x;
  const bool active = i < n;
  const size_t ii = active ? i : n - 1;  // idle threads read a real row
  const float xi = pos[3 * ii];
  const float yi = pos[3 * ii + 1];
  const float zi = pos[3 * ii + 2];
  float ui[PP];
  load_vec<PP>(ui, u + ii * PP);
  const float w = pf.v[p3t::PF_W];
  const float inv_w = pf.v[p3t::PF_INV_W];
  const int j0 = blockIdx.y * span;
  const int j1 = min(m, j0 + span);
  float ax = 0.0f, ay = 0.0f, az = 0.0f;

  for (int base = j0; base < j1; base += RECT_CHUNK) {
    const int nrow = min(RECT_CHUNK, j1 - base);
    __syncthreads();  // previous chunk fully consumed
    for (int r = threadIdx.x; r < nrow; r += RECT_THREADS) {
      const size_t j = base + r;
      sp[r] = make_float4(src[3 * j], src[3 * j + 1], src[3 * j + 2], r2row[j]);
      copy_vec<PP>(sv + r * PP, v + j * PP);
    }
    __syncthreads();
    if (active) {
      for (int r = 0; r < nrow; ++r) {
        const float4 q = sp[r];
        float dx = q.x - xi;
        float dy = q.y - yi;
        float dz = q.z - zi;
        if (WRAP) {
          dx = dx - rintf(dx * inv_w) * w;
          dy = dy - rintf(dy * inv_w) * w;
          dz = dz - rintf(dz * inv_w) * w;
        }
        const float d2 = dx * dx + dy * dy + dz * dz;
        const float coef = dot<PP>(ui, sv + r * PP);
        const float s = p3t::gated_scale<LAW>(d2, d2 < q.w, coef, pf);
        ax = fmaf(dx, s, ax);
        ay = fmaf(dy, s, ay);
        az = fmaf(dz, s, az);
      }
    }
  }
  if (active) {
    float* o = out_part + (static_cast<size_t>(blockIdx.y) * n + i) * 3;
    o[0] = ax;
    o[1] = ay;
    o[2] = az;
  }
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

template <int PP>
struct TileSmem {
  float4 p[TILE];  // x, y, z, r2 of the staged source tile
  alignas(16) float u[TILE * PP];
  alignas(16) float v[TILE * PP];
  float part[WARPS][3][TILE];  // per-warp j-side column sums
};

template <int PP>
struct Row {
  float x, y, z, mask;
  float u[PP], v[PP];
};

template <int PP>
__device__ __forceinline__ Row<PP> load_row(const float* __restrict__ pos,
                                            const float* __restrict__ u,
                                            const float* __restrict__ v,
                                            const float* __restrict__ imask,
                                            const size_t row) {
  Row<PP> r;
  r.x = pos[3 * row];
  r.y = pos[3 * row + 1];
  r.z = pos[3 * row + 2];
  r.mask = imask[row];
  load_vec<PP>(r.u, u + row * PP);
  load_vec<PP>(r.v, v + row * PP);
  return r;
}

// One unordered tile pair: the receiver tile's row `r` is in this thread's
// registers, source tile j is staged here. Adds the i-side (box units in
// wrap mode) to (ax, ay, az) and writes the j-side, negated and restored to
// world units, to ob[c * cstride + b] for column b; 0 when `self`.
template <int LAW, bool WRAP, int PP>
__device__ __forceinline__ void tile_pair(
    TileSmem<PP>& sm, const Row<PP>& r, const float* __restrict__ pos,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ r2row, const int j, const bool self,
    float& ax, float& ay, float& az, float* __restrict__ ob,
    const size_t cstride, const PairParams& pf) {
  const int a = threadIdx.x;
  const int lane = a & 31;
  const int warp = a >> 5;
  const float w = pf.v[p3t::PF_W];
  const float w2 = w * w;

  __syncthreads();  // the previous pair's staged tile and partials are consumed
  {
    const size_t jr = static_cast<size_t>(j) * TILE + a;
    sm.p[a] = make_float4(pos[3 * jr], pos[3 * jr + 1], pos[3 * jr + 2], r2row[jr]);
    copy_vec<PP>(sm.u + a * PP, u + jr * PP);
    copy_vec<PP>(sm.v + a * PP, v + jr * PP);
  }
  __syncthreads();

  for (int b0 = 0; b0 < TILE; b0 += GROUP) {
    float px[GROUP], py[GROUP], pz[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const int b = b0 + g;
      const float4 q = sm.p[b];
      float dx = q.x - r.x;
      float dy = q.y - r.y;
      float dz = q.z - r.z;
      if (WRAP) {
        dx = dx - rintf(dx);
        dy = dy - rintf(dy);
        dz = dz - rintf(dz);
      }
      float d2 = dx * dx + dy * dy + dz * dz;
      const bool valid = d2 > (WRAP ? 1e-12f : 0.0f) && d2 < q.w;
      if (WRAP) d2 = d2 * w2;
      const float cij = dot<PP>(r.u, sm.v + b * PP);
      const float cji = dot<PP>(r.v, sm.u + b * PP);
      const p3t::PairParts parts = p3t::pair_parts<LAW>(d2, valid, pf);
      const float sij = p3t::directional_scale(parts, cij);
      // a select, not a multiply: a padded row sits at the origin, where a
      // singular law can give an infinite scale, and inf * 0 is NaN
      const float sji = r.mask > 0.0f ? p3t::directional_scale(parts, cji) : 0.0f;
      ax = fmaf(dx, sij, ax);
      ay = fmaf(dy, sij, ay);
      az = fmaf(dz, sij, az);
      px[g] = dx * sji;
      py[g] = dy * sji;
      pz[g] = dz * sji;
    }
    const float sx = warp_column_sums(px, lane);
    const float sy = warp_column_sums(py, lane);
    const float sz = warp_column_sums(pz, lane);
    if (lane < GROUP) {
      const int col = b0 + column_of_lane(lane);
      sm.part[warp][0][col] = sx;
      sm.part[warp][1][col] = sy;
      sm.part[warp][2][col] = sz;
    }
  }
  __syncthreads();

  float bx = 0.0f, by = 0.0f, bz = 0.0f;
  if (!self) {
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      bx += sm.part[k][0][a];
      by += sm.part[k][1][a];
      bz += sm.part[k][2][a];
    }
    const float sc = WRAP ? -w : -1.0f;
    bx *= sc;
    by *= sc;
    bz *= sc;
  }
  ob[a] = bx;
  ob[cstride + a] = by;
  ob[2 * cstride + a] = bz;
}

template <int LAW, bool WRAP, int PP>
__global__ void __launch_bounds__(TILE)
pairlist_kernel(const float* __restrict__ pos, const float* __restrict__ u,
                const float* __restrict__ v, const float* __restrict__ r2row,
                const float* __restrict__ imask, const int* __restrict__ wj,
                const int* __restrict__ row_start, float* __restrict__ out_a,
                float* __restrict__ out_b, const PairParams pf) {
  __shared__ TileSmem<PP> sm;
  const int i = blockIdx.x;
  const size_t row = static_cast<size_t>(i) * TILE + threadIdx.x;
  const Row<PP> r = load_row<PP>(pos, u, v, imask, row);
  const int s1 = row_start[i + 1];
  float ax = 0.0f, ay = 0.0f, az = 0.0f;

  for (int s = row_start[i]; s < s1; ++s) {
    const int j = wj[s];
    tile_pair<LAW, WRAP, PP>(sm, r, pos, u, v, r2row, j, j == i, ax, ay, az,
                             out_b + static_cast<size_t>(s) * 3 * TILE, TILE, pf);
  }
  const float sc = WRAP ? pf.v[p3t::PF_W] : 1.0f;
  out_a[3 * row] = ax * sc;
  out_a[3 * row + 1] = ay * sc;
  out_a[3 * row + 2] = az * sc;
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
    rect_kernel<LAW, WRAP, PP><<<grid, RECT_THREADS, 0, stream>>>(
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
  int nt;
  cudaStream_t stream;
  const float *pos, *u, *v, *r2row, *imask;
  const int *wj, *row_start;
  float *out_a, *out_b;
  PairParams pf;
  template <int LAW, bool WRAP, int PP>
  void run() const {
    pairlist_kernel<LAW, WRAP, PP><<<nt, TILE, 0, stream>>>(
        pos, u, v, r2row, imask, wj, row_start, out_a, out_b, pf);
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
  const int per = (m + splits - 1) / splits;
  RectLaunch f;
  f.grid = dim3((n + RECT_THREADS - 1) / RECT_THREADS, splits);
  f.stream = static_cast<cudaStream_t>(stream);
  f.pos = pos;
  f.u = u;
  f.src = src;
  f.v = v;
  f.r2row = r2row;
  f.n = n;
  f.m = m;
  f.span = (per + RECT_CHUNK - 1) / RECT_CHUNK * RECT_CHUNK;
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

extern "C" int p3t_allpairs_pairlist(const float* pos, const float* u,
                                     const float* v, const float* r2row,
                                     const float* imask, const int* wj,
                                     const int* row_start, int nt, int p,
                                     const float* params, float* out_a,
                                     float* out_b, int law, int wrap,
                                     void* stream) {
  if (nt < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PairlistLaunch f;
  f.nt = nt;
  f.stream = static_cast<cudaStream_t>(stream);
  f.pos = pos;
  f.u = u;
  f.v = v;
  f.r2row = r2row;
  f.imask = imask;
  f.wj = wj;
  f.row_start = row_start;
  f.out_a = out_a;
  f.out_b = out_b;
  f.pf = p3t::unpack(params);
  return p3t::launched(p3t::dispatch(law, wrap, p, f));
}
