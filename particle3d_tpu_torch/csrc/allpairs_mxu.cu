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
// where the TPU kernel multiplies: 0 * inf would be a NaN).
//
// What bounds it: FP32 issue, like K2. Per unordered pair it does K2's work
// without the wrap, plus a fourth sum on each side (41 + 4P operations in
// exact mode, 45 + 4P in fast mode; chip_smoke.py's `ops_mxu`), over
// Mp = N + ghost rows; the operands are a few tens of MB and out_b ~5 GB
// at N = 262,144 in a world of 40. The design is K2's (allpairs_sweep.cu):
// one block per receiver tile and k-span, each of the 128 threads owning a
// receiver row whose four i-side sums stay in registers across the k loop
// and are fixed up once at the end of the span; the source tile staged in
// shared memory and walked column by column (broadcast reads); the j-side's
// four column sums reduced across the warp in a fixed order
// (`warp_column_sums`, 36 shuffles per 8 columns) and across the 4 warps
// in shared memory, fixed up with the column's own position and written
// once to out_b[k]. The k-sum is a fixed-order torch reduction outside; no
// float atomics anywhere, so a rerun is bit-identical.
//
// Every product and sum runs in FP32 FFMA. The factored form subtracts two
// |p|-magnitude sums, so the 10-bit operands of plain TF32 tensor-core
// products would give errors of the force's own size (docs/PERF.md,
// "MXU formulation"); 3xTF32 `mma`/`wgmma` for S @ [P|1] and the Gram
// product is the redesign's work.
#include <cuda_runtime.h>

#include <cstddef>

#include "tile_sweep.cuh"

namespace {

using namespace p3t;

template <int PP>
struct MxuSmem {
  float4 p[TILE];  // x, y, z and the ones column of the staged source tile
  float r2[TILE];  // their gates
  float nn[TILE];  // their |p|^2 (fast mode)
  alignas(16) float u[TILE * PP];
  alignas(16) float v[TILE * PP];
  float part[WARPS][4][TILE];  // per-warp j-side column sums
};

template <int PP>
struct MxuRow {
  float4 p;  // x, y, z, ones column
  float nn;  // |p|^2
  float mask;
  float u[PP], v[PP];
};

// One unordered tile pair: the receiver tile's row is in this thread's
// registers, source tile j is staged here. Adds sum_j s_ij (x_j, y_j, z_j,
// 1_j) to acc and writes the fixed-up j-side of each column b to
// ob[c * cstride + b]; 0 when `self`.
template <int LAW, bool FAST, int PP>
__device__ __forceinline__ void mxu_tile_pair(
    MxuSmem<PP>& sm, const MxuRow<PP>& r, const float* __restrict__ p4,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ r2row, const int j, const bool self,
    float (&acc)[4], float* __restrict__ ob, const size_t cstride,
    const PairParams& pf) {
  const int a = threadIdx.x;
  const int lane = a & 31;
  const int warp = a >> 5;

  __syncthreads();  // the previous pair's staged tile and partials are consumed
  {
    const size_t jr = static_cast<size_t>(j) * TILE + a;
    const float4 q = reinterpret_cast<const float4*>(p4)[jr];
    sm.p[a] = q;
    sm.r2[a] = r2row[jr];
    sm.nn[a] = q.x * q.x + q.y * q.y + q.z * q.z;
    copy_vec<PP>(sm.u + a * PP, u + jr * PP);
    copy_vec<PP>(sm.v + a * PP, v + jr * PP);
  }
  __syncthreads();

  for (int b0 = 0; b0 < TILE; b0 += GROUP) {
    float px[GROUP], py[GROUP], pz[GROUP], ps[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const int b = b0 + g;
      const float4 q = sm.p[b];
      float d2;
      if (FAST) {
        const float g4 = r.p.x * q.x + r.p.y * q.y + r.p.z * q.z + r.p.w * q.w;
        d2 = fmaxf(r.nn + sm.nn[b] + (2.0f - 2.0f * g4), 0.0f);
      } else {
        const float dx = q.x - r.p.x;
        const float dy = q.y - r.p.y;
        const float dz = q.z - r.p.z;
        d2 = dx * dx + dy * dy + dz * dz;
      }
      const bool valid = d2 > 0.0f && d2 < sm.r2[b] && !(self && b == a);
      const float cij = dot<PP>(r.u, sm.v + b * PP);
      const float cji = dot<PP>(r.v, sm.u + b * PP);
      const PairParts parts = pair_parts<LAW>(d2, valid, pf);
      const float sij = directional_scale(parts, cij);
      // selected, not multiplied by the mask: a padded or invalid-ghost
      // row can sit on a real one, where a singular law's scale is inf
      const float sji = r.mask > 0.0f ? directional_scale(parts, cji) : 0.0f;
      acc[0] = fmaf(sij, q.x, acc[0]);
      acc[1] = fmaf(sij, q.y, acc[1]);
      acc[2] = fmaf(sij, q.z, acc[2]);
      acc[3] = fmaf(sij, q.w, acc[3]);
      px[g] = sji * r.p.x;
      py[g] = sji * r.p.y;
      pz[g] = sji * r.p.z;
      ps[g] = sji * r.p.w;
    }
    const float sx = warp_column_sums(px, lane);
    const float sy = warp_column_sums(py, lane);
    const float sz = warp_column_sums(pz, lane);
    const float ss = warp_column_sums(ps, lane);
    if (lane < GROUP) {
      const int col = b0 + column_of_lane(lane);
      sm.part[warp][0][col] = sx;
      sm.part[warp][1][col] = sy;
      sm.part[warp][2][col] = sz;
      sm.part[warp][3][col] = ss;
    }
  }
  __syncthreads();

  float bx = 0.0f, by = 0.0f, bz = 0.0f;
  if (!self) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] += sm.part[w][c][a];
    }
    const float4 q = sm.p[a];
    bx = s[0] - q.x * s[3];
    by = s[1] - q.y * s[3];
    bz = s[2] - q.z * s[3];
  }
  ob[a] = bx;
  ob[cstride + a] = by;
  ob[2 * cstride + a] = bz;
}

template <int LAW, bool FAST, int PP>
__global__ void __launch_bounds__(TILE)
mxu_kernel(const float* __restrict__ p4, const float* __restrict__ u,
           const float* __restrict__ v, const float* __restrict__ r2row,
           const float* __restrict__ imask, const int nt, const int kspan,
           float* __restrict__ out_a_part, float* __restrict__ out_b,
           const PairParams pf) {
  __shared__ MxuSmem<PP> sm;
  const int i = blockIdx.x;
  const int a = threadIdx.x;
  const size_t mp = static_cast<size_t>(nt) * TILE;
  const size_t row = static_cast<size_t>(i) * TILE + a;
  MxuRow<PP> r;
  r.p = reinterpret_cast<const float4*>(p4)[row];
  r.nn = r.p.x * r.p.x + r.p.y * r.p.y + r.p.z * r.p.z;
  r.mask = imask[row];
  load_vec<PP>(r.u, u + row * PP);
  load_vec<PP>(r.v, v + row * PP);
  const int nk = nt / 2 + 1;
  const int k0 = blockIdx.y * kspan;
  const int k1 = min(nk, k0 + kspan);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int k = k0; k < k1; ++k) {  // block-uniform control flow throughout
    const int j = (i + k) % nt;
    float* ob = out_b + static_cast<size_t>(k) * 3 * mp + static_cast<size_t>(j) * TILE;
    if (2 * k == nt && 2 * i >= nt) {  // even nt: the half diagonal once
      ob[a] = 0.0f;
      ob[mp + a] = 0.0f;
      ob[2 * mp + a] = 0.0f;
      continue;
    }
    mxu_tile_pair<LAW, FAST, PP>(sm, r, p4, u, v, r2row, j, k == 0, acc, ob,
                                 mp, pf);
  }
  float* oa = out_a_part + (static_cast<size_t>(blockIdx.y) * mp + row) * 3;
  oa[0] = acc[0] - r.p.x * acc[3];
  oa[1] = acc[1] - r.p.y * acc[3];
  oa[2] = acc[2] - r.p.z * acc[3];
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
