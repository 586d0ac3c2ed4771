// K1: column-sweep cell-list forces for Hopper (sm_90a).
//
// Replaces particle3d_tpu/ops/pallas_celllist.py::_kernel (launched there by
// `_call`) with the same operand contract, in both of its modes:
//
//   pos_d  f32[NCOL, 3, CS]    receiver positions, slot-minor, CS = nsc*cap
//   u_d    f32[NCOL, P, CS]    receiver features U (P = 8 or 16)
//   post_g f32[NSRC, 3, G]     ghosted source positions, G = (nsc+2)*cap
//   vt_g   f32[NSRC, P, G]     ghosted source features V
//   r2_g   f32[NSRC, 1, G]     per-source gate: r^2 for aligned occupants,
//                              -1 for empty or misplaced slots
//   out    f32[NCOL, 3, CS]    sum_j delta_ij * s(d2_ij, U_i . V_j)
//
// halo=false: NCOL = nsc^2 columns, the whole grid; NSRC = NCOL.
// halo=true (the slab decomposition, parallel/domain_sharded.py): the
// receivers are NCOL = k*nsc columns, k whole x-planes, and the sources
// NSRC = NCOL + 2*nsc columns, one x-plane of halo leading and one
// trailing. Walled boxes append one fully masked dummy column to the
// sources in both modes. Receiver slot zc*cap + i of column c sees the
// ghosted rows [zc*cap, (zc+3)*cap) of its 9 (x, y)-neighbour columns: the
// supercells zc-1..zc+1. Periodic images are per column: a neighbour that
// wrapped in y, or in x without the halo, gets one scalar +-w shift, and the
// z ghosts already carry shifted coordinates. In halo mode the x neighbour
// is the local source plane c/nsc + 1 + dx: it never wraps and gets no
// shift, because the caller ships the wraparound halo planes pre-shifted by
// +-w (or force-killed through r2 = -1 when walled). A walled box skips
// out-of-range neighbours, which is what reading the masked dummy column
// amounts to. Exact for nsc >= 3 (a window never holds a supercell and its
// own wrap-ghost copy); the wrapper enforces that.
//
// What bounds it. At the 262k production geometry (nsc 24, cap 32) every
// step evaluates 442,368 receivers x 864 candidates = 3.8e8 pairs of ~30
// FP32 operations: about 1.1e10 operations against ~50 MB of operands, so
// the sweep is bound by FP32 issue, not by device memory. Each block stages
// a 3*cap-row neighbour window once into shared memory and every one of its
// cap receivers reads it from there; each column is staged by the 9 blocks
// around it, all of which hit L2 after the first. That reuse keeps the
// kernel off device memory.
//
// Design: one block per receiver supercell (column c, z-cell zc), grid
// NCOL x nsc. Threads loop over the cap receiver slots, each holding x, y,
// z, U[P] and a float3 sum in registers. Source windows are staged in
// fixed-size chunks of CHUNK rows, so any cap fits. The coefficient is 8
// FP32 FMAs (no tensor cores). Each receiver sums its sources in a fixed
// order with no atomics: the result is deterministic.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

#include "pair_law.cuh"

namespace {

using p3t::PairParams;

constexpr int CHUNK = 256;        // source rows staged per pass
constexpr int MAX_THREADS = 256;  // receivers per block pass

template <int LAW, bool WRAP, bool HALO, int PP>
__global__ void __launch_bounds__(MAX_THREADS)
column_sweep_kernel(const float* __restrict__ pos_d, const float* __restrict__ u_d,
                    const float* __restrict__ post_g, const float* __restrict__ vt_g,
                    const float* __restrict__ r2_g, float* __restrict__ out,
                    const PairParams pf, const int nsc, const int cap) {
  __shared__ float sx[CHUNK], sy[CHUNK], sz[CHUNK], sr2[CHUNK];
  __shared__ float sv[PP][CHUNK];

  const int c = blockIdx.x;   // receiver column
  const int zc = blockIdx.y;  // receiver supercell within the column
  const int cs = nsc * cap;
  const int g = (nsc + 2) * cap;
  // x index of the column: a grid plane, or in halo mode the local source
  // plane of the receivers' own plane (sources lead with one halo plane)
  const int cx = c / nsc + (HALO ? 1 : 0);
  const int cy = c % nsc;
  const float w = pf.v[p3t::PF_W];
  const int win0 = zc * cap;  // ghosted window start
  const int wl = 3 * cap;     // window rows per neighbour column

  for (int rb = 0; rb < cap; rb += blockDim.x) {
    const int i = rb + threadIdx.x;
    const bool active = i < cap;
    const int slot = zc * cap + (active ? i : 0);
    const float* rp = pos_d + static_cast<size_t>(c) * 3 * cs;
    const float* ru = u_d + static_cast<size_t>(c) * PP * cs;
    const float xi = rp[slot];
    const float yi = rp[cs + slot];
    const float zi = rp[2 * cs + slot];
    float u[PP];
#pragma unroll
    for (int p = 0; p < PP; ++p) u[p] = ru[p * cs + slot];
    float ax = 0.0f, ay = 0.0f, az = 0.0f;

    // neighbour order (dx outer, dy inner) as pallas_celllist._OFFSETS9
    for (int nb = 0; nb < 9; ++nb) {
      int nx = cx + nb / 3 - 1;
      int ny = cy + nb % 3 - 1;
      float shx = 0.0f, shy = 0.0f;
      if (WRAP) {
        if (!HALO) {
          if (nx < 0) { nx += nsc; shx = -w; } else if (nx >= nsc) { nx -= nsc; shx = w; }
        }
        if (ny < 0) { ny += nsc; shy = -w; } else if (ny >= nsc) { ny -= nsc; shy = w; }
      } else if ((!HALO && (nx < 0 || nx >= nsc)) || ny < 0 || ny >= nsc) {
        continue;  // block-uniform: the dummy column would contribute nothing
      }
      const size_t col = static_cast<size_t>(nx) * nsc + ny;
      const float* px = post_g + col * 3 * g;
      const float* pv = vt_g + col * PP * g;
      const float* pr = r2_g + col * g;

      for (int base = 0; base < wl; base += CHUNK) {
        const int nrow = min(CHUNK, wl - base);
        __syncthreads();  // previous chunk fully consumed
        for (int r = threadIdx.x; r < nrow; r += blockDim.x) {
          const int gr = win0 + base + r;
          // own column: the shift is exactly 0.0 and x + 0.0f == x, so a
          // self pair's delta is exactly zero
          sx[r] = px[gr] + shx;
          sy[r] = px[g + gr] + shy;
          sz[r] = px[2 * g + gr];
          sr2[r] = pr[gr];
#pragma unroll
          for (int p = 0; p < PP; ++p) sv[p][r] = pv[p * g + gr];
        }
        __syncthreads();
        if (active) {
          for (int j = 0; j < nrow; ++j) {
            const float dx = sx[j] - xi;
            const float dy = sy[j] - yi;
            const float dz = sz[j] - zi;
            const float d2 = dx * dx + dy * dy + dz * dz;
            float coef = u[0] * sv[0][j];
#pragma unroll
            for (int p = 1; p < PP; ++p) coef = fmaf(u[p], sv[p][j], coef);
            const float s = p3t::gated_scale<LAW>(d2, d2 < sr2[j], coef, pf);
            ax = fmaf(dx, s, ax);
            ay = fmaf(dy, s, ay);
            az = fmaf(dz, s, az);
          }
        }
      }
    }
    if (active) {
      float* o = out + static_cast<size_t>(c) * 3 * cs;
      o[slot] = ax;
      o[cs + slot] = ay;
      o[2 * cs + slot] = az;
    }
  }
}

struct SweepLaunch {
  dim3 grid, block;
  cudaStream_t stream;
  const float *pos_d, *u_d, *post_g, *vt_g, *r2_g;
  float* out;
  PairParams pf;
  int nsc, cap;
  template <int LAW, bool WRAP, bool HALO, int PP>
  void run() const {
    column_sweep_kernel<LAW, WRAP, HALO, PP><<<grid, block, 0, stream>>>(
        pos_d, u_d, post_g, vt_g, r2_g, out, pf, nsc, cap);
  }
};

// Calls f.run<LAW, WRAP, HALO, P>() with compile-time constants; false when
// a value has no instantiation.
template <bool WRAP, bool HALO, int PP>
bool dispatch_law(int law, const SweepLaunch& f) {
  switch (law) {
    case p3t::PARTICLE_LIFE:
      f.run<p3t::PARTICLE_LIFE, WRAP, HALO, PP>();
      return true;
    case p3t::LENNARD_JONES:
      f.run<p3t::LENNARD_JONES, WRAP, HALO, PP>();
      return true;
    case p3t::GRAVITY:
      f.run<p3t::GRAVITY, WRAP, HALO, PP>();
      return true;
    case p3t::SPRING:
      f.run<p3t::SPRING, WRAP, HALO, PP>();
      return true;
    default:
      return false;
  }
}

template <int PP>
bool dispatch_modes(int law, bool wrap, bool halo, const SweepLaunch& f) {
  if (wrap) {
    return halo ? dispatch_law<true, true, PP>(law, f)
                : dispatch_law<true, false, PP>(law, f);
  }
  return halo ? dispatch_law<false, true, PP>(law, f)
              : dispatch_law<false, false, PP>(law, f);
}

}  // namespace

// Plain C entry point (loaded with ctypes). `params` points to the 14
// floats of pack_params in host memory; `ncol` is the receiver column count
// (nsc^2, or a multiple of nsc in halo mode) and `p` the feature width (8
// or 16). Returns cudaGetLastError() after the launch; 0 means the launch
// was accepted.
extern "C" int p3t_column_sweep(const float* pos_d, const float* u_d,
                                const float* post_g, const float* vt_g,
                                const float* r2_g, const float* params,
                                float* out, int law, int wrap, int halo,
                                int nsc, int cap, int ncol, int p,
                                void* stream) {
  if (nsc < 3 || cap < 1 || ncol < 1 || ncol % nsc != 0 ||
      (!halo && ncol != nsc * nsc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SweepLaunch f;
  std::memcpy(f.pf.v, params, sizeof(f.pf.v));
  f.grid = dim3(ncol, nsc);
  // one thread per receiver slot, whole warps, at most MAX_THREADS a pass
  f.block = dim3(std::min(MAX_THREADS, (cap + 31) / 32 * 32));
  f.stream = static_cast<cudaStream_t>(stream);
  f.pos_d = pos_d;
  f.u_d = u_d;
  f.post_g = post_g;
  f.vt_g = vt_g;
  f.r2_g = r2_g;
  f.out = out;
  f.nsc = nsc;
  f.cap = cap;
  bool ok = false;
  if (p == 8) ok = dispatch_modes<8>(law, wrap != 0, halo != 0, f);
  if (p == 16) ok = dispatch_modes<16>(law, wrap != 0, halo != 0, f);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
