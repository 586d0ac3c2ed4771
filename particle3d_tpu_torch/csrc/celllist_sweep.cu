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
//   out    f32[NCOL, 3, CS]    sum_j delta_ij * s(d2_ij, U_i . V_j) on every
//                              receiver slot whose own gate is > 0; exactly
//                              0 on the others (empty, misplaced, dead)
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
// own wrap-ghost copy); the wrapper enforces that. A receiver's own gate is
// r2_g[c, 0, cap + slot] (halo mode: column c + nsc, its own plane among the
// sources).
//
// What bounds it. The work is the live pairs: each live receiver against
// the live sources of its 27 neighbouring supercells, ~39 FP32 operations a
// pair (IEEE sqrt and divide included), far more than the operand bytes
// need: operations bound it. The layout holds more slots than particles:
// a supercell holds 19.0 particles on average at the 262k geometry (grid
// 24, cap 32) and 25.4 at 8M (grid 68, cap 64), so the first version of
// this kernel, which swept every slot pair, evaluated (cap / occupancy)^2 =
// 2.8x to 6.3x the live pairs. Its pair loop was 77 SASS instructions a
// pair, 12 of them scalar shared loads (one per operand) and ~17 the
// branches and convergence barriers of the IEEE sqrt and divide slow paths
// (chip run, cuobjdump; PERF.md). This version evaluates live pairs only, in
// a loop of 35 instructions a pair at P = 5 (1.5 float4 shared loads, 31
// FP32 operations, no branch but the loop's):
//
//  - Sources: each neighbour column's window is staged in stages of at most
//    256 rows (whole supercells, or pieces of one when cap > 256). A stage
//    is copied into shared memory with cp.async while the previous stage is
//    computed; each thread copies, and later compacts, its own two rows.
//    Compaction keeps the live rows (r2 > 0) in ascending slot order (warp
//    ballot and block prefix), each as one float4 {x+shx, y+shy, z, r2} and
//    its features as float4s, with per-supercell offsets so that the window
//    of each receiver supercell is one contiguous range. A dropped row
//    contributed fma(dx, 0, acc) = acc, and each receiver sums its sources
//    in the first version's order (neighbours dx outer, dy inner, rows
//    ascending): live rows keep their values to the bit.
//  - Receivers: a block serves `zr` supercells of one column (as the TPU
//    kernel's zr, pallas_celllist.py:87-98), about 448 slots, and shares
//    their staged windows; a grid under 1.5 waves of resident blocks is cut
//    finer. The live receivers are packed onto the lanes, R = 2 to a
//    thread, both of one supercell: one broadcast float4 load of a source
//    feeds two pairs. Idle lanes remain: a thread whose supercell holds an
//    odd count carries one idle receiver, and lanes of one warp serving
//    neighbouring supercells run ranges of different lengths. That share is
//    0.262 at 262k and 0.214 at 8M: a model, not a device count, that
//    chip_smoke.py computes from the run's occupancy and the geometry
//    p3t_column_sweep_geometry reports (PERF.md).
//  - Occupancy: 72 registers and 27.6 KB of shared memory at P = 8 let 7
//    blocks (28 warps) stay resident on an SM; the loads of the next stage
//    wait in cp.async, not in registers.
//  - Particle life's sqrt and reciprocal run the fast paths of nvcc's IEEE
//    forms without their slow-path branches (pair_law.cuh's gated_scale):
//    they round exactly as sqrtf and 1.0f / d on the law's d range.
//    Branch-free, a thread's two receivers interleave.
//  - The coefficient U . V runs over the live feature columns only: each
//    block finds the last column its receivers' U holds nonzero (5 for
//    five-species particle life, 12 for twelve) and runs the unrolled loop
//    instantiated for the next width of {1, 2, 5, 8} (P = 8) or {12, 16}
//    (P = 16). A skipped column holds 0 in every receiver's U, so it adds
//    exactly 0.
//  - No tensor cores: the coefficient is a rank-P product with P <= 16, and
//    TF32 would cost the accuracy gate. Each receiver sums in a fixed order
//    with no atomics on the sums: reruns are bit-identical.
//
// What is left: 14-16% of the FP32 bound at 262k and 8M (PERF.md). A
// quarter of the lane slots is idle, and the loop's dependent chains (two
// receivers a thread; rsqrt, reciprocal and the sums) are covered only by
// the warps of 7 resident blocks, some of them without receivers.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

#include "pair_law.cuh"

namespace {

using p3t::PairParams;

constexpr int THREADS = 128;                // threads per block
constexpr int WARPS = THREADS / 32;
constexpr int R = 2;                        // receivers per thread
constexpr int STAGE_ROWS = 2 * THREADS;     // source rows per stage, two a thread
constexpr int BLOCK_SLOTS = 512;            // receiver slots per block at most
constexpr int SLOTS_TARGET = 448;           // receiver slots per block aimed at
constexpr int ZR_MAX = 64;                  // receiver supercells per block at most
constexpr int RECV_ROUNDS = BLOCK_SLOTS / THREADS;

// Resident blocks per SM the register budget is set for: 7 blocks of 28 KB
// of shared memory fit an SM at P = 8 (72 registers a thread); P = 16
// holds twice the features in registers
template <int PP>
constexpr int blocks_per_sm() { return PP == 8 ? 7 : 4; }

template <int PP>
struct SweepSmem {
  float4 pos[STAGE_ROWS];         // live source rows {x + shx, y + shy, z, r2}
  float4 v[PP / 4][STAGE_ROWS];   // their features, four columns a float4
  float raw[4 + PP][STAGE_ROWS];  // the next stage as loaded: x, y, z, r2, V
  int off[ZR_MAX + 3];            // packed index of each stage supercell's first row
  int rlist[BLOCK_SLOTS];         // live receiver slots, ascending
  int roff[ZR_MAX + 1];           // first rlist entry of each receiver supercell
  int tfirst[ZR_MAX + 1];         // first task (thread) of each receiver supercell
  int wcount[RECV_ROUNDS * WARPS];  // live items per warp and round (block scans)
  int nbcol[9];                   // source column of each used (x, y) neighbour
  float nbsx[9], nbsy[9];         // its periodic image shifts
  int nnb;                        // used neighbours (walled boxes skip some)
  int width;                      // live feature columns of the block's receivers
};

// Exclusive position of each live item among the block's live items, items
// ordered by round k, then warp, then lane; returns the live count. One
// __syncthreads; the caller syncs again before `wcount` is rewritten.
template <int K>
__device__ __forceinline__ int block_scan(const bool (&live)[K], int (&pos)[K],
                                          int* wcount) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned bal[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bal[k] = __ballot_sync(0xffffffffu, live[k]);
    if (lane == 0) wcount[k * WARPS + warp] = __popc(bal[k]);
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  int acc = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    for (int w = 0; w < WARPS; ++w) {
      if (w == warp) pos[k] = acc + __popc(bal[k] & below);
      acc += wcount[k * WARPS + w];
    }
  }
  return acc;
}

// 4-byte asynchronous copy global -> shared (sm_80+): the copy runs while
// the thread goes on computing; cp.async.wait_all waits for the thread's own
// copies
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// One stage: window supercells [s0, s1), its first window row and its rows,
// and the image shifts of its neighbour column.
struct Stage {
  int s0, s1, r0, nrows;
  float shx, shy;
};

// One pass of a block: its receiver tasks [t0, t0 + THREADS) against every
// stage of every used neighbour column, with the coefficient over PL columns.
template <int LAW, bool HALO, int PP, int PL>
__device__ __forceinline__ void sweep_pass(
    SweepSmem<PP>& sm, const float* __restrict__ rp, const float* __restrict__ ru,
    float* __restrict__ o, const float* __restrict__ post_g,
    const float* __restrict__ vt_g, const float* __restrict__ r2_g,
    const PairParams& pf, const int cs, const int g, const int cap,
    const int z0, const int nz, const int t0) {
  constexpr int PLQ = (PL + 3) / 4;
  const int tid = threadIdx.x;
  const int task = t0 + tid;
  const bool has = task < sm.tfirst[nz];

  // the thread's receivers: R consecutive live slots of one supercell
  int zl = 0;
  int slot[R];
  bool ok[R];
  float xi[R], yi[R], zi[R], u[R][PL];
  float ax[R], ay[R], az[R];
  if (has) {
    while (sm.tfirst[zl + 1] <= task) ++zl;
  }
  const int first = sm.roff[zl] + (task - sm.tfirst[zl]) * R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ok[r] = has && first + r < sm.roff[zl + 1];
    slot[r] = has ? sm.rlist[ok[r] ? first + r : first] : 0;
    xi[r] = rp[slot[r]];
    yi[r] = rp[cs + slot[r]];
    zi[r] = rp[2 * cs + slot[r]];
#pragma unroll
    for (int p = 0; p < PL; ++p) u[r][p] = ru[p * cs + slot[r]];
    ax[r] = ay[r] = az[r] = 0.0f;
  }

  // stages: whole supercells of the (nz + 2)-supercell window, balanced,
  // or pieces of one supercell when cap > STAGE_ROWS
  const int wsc = nz + 2;
  int spb = 1, pieces = 1, nstage;
  if (cap <= STAGE_ROWS) {
    const int smax = min(STAGE_ROWS / cap, wsc);
    nstage = (wsc + smax - 1) / smax;
    spb = (wsc + nstage - 1) / nstage;
  } else {
    pieces = (cap + STAGE_ROWS - 1) / STAGE_ROWS;
    nstage = wsc * pieces;
  }
  const int nst = sm.nnb * nstage;
  const int win0 = z0 * cap;  // ghosted row of the window's first row

  // stage k: its bounds, and every thread's two rows copied into sm.raw
  // asynchronously (a thread copies and later compacts only its own rows,
  // so sm.raw needs no barrier)
  Stage sg;
  auto load = [&](const int k) {
    const int nbi = k / nstage;
    const int st = k - nbi * nstage;
    if (pieces == 1) {
      sg.s0 = st * spb;
      sg.s1 = min(sg.s0 + spb, wsc);
      sg.r0 = sg.s0 * cap;
      sg.nrows = (sg.s1 - sg.s0) * cap;
    } else {
      sg.s0 = st / pieces;
      sg.s1 = sg.s0 + 1;
      const int piece = st - sg.s0 * pieces;
      sg.r0 = sg.s0 * cap + piece * STAGE_ROWS;
      sg.nrows = min(STAGE_ROWS, cap - piece * STAGE_ROWS);
    }
    sg.shx = sm.nbsx[nbi];
    sg.shy = sm.nbsy[nbi];
    const size_t col = static_cast<size_t>(sm.nbcol[nbi]);
    const float* px = post_g + col * 3 * g;
    const float* pv = vt_g + col * PP * g;
    const float* pr = r2_g + col * g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = tid + h * THREADS;
      if (rr < sg.nrows) {
        const int gr = win0 + sg.r0 + rr;
        copy_async(&sm.raw[0][rr], px + gr);
        copy_async(&sm.raw[1][rr], px + g + gr);
        copy_async(&sm.raw[2][rr], px + 2 * g + gr);
        copy_async(&sm.raw[3][rr], pr + gr);
#pragma unroll
        for (int p = 0; p < PL; ++p) copy_async(&sm.raw[4 + p][rr], pv + p * g + gr);
      }
    }
  };
  int cur_s0 = 0, cur_s1 = 0;
  auto compact = [&]() {
    copy_async_wait();
    bool live[2];
    int at[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = tid + h * THREADS;
      live[h] = rr < sg.nrows && sm.raw[3][rr] > 0.0f;
    }
    const int total = block_scan<2>(live, at, sm.wcount);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = tid + h * THREADS;
      if (live[h]) {
        // own column: the shift is exactly 0.0 and x + 0.0f == x, so a
        // self pair's delta is exactly zero
        sm.pos[at[h]] = make_float4(sm.raw[0][rr] + sg.shx, sm.raw[1][rr] + sg.shy,
                                    sm.raw[2][rr], sm.raw[3][rr]);
#pragma unroll
        for (int q = 0; q < PLQ; ++q) {
          float e[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) e[i] = 4 * q + i < PL ? sm.raw[4 + 4 * q + i][rr] : 0.0f;
          sm.v[q][at[h]] = make_float4(e[0], e[1], e[2], e[3]);
        }
      }
      if (rr > 0 && rr < sg.nrows && (sg.r0 + rr) % cap == 0) {
        sm.off[(sg.r0 + rr) / cap - sg.s0] = at[h];
      }
    }
    if (tid == 0) {
      sm.off[0] = 0;
      sm.off[sg.s1 - sg.s0] = total;
    }
    cur_s0 = sg.s0;
    cur_s1 = sg.s1;
    __syncthreads();
  };

  load(0);
  compact();
  for (int k = 0; k < nst; ++k) {
    const int s0 = cur_s0;
    const int s1 = cur_s1;
    if (k + 1 < nst) load(k + 1);
    // receiver supercell zl sees window supercells zl..zl+2
    const int a = max(zl, s0);
    const int b = min(zl + 3, s1);
    if (has && a < b) {
      const int hi = sm.off[b - s0];
      for (int j = sm.off[a - s0]; j < hi; ++j) {
        const float4 q = sm.pos[j];
        float vv[PLQ * 4];
#pragma unroll
        for (int c4 = 0; c4 < PLQ; ++c4) {
          const float4 t = sm.v[c4][j];
          vv[4 * c4] = t.x;
          vv[4 * c4 + 1] = t.y;
          vv[4 * c4 + 2] = t.z;
          vv[4 * c4 + 3] = t.w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float dx = q.x - xi[r];
          const float dy = q.y - yi[r];
          const float dz = q.z - zi[r];
          const float d2 = dx * dx + dy * dy + dz * dz;
          float coef = u[r][0] * vv[0];
#pragma unroll
          for (int p = 1; p < PL; ++p) coef = fmaf(u[r][p], vv[p], coef);
          const float s = p3t::gated_scale<LAW>(d2, d2 < q.w, coef, pf);
          ax[r] = fmaf(dx, s, ax[r]);
          ay[r] = fmaf(dy, s, ay[r]);
          az[r] = fmaf(dz, s, az[r]);
        }
      }
    }
    if (k + 1 < nst) compact();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (ok[r]) {
      o[slot[r]] = ax[r];
      o[cs + slot[r]] = ay[r];
      o[2 * cs + slot[r]] = az[r];
    }
  }
}

// One block per (column c, z-block): the receiver slots [s_lo, s_hi) of zr
// supercells (or, when cap > BLOCK_SLOTS, one BLOCK_SLOTS piece of a
// supercell; nsub pieces a supercell).
template <int LAW, bool WRAP, bool HALO, int PP>
__global__ void __launch_bounds__(THREADS, blocks_per_sm<PP>())
column_sweep_kernel(const float* __restrict__ pos_d, const float* __restrict__ u_d,
                    const float* __restrict__ post_g, const float* __restrict__ vt_g,
                    const float* __restrict__ r2_g, float* __restrict__ out,
                    const PairParams pf, const int nsc, const int cap,
                    const int zr, const int nsub) {
  __shared__ SweepSmem<PP> sm;
  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int cs = nsc * cap;
  const int g = (nsc + 2) * cap;
  const int z0 = static_cast<int>(blockIdx.y) / nsub * zr;
  const int nz = min(zr, nsc - z0);
  const int s_lo = z0 * cap + static_cast<int>(blockIdx.y) % nsub * BLOCK_SLOTS;
  const int s_hi = nsub == 1 ? (z0 + nz) * cap
                             : min(s_lo + BLOCK_SLOTS, (z0 + 1) * cap);
  const float* rp = pos_d + static_cast<size_t>(c) * 3 * cs;
  const float* ru = u_d + static_cast<size_t>(c) * PP * cs;
  // own gate, indexed by receiver slot (past the leading z ghost)
  const float* own = r2_g + static_cast<size_t>(HALO ? c + nsc : c) * g + cap;
  float* o = out + static_cast<size_t>(c) * 3 * cs;

  // live receivers: compact them, zero the dead slots, find the live width
  if (tid == 0) sm.width = 1;
  bool live[RECV_ROUNDS];
  int at[RECV_ROUNDS];
  int width = 0;
#pragma unroll
  for (int k = 0; k < RECV_ROUNDS; ++k) {
    const int slot = s_lo + k * THREADS + tid;
    const bool in = slot < s_hi;
    live[k] = in && own[slot] > 0.0f;
    if (in && !live[k]) {
      o[slot] = 0.0f;
      o[cs + slot] = 0.0f;
      o[2 * cs + slot] = 0.0f;
    }
    if (live[k]) {
#pragma unroll
      for (int p = 0; p < PP; ++p) {
        if (ru[p * cs + slot] != 0.0f) width = p + 1;
      }
    }
  }
  const int total = block_scan<RECV_ROUNDS>(live, at, sm.wcount);
  if (width > 1) atomicMax(&sm.width, width);
#pragma unroll
  for (int k = 0; k < RECV_ROUNDS; ++k) {
    const int slot = s_lo + k * THREADS + tid;
    if (live[k]) sm.rlist[at[k]] = slot;
    if (slot > s_lo && slot < s_hi && slot % cap == 0) sm.roff[slot / cap - z0] = at[k];
  }
  if (tid == 0) {
    sm.roff[0] = 0;
    sm.roff[nz] = total;
  }
  __syncthreads();
  if (total == 0) return;  // block-uniform: every slot was zeroed above
  if (tid == 0) {
    sm.tfirst[0] = 0;
    for (int zl = 0; zl < nz; ++zl) {
      sm.tfirst[zl + 1] = sm.tfirst[zl] + (sm.roff[zl + 1] - sm.roff[zl] + R - 1) / R;
    }
    // neighbour order (dx outer, dy inner) as pallas_celllist._OFFSETS9
    const int cx = c / nsc + (HALO ? 1 : 0);  // halo: the local source plane
    const int cy = c % nsc;
    const float w = pf.v[p3t::PF_W];
    int n = 0;
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
        continue;  // the dummy column would contribute nothing
      }
      sm.nbcol[n] = nx * nsc + ny;
      sm.nbsx[n] = shx;
      sm.nbsy[n] = shy;
      ++n;
    }
    sm.nnb = n;
  }
  __syncthreads();
  const int ntask = sm.tfirst[nz];
  const int wd = sm.width;
  for (int t0 = 0; t0 < ntask; t0 += THREADS) {  // block-uniform passes
    if constexpr (PP == 8) {
      if (wd <= 1) {
        sweep_pass<LAW, HALO, PP, 1>(sm, rp, ru, o, post_g, vt_g, r2_g, pf, cs, g, cap, z0, nz, t0);
      } else if (wd <= 2) {
        sweep_pass<LAW, HALO, PP, 2>(sm, rp, ru, o, post_g, vt_g, r2_g, pf, cs, g, cap, z0, nz, t0);
      } else if (wd <= 5) {
        sweep_pass<LAW, HALO, PP, 5>(sm, rp, ru, o, post_g, vt_g, r2_g, pf, cs, g, cap, z0, nz, t0);
      } else {
        sweep_pass<LAW, HALO, PP, 8>(sm, rp, ru, o, post_g, vt_g, r2_g, pf, cs, g, cap, z0, nz, t0);
      }
    } else {
      if (wd <= 12) {
        sweep_pass<LAW, HALO, PP, 12>(sm, rp, ru, o, post_g, vt_g, r2_g, pf, cs, g, cap, z0, nz, t0);
      } else {
        sweep_pass<LAW, HALO, PP, 16>(sm, rp, ru, o, post_g, vt_g, r2_g, pf, cs, g, cap, z0, nz, t0);
      }
    }
  }
}

struct SweepLaunch {
  dim3 grid, block;
  cudaStream_t stream;
  const float *pos_d, *u_d, *post_g, *vt_g, *r2_g;
  float* out;
  PairParams pf;
  int nsc, cap, zr, nsub;
  template <int LAW, bool WRAP, bool HALO, int PP>
  void run() const {
    column_sweep_kernel<LAW, WRAP, HALO, PP><<<grid, block, 0, stream>>>(pos_d, u_d, post_g, vt_g, r2_g, out, pf, nsc, cap, zr, nsub);
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

// Block geometry of a launch: zr receiver supercells a z-block, nsub blocks
// a supercell (cap > BLOCK_SLOTS), nzb z-blocks a column. About
// SLOTS_TARGET receiver slots a block, balanced over the column. A grid of
// under 1.5 waves of resident blocks is split further: its last wave would
// leave most SMs idle (262k at grid 24: 2 z-blocks make 1.25 waves on an
// H100, 3 make 1.87)
void block_geometry(int nsc, int cap, int ncol, int p, int* zr, int* nsub,
                    int* nzb) {
  *zr = 1;
  *nsub = 1;
  if (cap > BLOCK_SLOTS) {
    *nsub = (cap + BLOCK_SLOTS - 1) / BLOCK_SLOTS;
    *nzb = nsc * *nsub;
    return;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long resident =
      static_cast<long>(sms) * (p == 8 ? blocks_per_sm<8>() : blocks_per_sm<16>());
  const int zr_max = std::min(ZR_MAX, std::max(1, SLOTS_TARGET / cap));
  int nblk = (nsc + zr_max - 1) / zr_max;
  while (nblk < nsc && 2L * ncol * nblk < 3 * resident) ++nblk;
  *zr = (nsc + nblk - 1) / nblk;
  *nzb = (nsc + *zr - 1) / *zr;
}

}  // namespace

// The geometry p3t_column_sweep launches with on the current device:
// out = {zr, nsub, nzb, threads a block, receivers a thread}.
extern "C" void p3t_column_sweep_geometry(int nsc, int cap, int ncol, int p,
                                          int* out) {
  block_geometry(nsc, cap, ncol, p, &out[0], &out[1], &out[2]);
  out[3] = THREADS;
  out[4] = R;
}

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
  int zr, nsub, nzb;
  block_geometry(nsc, cap, ncol, p, &zr, &nsub, &nzb);
  f.grid = dim3(ncol, nzb);
  f.block = dim3(THREADS);
  f.stream = static_cast<cudaStream_t>(stream);
  f.pos_d = pos_d;
  f.u_d = u_d;
  f.post_g = post_g;
  f.vt_g = vt_g;
  f.r2_g = r2_g;
  f.out = out;
  f.nsc = nsc;
  f.cap = cap;
  f.zr = zr;
  f.nsub = nsub;
  bool ok = false;
  if (p == 8) ok = dispatch_modes<8>(law, wrap != 0, halo != 0, f);
  if (p == 16) ok = dispatch_modes<16>(law, wrap != 0, halo != 0, f);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
