// The triangular tile-pair sweep that K2 (allpairs_sweep.cu, tri_kernel) and
// K5 (allpairs_mxu.cu, mxu_kernel) share, designed for Hopper's warps and
// tensor cores.
//
// One block of 4 warps takes receiver tile i and a span of steps k; each
// step sweeps the unordered tile pair (i, j = (i + k) mod nt) of TILE x TILE
// rows. Per pair it needs two rank-1 coefficients, c_ij = U_i . V_j for
// the i-side and c_ji = V_i . U_j for the j-side, and the law.
//
//   Coefficients on tensor cores. A warp owns MT m-tiles of 16 receiver
//   rows and walks the source tile in n-tiles of 8 columns. Per (m-tile,
//   n-tile) it forms C = U_i V_j^T and C' = V_i U_j^T with
//   mma.sync.m16n8k8 in TF32, split 3xTF32: a = hi + lo with
//   cvt.rna.tf32.f32, C = lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), summed in
//   FP32 (plain TF32's ~5e-4 relative error on a coefficient would break
//   the kernels' 1e-5 gates). The receiver tile is split once per block into
//   A fragments held in registers; the source tile is split once per row as
//   it is staged, in the B fragments' own order, so that one LDS.128 a
//   thread serves a whole n-tile for every m-tile of the warp.
//
//   Pairs in the accumulator layout. C and C' arrive in the same m16n8
//   fragment: lane (g, t) = (lane >> 2, lane & 3) holds c_ij and c_ji of
//   rows g and g + 8 and columns 2t and 2t + 1, and evaluates those four
//   pairs itself from positions in registers (its receiver rows, loaded once
//   a block) and in shared memory (its two source columns, two LDS.128 an
//   n-tile serving 4 MT pairs).
//
//   Lane sums deferred. The i-side sums stay in registers across the n-tiles
//   and the whole k-span and are reduced over the quad's 4 lanes once, at the
//   end. A column's j-side partial accumulates over the warp's MT m-tiles in
//   registers and is then reduced over the 8 lanes that share the column by
//   recursive halving (7 shuffles for 8 values: 2 columns x up to 4
//   components), then over the warps in shared memory in a fixed order. Each
//   (k, j) block of out_b is written exactly once; no float atomics, so a
//   rerun is bit-identical.
//
// Per thread and n-tile at MT = 2: 8 pairs, 4 LDS.128 (plus one for K5's
// gates and norms), 7 shuffles and 12 HMMA at P = 8, against K2's former 5
// broadcast loads and 3.4 shuffles (K5: 6 and 4.5) a pair.
//
// What bounds it: arithmetic throughput in principle (~44 FP32 operations
// a pair besides the coefficients; utils/bounds.py), but on the H100 it
// runs at about 70% of what its SASS count allows (particle life, P = 8:
// 48 instructions a pair for K2, 128 registers, 4 blocks an SM), and its
// time barely follows the instruction count, so latency is what is left:
// each n-tile opens with a chain of dependent HMMA and closes with a chain
// of shuffles. Measured against this shape and not faster (PERF.md
// section 6): 4 m-tiles a warp, the n-tile loop unrolled by 2, register
// caps for 5 or 6 blocks an SM (all spill or lose blocks), and the next
// n-tile's products issued before this one's shuffles.
//
// Modes (`PairMode`), as the Pallas kernels form geometry and sums:
//   K2_WRAP   box units, dx - rint(dx), gate 1e-12 < d2 < r2row, d2 scaled
//             by w^2 for the law; direct sums delta * s; results times w
//   K2_WALLS  world units, gate 0 < d2 < r2row; direct sums
//   K5_EXACT  world units, plain deltas, gate 0 < d2 < r2row; factored sums
//             A = sum_j s_ij [p_j | 1], fixed up as A[:3] - p_i A[3]
//   K5_FAST   d2 from the Gram form |p_i|^2 + |p_j|^2 + 2 - 2 p4_i . p4_j
//             (FP32 FFMA), clamped at 0; factored sums
// Guards kept from `_tri_body` / `_mxu_kernel`: the k = 0 diagonal is
// one-sided and its j-side written as 0 (K5 also masks its index diagonal);
// for even nt the k = nt/2 step runs only for i < nt/2; receiver rows whose
// imask is 0 are selected out of the j-side (a padded row at the origin
// has an infinite scale under a singular law, and inf * 0 is NaN); K2's
// optional bit mask skips steps; K5 skips tile pairs with a dead tile (every
// row's imask 0, found by a block-wide vote on the tile's imask, with no
// extra operand and no host sync), so rows < N lose only the (near-)zero
// terms of particle life's parked invalid-ghost pairs. A skipped step writes
// zeros to its out_b block.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "tile_sweep.cuh"

namespace p3t {

enum PairMode : int { K2_WRAP = 0, K2_WALLS = 1, K5_EXACT = 2, K5_FAST = 3 };

template <int MODE>
struct Mode {
  static constexpr bool BOX = MODE == K2_WRAP;
  static constexpr bool FACTORED = MODE == K5_EXACT || MODE == K5_FAST;
  static constexpr bool GRAM = MODE == K5_FAST;
  static constexpr int NC = FACTORED ? 4 : 3;  // components of a side's sum
  // K2's periodic gate keeps d2 >= 1e-12 w^2; the others only d2 > 0
  static constexpr int ROOTS = BOX ? FAST_ROOTS : FAST_ROOTS_SCALED;
};

constexpr int MT = 2;                              // m-tiles a warp owns
constexpr int WARP_ROWS = TILE / (16 * MT);        // warps along the rows
constexpr int WARP_COLS = WARPS / WARP_ROWS;       // warps along the columns
constexpr int NB_WARP = TILE / 8 / WARP_COLS;      // n-tiles a warp walks
constexpr int PART_STRIDE = TILE + 8;              // conflict-free column sums
static_assert(WARP_ROWS * WARP_COLS == WARPS && WARP_COLS <= WARP_ROWS,
              "MT must tile the warps");

// ------------------------------------------------ TF32 tensor-core steps

// cvt.rna.tf32.f32: x rounded to TF32 (10 mantissa bits, ties away from 0)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
#elif defined(P3T_CUDA_EMULATION)
  return emu_cvt_rna_tf32(x);
#else
  return 0u;
#endif
}

__device__ __forceinline__ float tf32_value(uint32_t bits) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(bits);
#else
  float f;
  std::memcpy(&f, &bits, sizeof f);
  return f;
#endif
}

__device__ __forceinline__ uint32_t float_bits(float x) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(x);
#else
  uint32_t b;
  std::memcpy(&b, &x, sizeof b);
  return b;
#endif
}

// d += A B for one warp: A 16x8 (row), B 8x8 (col), TF32 in, FP32 out, in
// the PTX fragment layouts of mma.m16n8k8.tf32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#if defined(__CUDA_ARCH__)
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#elif defined(P3T_CUDA_EMULATION)
  emu_mma_m16n8k8_tf32(d, a, b);
#endif
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - tf32_value(hi));
}

// c = A B over KS k-steps of 8, 3xTF32; [.][0] hi, [.][1] lo; small terms
// first
template <int KS>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a)[KS][2][4],
                                           const uint32_t (&b)[KS][2][2]) {
  c[0] = c[1] = c[2] = c[3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    mma_tf32(c, a[ks][1], b[ks][0]);
    mma_tf32(c, a[ks][0], b[ks][1]);
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) mma_tf32(c, a[ks][0], b[ks][0]);
}

// Sums x[s] over the 8 lanes that share lane & 3 (lanes t, t + 4, ..,
// t + 28) for each of 8 slots, in a fixed order: three rounds of recursive
// halving (xor 4, 8, 16). Lane l ends with the total of slot
// `group_slot(l)`.
__device__ __forceinline__ float lane_group_sums(const float (&x)[8],
                                                 const int lane) {
  const bool b0 = lane & 4;
  float y[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float send = b0 ? x[c] : x[c + 4];
    const float keep = b0 ? x[c + 4] : x[c];
    y[c] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  const bool b1 = lane & 8;
  float z[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float send = b1 ? y[c] : y[c + 2];
    const float keep = b1 ? y[c + 2] : y[c];
    z[c] = keep + __shfl_xor_sync(FULL, send, 8);
  }
  const bool b2 = lane & 16;
  return (b2 ? z[1] : z[0]) + __shfl_xor_sync(FULL, b2 ? z[0] : z[1], 16);
}

__device__ __forceinline__ int group_slot(const int lane) {
  return ((lane >> 2) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 4) & 1);
}

// ------------------------------------------------------ operands

template <int PP>
struct PairSmem {
  float4 p[TILE];  // source rows: x, y, z and r2 (K2) or the ones column (K5)
  float2 q[TILE];  // K5: r2 and |p|^2
  // B fragments, [k-step][row][t] = (hi of column 8ks + t, hi of 8ks + t + 4,
  // lo of the same two)
  float4 u[PP / 8][TILE][4];
  float4 v[PP / 8][TILE][4];
  float part[WARP_ROWS][4][PART_STRIDE];  // column sums; i-side at the end
};

template <int PP>
__device__ __forceinline__ void stage_fragments(float4 (&dst)[PP / 8][TILE][4],
                                                const float* src, const int a) {
  float x[PP];
  load_vec<PP>(x, src);
#pragma unroll
  for (int ks = 0; ks < PP / 8; ++ks) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t h0, l0, h1, l1;
      split_tf32(x[8 * ks + t], h0, l0);
      split_tf32(x[8 * ks + t + 4], h1, l1);
      dst[ks][a][t] = make_float4(tf32_value(h0), tf32_value(h1),
                                  tf32_value(l0), tf32_value(l1));
    }
  }
}

template <int KS>
__device__ __forceinline__ void load_b(uint32_t (&b)[KS][2][2],
                                       const float4 (&src)[KS][TILE][4],
                                       const int col, const int t) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const float4 f = src[ks][col][t];
    b[ks][0][0] = float_bits(f.x);
    b[ks][0][1] = float_bits(f.y);
    b[ks][1][0] = float_bits(f.z);
    b[ks][1][1] = float_bits(f.w);
  }
}

// A thread's receiver rows (rows g and g + 8 of each of its warp's MT
// m-tiles), loaded once a block
template <int PP>
struct Receivers {
  float x[MT][2], y[MT][2], z[MT][2];
  float one[MT][2], nn[MT][2];  // K5: the ones column and |p|^2
  bool live[MT][2];             // imask > 0
  uint32_t ua[MT][PP / 8][2][4], va[MT][PP / 8][2][4];  // A fragments
};

template <int MODE, int PP>
__device__ __forceinline__ void load_receivers(
    Receivers<PP>& r, const float* __restrict__ pos, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ imask,
    const size_t row0, const int g, const int t) {
#pragma unroll
  for (int mb = 0; mb < MT; ++mb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = row0 + mb * 16 + g + 8 * h;
      if (Mode<MODE>::FACTORED) {
        const float4 q = reinterpret_cast<const float4*>(pos)[row];
        r.x[mb][h] = q.x;
        r.y[mb][h] = q.y;
        r.z[mb][h] = q.z;
        r.one[mb][h] = q.w;
        r.nn[mb][h] = q.x * q.x + q.y * q.y + q.z * q.z;
      } else {
        r.x[mb][h] = pos[3 * row];
        r.y[mb][h] = pos[3 * row + 1];
        r.z[mb][h] = pos[3 * row + 2];
      }
      r.live[mb][h] = imask[row] > 0.0f;
    }
#pragma unroll
    for (int ks = 0; ks < PP / 8; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a_e: row g + 8 (e & 1), k t + 4 (e >> 1)
        const size_t off = (row0 + mb * 16 + g + 8 * (e & 1)) * PP + 8 * ks +
                           t + 4 * (e >> 1);
        split_tf32(u[off], r.ua[mb][ks][0][e], r.ua[mb][ks][1][e]);
        split_tf32(v[off], r.va[mb][ks][0][e], r.va[mb][ks][1][e]);
      }
    }
  }
}

// ------------------------------------------------------ one tile pair

// The warp's share of one staged tile pair: adds the i-side to acc and
// leaves each column's j-side sum over the warp's rows in sm.part[wr]
// (none when SELF, the one-sided k = 0 diagonal)
template <int LAW, int MODE, int PP, bool SELF>
__device__ __forceinline__ void sweep_tile_pair(PairSmem<PP>& sm,
                                                const Receivers<PP>& r,
                                                float (&acc)[MT][2][4],
                                                const int wr, const int wc,
                                                const int lane,
                                                const PairParams& pf) {
  using M = Mode<MODE>;
  constexpr int KS = PP / 8;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float w = pf.v[PF_W];
  const float w2 = w * w;
  const int rbase = wr * MT * 16 + g;  // receiver row of (mb, h): + 16 mb + 8 h

#pragma unroll 1
  for (int nn = 0; nn < NB_WARP; ++nn) {
    const int nb = wc * NB_WARP + nn;
    uint32_t vb[KS][2][2], ub[KS][2][2];
    load_b<KS>(vb, sm.v, nb * 8 + g, t);
    if (!SELF) load_b<KS>(ub, sm.u, nb * 8 + g, t);
    const int c0 = nb * 8 + 2 * t;
    const float4 src[2] = {sm.p[c0], sm.p[c0 + 1]};
    float4 gate = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // K5: r2, nn of both
    if (M::FACTORED) gate = *reinterpret_cast<const float4*>(&sm.q[c0]);
    float jp[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};

#pragma unroll
    for (int mb = 0; mb < MT; ++mb) {
      float cij[4], cji[4];
      mma_3xtf32<KS>(cij, r.ua[mb], vb);
      if (!SELF) mma_3xtf32<KS>(cji, r.va[mb], ub);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // row g + 8 h, column c0 + cc
        const int h = e >> 1;
        const int cc = e & 1;
        const float4 s = src[cc];
        const float rx = r.x[mb][h], ry = r.y[mb][h], rz = r.z[mb][h];
        float dx = 0.0f, dy = 0.0f, dz = 0.0f, d2;
        if (M::GRAM) {
          const float snn = cc ? gate.w : gate.y;
          const float g4 = rx * s.x + ry * s.y + rz * s.z + r.one[mb][h] * s.w;
          d2 = fmaxf(r.nn[mb][h] + snn + (2.0f - 2.0f * g4), 0.0f);
        } else {
          dx = s.x - rx;
          dy = s.y - ry;
          dz = s.z - rz;
          if (M::BOX) {
            dx = dx - rintf(dx);
            dy = dy - rintf(dy);
            dz = dz - rintf(dz);
          }
          d2 = dx * dx + dy * dy + dz * dz;
        }
        const float r2 = M::FACTORED ? (cc ? gate.z : gate.x) : s.w;
        bool valid = d2 > (M::BOX ? 1e-12f : 0.0f) && d2 < r2;
        if (SELF && M::FACTORED) valid = valid && rbase + 16 * mb + 8 * h != c0 + cc;
        if (M::BOX) d2 = d2 * w2;
        const PairParts parts = pair_parts<LAW, M::ROOTS>(d2, valid, pf);
        const float sij = directional_scale(parts, cij[e]);
        float* a = acc[mb][h];
        if (M::FACTORED) {
          a[0] = fmaf(sij, s.x, a[0]);
          a[1] = fmaf(sij, s.y, a[1]);
          a[2] = fmaf(sij, s.z, a[2]);
          a[3] = fmaf(sij, s.w, a[3]);
        } else {
          a[0] = fmaf(dx, sij, a[0]);
          a[1] = fmaf(dy, sij, a[1]);
          a[2] = fmaf(dz, sij, a[2]);
        }
        if (!SELF) {
          // a select, not a multiply: see the header
          const float sji =
              r.live[mb][h] ? directional_scale(parts, cji[e]) : 0.0f;
          float* b = jp[cc];
          if (M::FACTORED) {
            b[0] = fmaf(sji, rx, b[0]);
            b[1] = fmaf(sji, ry, b[1]);
            b[2] = fmaf(sji, rz, b[2]);
            b[3] = fmaf(sji, r.one[mb][h], b[3]);
          } else {
            b[0] = fmaf(dx, sji, b[0]);
            b[1] = fmaf(dy, sji, b[1]);
            b[2] = fmaf(dz, sji, b[2]);
          }
        }
      }
    }
    if (!SELF) {
      const float x[8] = {jp[0][0], jp[0][1], jp[0][2], jp[0][3],
                          jp[1][0], jp[1][1], jp[1][2], jp[1][3]};
      const float total = lane_group_sums(x, lane);
      const int slot = group_slot(lane);
      if ((slot & 3) < M::NC) sm.part[wr][slot & 3][c0 + (slot >> 2)] = total;
    }
  }
}

// ---------------------------------------------------------- the block

// One block of TILE threads: receiver tile blockIdx.x, steps
// [blockIdx.y * kspan, ...) of nk = nt / 2 + 1. `pos` is [Np, 3] (K2) or
// p4 [Np, 4] (K5); `mask` (K2, or null) the bit mask [nt, nkw] of steps to
// run; K5 skips the tile pairs of a tile with no row whose imask > 0. Writes
// out_a_part[blockIdx.y] (the i-side of the span; K2 in world units, K5
// fixed up) and out_b[k] (the j-side of step k for tile j, negated and in
// world units for K2, fixed up for K5).
template <int LAW, int MODE, int PP>
__device__ __forceinline__ void tri_sweep_block(
    const float* __restrict__ pos, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ r2row,
    const float* __restrict__ imask, const int* __restrict__ mask,
    const int nkw, const int nt, const int kspan,
    float* __restrict__ out_a_part,
    float* __restrict__ out_b, const PairParams& pf) {
  using M = Mode<MODE>;
  __shared__ PairSmem<PP> sm;
  const int i = blockIdx.x;
  const int a = threadIdx.x;
  const int lane = a & 31;
  const int warp = a >> 5;
  const int wr = warp % WARP_ROWS;
  const int wc = warp / WARP_ROWS;
  const size_t np = static_cast<size_t>(nt) * TILE;
  const size_t row = static_cast<size_t>(i) * TILE + a;
  const int nk = nt / 2 + 1;
  const int k0 = blockIdx.y * kspan;
  const int k1 = min(nk, k0 + kspan);
  const float w = pf.v[PF_W];
  float* oa = out_a_part + (static_cast<size_t>(blockIdx.y) * np + row) * 3;

  if (M::FACTORED && !__syncthreads_or(imask[row] > 0.0f)) {
    // a dead receiver tile: all zeros
    for (int k = k0; k < k1; ++k) {
      float* ob = out_b + static_cast<size_t>(k) * 3 * np +
                  static_cast<size_t>((i + k) % nt) * TILE;
      ob[a] = 0.0f;
      ob[np + a] = 0.0f;
      ob[2 * np + a] = 0.0f;
    }
    oa[0] = oa[1] = oa[2] = 0.0f;
    return;
  }

  Receivers<PP> r;
  load_receivers<MODE, PP>(r, pos, u, v, imask,
                           static_cast<size_t>(i) * TILE + wr * MT * 16,
                           lane >> 2, lane & 3);
  float acc[MT][2][4] = {};

  for (int k = k0; k < k1; ++k) {  // block-uniform control flow throughout
    const int j = (i + k) % nt;
    float* ob = out_b + static_cast<size_t>(k) * 3 * np + static_cast<size_t>(j) * TILE;
    bool run = !(2 * k == nt && 2 * i >= nt);  // even nt: half diagonal once
    if (mask != nullptr && k > 0) {
      run = run && ((mask[static_cast<size_t>(i) * nkw + (k >> 5)] >> (k & 31)) & 1);
    }
    const size_t jr = static_cast<size_t>(j) * TILE + a;
    // a barrier too: the previous pair's staged tile and sums are consumed
    if (run) {
      if (M::FACTORED) {
        run = __syncthreads_or(imask[jr] > 0.0f) != 0;
      } else {
        __syncthreads();
      }
    }
    if (!run) {
      ob[a] = 0.0f;
      ob[np + a] = 0.0f;
      ob[2 * np + a] = 0.0f;
      continue;
    }
    {
      if (M::FACTORED) {
        const float4 q = reinterpret_cast<const float4*>(pos)[jr];
        sm.p[a] = q;
        sm.q[a] = make_float2(r2row[jr], q.x * q.x + q.y * q.y + q.z * q.z);
      } else {
        sm.p[a] = make_float4(pos[3 * jr], pos[3 * jr + 1], pos[3 * jr + 2],
                              r2row[jr]);
      }
      stage_fragments<PP>(sm.u, u + jr * PP, a);
      stage_fragments<PP>(sm.v, v + jr * PP, a);
    }
    __syncthreads();
    if (k == 0) {
      sweep_tile_pair<LAW, MODE, PP, true>(sm, r, acc, wr, wc, lane, pf);
      ob[a] = 0.0f;
      ob[np + a] = 0.0f;
      ob[2 * np + a] = 0.0f;
      continue;
    }
    sweep_tile_pair<LAW, MODE, PP, false>(sm, r, acc, wr, wc, lane, pf);
    __syncthreads();
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < WARP_ROWS; ++q) {
#pragma unroll
      for (int c = 0; c < M::NC; ++c) s[c] += sm.part[q][c][a];
    }
    if (M::FACTORED) {
      const float4 p = sm.p[a];
      ob[a] = s[0] - p.x * s[3];
      ob[np + a] = s[1] - p.y * s[3];
      ob[2 * np + a] = s[2] - p.z * s[3];
    } else {
      const float sc = M::BOX ? -w : -1.0f;
      ob[a] = s[0] * sc;
      ob[np + a] = s[1] * sc;
      ob[2 * np + a] = s[2] * sc;
    }
  }

  // the i-side: over the quad's 4 lanes (a butterfly: every lane gets the
  // same total), then over the warps along the columns, in a fixed order
#pragma unroll
  for (int mb = 0; mb < MT; ++mb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < M::NC; ++c) {
        float x = acc[mb][h][c];
        x += __shfl_xor_sync(FULL, x, 1);
        x += __shfl_xor_sync(FULL, x, 2);
        acc[mb][h][c] = x;
      }
    }
  }
  __syncthreads();  // every column sum is read
#pragma unroll
  for (int mb = 0; mb < MT; ++mb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (((2 * mb + h) & 3) != (lane & 3)) continue;
      const int rr = wr * MT * 16 + 16 * mb + (lane >> 2) + 8 * h;
#pragma unroll
      for (int c = 0; c < M::NC; ++c) sm.part[wc][c][rr] = acc[mb][h][c];
    }
  }
  __syncthreads();
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < WARP_COLS; ++q) {
#pragma unroll
    for (int c = 0; c < M::NC; ++c) s[c] += sm.part[q][c][a];
  }
  if (M::FACTORED) {
    const float4 p = reinterpret_cast<const float4*>(pos)[row];
    oa[0] = s[0] - p.x * s[3];
    oa[1] = s[1] - p.y * s[3];
    oa[2] = s[2] - p.z * s[3];
  } else {
    const float sc = M::BOX ? w : 1.0f;
    oa[0] = s[0] * sc;
    oa[1] = s[1] * sc;
    oa[2] = s[2] * sc;
  }
}

}  // namespace p3t
