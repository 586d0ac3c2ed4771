// Helpers shared by the triangular tile-pair kernels (K2 and K4 in
// allpairs_sweep.cu, K5 in allpairs_mxu.cu) and their plain C launchers:
// feature-vector loads and dot products in a fixed order, the warp's
// fixed-order column sums of the j-side, and the compile-time dispatch over
// (law, a boolean mode, feature width).
#pragma once

#include <cuda_runtime.h>

#include <cstring>

#include "pair_law.cuh"

namespace p3t {

constexpr int TILE = 128;          // tile rows, one thread each
constexpr int WARPS = TILE / 32;
constexpr int GROUP = 8;           // source columns reduced together
constexpr unsigned FULL = 0xffffffffu;

template <int PP>
__device__ __forceinline__ void load_vec(float (&dst)[PP], const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < PP / 4; ++q) {
    const float4 x = s4[q];
    dst[4 * q] = x.x;
    dst[4 * q + 1] = x.y;
    dst[4 * q + 2] = x.z;
    dst[4 * q + 3] = x.w;
  }
}

template <int PP>
__device__ __forceinline__ void copy_vec(float* dst, const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < PP / 4; ++q) d4[q] = s4[q];
}

// a . b in a fixed order; b is 16-byte aligned shared memory (broadcast)
template <int PP>
__device__ __forceinline__ float dot(const float (&a)[PP], const float* b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float c = 0.0f;
#pragma unroll
  for (int q = 0; q < PP / 4; ++q) {
    const float4 x = b4[q];
    c = fmaf(a[4 * q], x.x, c);
    c = fmaf(a[4 * q + 1], x.y, c);
    c = fmaf(a[4 * q + 2], x.z, c);
    c = fmaf(a[4 * q + 3], x.w, c);
  }
  return c;
}

// Sums x[g] over the warp's 32 lanes for each of the GROUP = 8 columns g in
// a fixed order: three rounds of recursive halving (each lane keeps half of
// its columns and takes its partner's share of them), then a butterfly
// over the remaining lane bits. Lane l ends with the total of column
// column_of_lane(l & 7).
__device__ __forceinline__ float warp_column_sums(const float (&x)[GROUP],
                                                  const int lane) {
  const bool b0 = lane & 1;
  float y[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float send = b0 ? x[c] : x[c + 4];
    const float keep = b0 ? x[c + 4] : x[c];
    y[c] = keep + __shfl_xor_sync(FULL, send, 1);
  }
  const bool b1 = lane & 2;
  float z[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float send = b1 ? y[c] : y[c + 2];
    const float keep = b1 ? y[c + 2] : y[c];
    z[c] = keep + __shfl_xor_sync(FULL, send, 2);
  }
  const bool b2 = lane & 4;
  float s = (b2 ? z[1] : z[0]) + __shfl_xor_sync(FULL, b2 ? z[0] : z[1], 4);
  s += __shfl_xor_sync(FULL, s, 8);
  s += __shfl_xor_sync(FULL, s, 16);
  return s;
}

__device__ __forceinline__ int column_of_lane(const int lane) {
  return ((lane & 1) << 2) | (lane & 2) | ((lane >> 2) & 1);
}

// Calls f.run<LAW, FLAG, P>() with compile-time constants (FLAG: K2/K4's
// wrap, K5's fast mode); false when a value has no instantiation.
template <int PP, bool FLAG, typename F>
bool dispatch_law(int law, const F& f) {
  switch (law) {
    case PARTICLE_LIFE:
      f.template run<PARTICLE_LIFE, FLAG, PP>();
      return true;
    case LENNARD_JONES:
      f.template run<LENNARD_JONES, FLAG, PP>();
      return true;
    case GRAVITY:
      f.template run<GRAVITY, FLAG, PP>();
      return true;
    case SPRING:
      f.template run<SPRING, FLAG, PP>();
      return true;
    default:
      return false;
  }
}

template <int PP, typename F>
bool dispatch_flag(int law, int flag, const F& f) {
  return flag ? dispatch_law<PP, true>(law, f) : dispatch_law<PP, false>(law, f);
}

template <typename F>
bool dispatch(int law, int flag, int p, const F& f) {
  if (p == 8) return dispatch_flag<8>(law, flag, f);
  if (p == 16) return dispatch_flag<16>(law, flag, f);
  return false;
}

inline PairParams unpack(const float* params) {
  PairParams pf;
  std::memcpy(pf.v, params, sizeof(pf.v));
  return pf;
}

// cudaGetLastError() after a launch (0: accepted), or cudaErrorInvalidValue
// when no instantiation took the operands
inline int launched(bool ok) {
  return ok ? static_cast<int>(cudaGetLastError())
            : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace p3t
