// Helpers shared by the all-pairs kernels (allpairs_sweep.cu,
// allpairs_mxu.cu, tile_pair_mma.cuh) and their plain C launchers: the tile
// size, feature-vector loads, and the compile-time dispatch over (law, a
// boolean mode, feature width).
#pragma once

#include <cuda_runtime.h>

#include <cstring>

#include "pair_law.cuh"

namespace p3t {

constexpr int TILE = 128;          // tile rows, one thread each
constexpr int WARPS = TILE / 32;
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

// Calls f.run<LAW, FLAG, P>() with compile-time constants (FLAG: K2-K4's
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
