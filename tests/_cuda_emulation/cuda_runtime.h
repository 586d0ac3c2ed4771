// A CPU emulation of the CUDA subset that the port's kernels use
// (csrc/celllist_sweep.cu, allpairs_sweep.cu, allpairs_mxu.cu, splat.cu), so
// that g++ can compile a kernel's source and a test can run its logic on the
// CPU (tests/test_torch_k1_emulated.py, tests/test_torch_allpairs_emulated.py,
// tests/test_torch_splat_kernel.py).
// Blocks run one after another; the threads of a block are std::threads;
// __syncthreads is a std::barrier over the block, and __ballot_sync,
// __shfl_xor_sync and the warp-wide TF32 mma one over the warp.
// `__shared__` becomes `static`, shared by the threads of the block that
// runs. The test rewrites each `<<<grid, block, 0, stream>>>` launch into a
// call of emu_launch. Only the logic is emulated: arithmetic is the host's
// (no MUFU, and the device's FMA contraction is not reproduced), except
// cvt.rna.tf32.f32, which rounds as the hardware does. The rounded
// intrinsics (__fmul_rn and kin) are the host's IEEE float operations,
// which they are on the card too.
#pragma once
#define P3T_CUDA_EMULATION 1
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
// The SM count the device reports: 1 unless a test sets another, so that a
// kernel that cuts small grids finer by the resident block count keeps its
// widest blocks unless asked
inline int emu_sm_count = 1;
extern "C" __attribute__((visibility("default"))) void emu_set_sm_count(int n) {
  emu_sm_count = n;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = emu_sm_count;
  return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_block_barrier;
inline std::barrier<>* emu_warp_barrier[32];
inline unsigned emu_vote[32];

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

inline int emu_block_vote[2];
inline thread_local unsigned emu_vote_turn;

// __syncthreads_or: a barrier that also returns whether any thread's
// predicate held (two counters used in turn, each cleared by thread 0 after
// the barrier that follows its use)
inline int __syncthreads_or(int pred) {
  int& v = emu_block_vote[emu_vote_turn++ & 1];
  if (pred) __atomic_store_n(&v, 1, __ATOMIC_SEQ_CST);
  emu_block_barrier->arrive_and_wait();
  const int r = __atomic_load_n(&v, __ATOMIC_SEQ_CST);
  emu_block_barrier->arrive_and_wait();
  if (threadIdx.x == 0) __atomic_store_n(&v, 0, __ATOMIC_SEQ_CST);
  return r;
}

inline unsigned __ballot_sync(unsigned, bool pred) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (pred) __atomic_fetch_or(&emu_vote[w], 1u << lane, __ATOMIC_SEQ_CST);
  emu_warp_barrier[w]->arrive_and_wait();
  const unsigned r = __atomic_load_n(&emu_vote[w], __ATOMIC_SEQ_CST);
  emu_warp_barrier[w]->arrive_and_wait();
  if (lane == 0) __atomic_store_n(&emu_vote[w], 0u, __ATOMIC_SEQ_CST);
  emu_warp_barrier[w]->arrive_and_wait();
  return r;
}

// Warp exchanges: each lane publishes into a buffer, waits for the warp,
// then reads; two buffers used in turn, so one barrier a call suffices (a
// lane writes a buffer again only after the barrier of the call between,
// which every lane reaches after its read).
inline thread_local unsigned emu_shfl_turn, emu_mma_turn;
inline float emu_shfl_buf[2][32][32];

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  float(&buf)[32] = emu_shfl_buf[emu_shfl_turn++ & 1][w];
  buf[lane] = v;
  emu_warp_barrier[w]->arrive_and_wait();
  return buf[lane ^ lane_mask];
}

// cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero (on the
// magnitude: add half a TF32 unit, clear the 13 low bits); inf and NaN pass
inline uint32_t emu_cvt_rna_tf32(float x) {
  uint32_t b;
  std::memcpy(&b, &x, sizeof b);
  if ((b & 0x7f800000u) == 0x7f800000u) return b;
  return (b + 0x1000u) & 0xffffe000u;
}

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += A B, with the
// hardware's fragment ownership: lane (g, t) = (lane / 4, lane % 4) holds
// A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4], B[t][g], B[t+4][g] and
// D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]. The products of TF32
// values are exact in float; each output's eight products and its addend
// are summed exactly (in double) and rounded once, where the tensor core's
// internal order is not documented.
struct EmuMma {
  uint32_t a[32][4], b[32][2];
};
inline EmuMma emu_mma_buf[2][32];

inline float emu_tf32_float(uint32_t b) {
  b &= 0xffffe000u;  // the tensor core reads 19 bits of each operand
  float f;
  std::memcpy(&f, &b, sizeof f);
  return f;
}

inline void emu_mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4],
                                 const uint32_t (&b)[2]) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  EmuMma& m = emu_mma_buf[emu_mma_turn++ & 1][w];
  for (int e = 0; e < 4; ++e) m.a[lane][e] = a[e];
  m.b[lane][0] = b[0];
  m.b[lane][1] = b[1];
  emu_warp_barrier[w]->arrive_and_wait();
  const int g = lane / 4, t = lane % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    double s = d[e];
    for (int k = 0; k < 8; ++k) {
      const float av = emu_tf32_float(m.a[4 * (row % 8) + k % 4][(row / 8) + 2 * (k / 4)]);
      const float bv = emu_tf32_float(m.b[4 * col + k % 4][k / 4]);
      s += static_cast<double>(av * bv);
    }
    d[e] = static_cast<float>(s);
  }
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

inline std::mutex emu_atomic_mutex;
inline int atomicMax(int* a, int v) {
  std::lock_guard<std::mutex> lock(emu_atomic_mutex);
  const int old = *a;
  if (v > old) *a = v;
  return old;
}
inline int atomicMin(int* a, int v) {
  std::lock_guard<std::mutex> lock(emu_atomic_mutex);
  const int old = *a;
  if (v < old) *a = v;
  return old;
}

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline int __float_as_int(float x) {
  int i;
  std::memcpy(&i, &x, sizeof i);
  return i;
}

template <class Kernel, class... Args>
void emu_launch(dim3 grid, dim3 block, Kernel kernel, Args... args) {
  gridDim = grid;
  blockDim = block;
  const int nt = static_cast<int>(block.x);
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(nt);
      emu_block_barrier = &bar;
      std::vector<std::unique_ptr<std::barrier<>>> warps;
      for (int w = 0; w * 32 < nt; ++w) {
        warps.emplace_back(new std::barrier<>(std::min(32, nt - 32 * w)));
        emu_warp_barrier[w] = warps.back().get();
        emu_vote[w] = 0;
      }
      std::vector<std::thread> threads;
      for (int t = 0; t < nt; ++t) {
        threads.emplace_back([=] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          kernel(args...);
        });
      }
      for (auto& t : threads) t.join();
    }
  }
}
