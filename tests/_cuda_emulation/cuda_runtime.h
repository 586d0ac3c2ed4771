// A CPU emulation of the CUDA subset that csrc/celllist_sweep.cu uses, so
// that g++ can compile the kernel's source and a test can run its logic on
// the CPU (tests/test_torch_k1_emulated.py). Blocks run one after another;
// the threads of a block are std::threads; __syncthreads is a std::barrier
// over the block and __ballot_sync one over the warp. `__shared__` becomes
// `static`, shared by the threads of the block that runs. The test rewrites
// the `<<<grid, block, 0, stream>>>` launch into a call of emu_launch. Only
// the logic is emulated: arithmetic is the host's (no MUFU, and the
// device's FMA contraction is not reproduced).
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
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

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

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
