// A stand-in for <cuda_runtime.h> that lets g++ build a CUDA source for the
// host, so that a kernel's arithmetic and indexing can be run where there is
// no card (tests/test_torch_kernel_emulation.py).  A block is a set of OS
// threads that meet at one barrier; __syncthreads, __syncwarp and the warp
// shuffles are all that barrier, which is right for a kernel whose threads
// reach them under uniform control flow.  Blocks run one after another and
// share one `smem` array.  g++ knows no `kernel<<<grid, block, ...>>>(args)`:
// the test rewrites that one expression of the source into
// `lgc_emulate(kernel, grid, block, args)`.  Nothing here says anything about
// speed.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(n)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__

using std::max;
using std::min;

struct LgcIndex { int x; };
inline thread_local LgcIndex threadIdx, blockIdx;
alignas(16) inline float smem[1 << 16];   // the "shared memory" of the running block
inline float lgc_exchange[1024];
inline std::barrier<>* lgc_barrier = nullptr;

inline void __syncthreads() { lgc_barrier->arrive_and_wait(); }
inline void __syncwarp() { lgc_barrier->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float value, int lane_mask) {
  lgc_exchange[threadIdx.x] = value;
  lgc_barrier->arrive_and_wait();
  const float other = lgc_exchange[threadIdx.x ^ lane_mask];
  lgc_barrier->arrive_and_wait();
  return other;
}

template <class Kernel, class... Args>
void lgc_emulate(Kernel kernel, int grid, int block, Args... args) {
  for (int b = 0; b < grid; ++b) {
    std::barrier<> barrier(block);
    lgc_barrier = &barrier;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}

// the little of the runtime API the launch code calls
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct cudaFuncAttributes { size_t sharedSizeBytes = 0, localSizeBytes = 0; int numRegs = 0; };
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  return static_cast<size_t>(bytes) <= sizeof(smem) ? cudaSuccess : cudaErrorInvalidValue;
}
template <class K> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, K) { return cudaSuccess; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) { return e == cudaSuccess ? "ok" : "error"; }
