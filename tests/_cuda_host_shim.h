// Host shim for csrc/segment_fused.cu: lets g++ (C++20) compile the kernel
// source as plain C++ and run a launch on the CPU
// (tests/test_torch_kernel_host.py).  Each block runs as one std::thread
// per CUDA thread, one block after another: threadIdx, blockIdx and
// blockDim are thread-local, each block has its own dynamic shared memory,
// __syncthreads() is a std::barrier over the block's threads, and a thread
// that returns drops out of the barrier, as an exited CUDA thread no longer
// counts at __syncthreads().  A block's threads take turns on one core:
// each holds the block's baton while it runs and lets go of it at a
// barrier and on return, so a launch keeps one core busy, not every core
// with hundreds of runnable threads.  The test's substitutions turn the
// bulk copy into a memcpy, the wait on its mbarrier into a barrier behind
// it, and the rest of the mbarrier's PTX into no-ops.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
using std::isfinite;
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
#define __align__(x) alignas(x)
#define LT_NOASM(...) ((void)0)
struct dim3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3_ threadIdx, blockIdx, blockDim;
inline thread_local unsigned char* lt_emu_smem = nullptr;
inline thread_local std::barrier<>* lt_emu_bar = nullptr;
inline thread_local std::mutex* lt_emu_baton = nullptr;
inline int __popcll(long long x) { return __builtin_popcountll((unsigned long long)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clzll(long long x) { return x == 0 ? 64 : __builtin_clzll((unsigned long long)x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline unsigned __fns(unsigned mask, unsigned base, int offset) {
  int seen = 0;
  for (unsigned b = base; b < 32; ++b) if ((mask >> b) & 1u) { if (++seen == offset) return b; }
  return 0xffffffffu;
}
inline long long clock64() { return 0; }
inline void __syncthreads() {
  lt_emu_baton->unlock();
  lt_emu_bar->arrive_and_wait();
  lt_emu_baton->lock();
}
inline uint32_t __cvta_generic_to_shared(const void*) { return 0; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
struct cudaFuncAttributes { int numRegs = 0, maxThreadsPerBlock = 0; size_t localSizeBytes = 0, sharedSizeBytes = 0; };
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, const void*) { *a = cudaFuncAttributes{}; return 0; }
template <class K> inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, K, int, size_t) { *b = 1; return 0; }

// One launch: `grid` blocks of `block` threads with `bytes` of dynamic
// shared memory each.
template <class K, class... A>
inline void lt_emu_launch(K kernel, long long grid, int block, size_t bytes, A... args) {
  for (long long b = 0; b < grid; ++b) {
    std::vector<unsigned char> mem(bytes + 16);
    unsigned char* smem = mem.data() + (16 - reinterpret_cast<uintptr_t>(mem.data()) % 16) % 16;
    std::barrier<> bar(block);
    std::mutex baton;
    std::vector<std::thread> threads;
    threads.reserve(block);
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([&, t] {
        blockIdx.x = (unsigned)b;
        threadIdx.x = (unsigned)t;
        blockDim.x = (unsigned)block;
        lt_emu_smem = smem;
        lt_emu_bar = &bar;
        lt_emu_baton = &baton;
        baton.lock();
        kernel(args...);
        baton.unlock();
        bar.arrive_and_drop();
      });
    }
    for (std::thread& th : threads) th.join();
  }
}
