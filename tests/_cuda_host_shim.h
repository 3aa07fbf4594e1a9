// Host shim for csrc/segment_fused.cu: lets g++ compile the kernel source
// as plain C++, each launch run one thread at a time on the CPU
// (tests/test_torch_kernel_host.py).  Only the global form is faithful
// this way: its threads share nothing, while the narrow and wide forms'
// blocks meet at barriers over shared memory.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstddef>
#include <cstring>
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
inline thread_local dim3_ threadIdx, blockIdx;
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
inline void __syncthreads() {}
inline uint32_t __cvta_generic_to_shared(const void*) { return 0; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
template <class K> inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, K, int, size_t) { *b = 1; return 0; }
alignas(16) inline unsigned char lt_emu_smem[1 << 20];
