// Host emulation of the little CUDA the kernels use, for a rehearsal of the
// kernel logic on a machine without a GPU:
//
//   g++ -O1 -std=c++17 -ffp-contract=off -x c++ -DMRT_HOST_EMULATION
//       -DMRT_AD_THREADS=1 -shared -fPIC -o libbounce_ad_host.so bounce_ad.cu
//
// A launch runs the kernel body once per (block, thread), one after the other,
// on host pointers. Blocks of one thread (MRT_AD_THREADS=1,
// MRT_BOUNCE_THREADS=1) make
// __syncthreads() a no-op that is still correct. It checks logic and
// arithmetic, not the GPU build: nvcc still has to compile the source.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <cmath>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

using std::isfinite;
using std::max;
using std::min;

struct MrtDim3 {
  unsigned x, y, z;
};
static MrtDim3 blockIdx, threadIdx, blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
static const cudaError_t cudaErrorInvalidValue = 1;
static inline cudaError_t cudaGetLastError() { return 0; }
static inline const char* cudaGetErrorString(cudaError_t) { return "host emulation"; }
static inline void __syncthreads() {}
// blocks of one thread and warps of one lane (MRT_WARP 1): a vote is the
// thread's own, a shuffle gives back what it was given
#define MRT_WARP 1
static inline unsigned __ballot_sync(unsigned, int predicate) { return predicate ? 1u : 0u; }
template <typename T>
static inline T __shfl_sync(unsigned, T v, int) { return v; }
template <typename T>
static inline T __shfl_xor_sync(unsigned, T v, int) { return v; }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }

// the read-only data cache path is a plain load here
struct float4 {
  float x, y, z, w;
};
template <typename T>
static inline T __ldg(const T* p) { return *p; }

static inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

static inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, sizeof u);
  return u;
}

// round to the nearest int, ties to even, saturating; NaN -> 0 (cvt.rni.s32.f32)
static inline int __float2int_rn(float x) {
  if (!(x == x)) return 0;
  if (x >= 2147483647.0f) return 2147483647;
  if (x <= -2147483648.0f) return -2147483647 - 1;
  return (int)nearbyintf(x);
}

static inline float atomicAdd(float* p, float v) {
  float old = *p;
  *p = old + v;
  return old;
}

static inline int atomicAdd(int* p, int v) {
  int old = *p;
  *p = old + v;
  return old;
}

static inline unsigned atomicAdd(unsigned* p, unsigned v) {
  unsigned old = *p;
  *p = old + v;
  return old;
}

static inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  unsigned long long old = *p;
  *p = old + v;
  return old;
}

template <typename T>
static inline T atomicExch(T* p, T v) {
  T old = *p;
  *p = v;
  return old;
}

static inline void __threadfence() {}

template <typename T>
static inline cudaError_t cudaMemcpyFromSymbol(void* dst, const T& symbol, size_t bytes) {
  memcpy(dst, &symbol, bytes);
  return 0;
}

static inline cudaError_t cudaMemsetAsync(void* p, int value, size_t bytes, cudaStream_t) {
  memset(p, value, bytes);
  return 0;
}

// The dynamic shared memory of a block: one static buffer, which each block
// (they run one after the other) stages anew.
#define MRT_DYNAMIC_SHARED(name) static float name[MRT_EMULATED_SMEM_WORDS]
#define MRT_EMULATED_SMEM_WORDS (48 * 1024 / 4)

// A persistent grid of the emulated card: one block an SM and MRT_EMULATED_SMS
// SMs, so that a launch of a few threads takes more units of work than it
// has threads.
#define MRT_EMULATED_SMS 3
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
template <typename Kernel>
static inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, Kernel, int,
                                                                        size_t) {
  *n = 1;
  return 0;
}
static inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return 0;
}
static inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = MRT_EMULATED_SMS;
  return 0;
}

#define MRT_LAUNCH(kernel, blocks, threads, smem, stream, ...)       \
  do {                                                               \
    gridDim = MrtDim3{(unsigned)(blocks), 1, 1};                     \
    blockDim = MrtDim3{(unsigned)(threads), 1, 1};                   \
    for (unsigned b_ = 0; b_ < (unsigned)(blocks); ++b_)             \
      for (unsigned t_ = 0; t_ < (unsigned)(threads); ++t_) {        \
        blockIdx = MrtDim3{b_, 0, 0};                                \
        threadIdx = MrtDim3{t_, 0, 0};                               \
        kernel(__VA_ARGS__);                                         \
      }                                                              \
  } while (0)
