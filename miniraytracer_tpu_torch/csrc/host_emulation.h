// Host emulation of the little CUDA the kernels use, for a rehearsal of the
// kernel logic on a machine without a GPU:
//
//   g++ -O1 -std=c++17 -ffp-contract=off -x c++ -DMRT_HOST_EMULATION
//       -DMRT_AD_THREADS=1 -shared -fPIC -o libbounce_ad_host.so bounce_ad.cu
//
// A launch runs the kernel body once per (block, thread), one after the other,
// on host pointers. Blocks of one thread (MRT_AD_THREADS=1) make
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
static inline cudaError_t cudaGetLastError() { return 0; }
static inline const char* cudaGetErrorString(cudaError_t) { return "host emulation"; }
static inline void __syncthreads() {}

static inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

static inline float atomicAdd(float* p, float v) {
  float old = *p;
  *p = old + v;
  return old;
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
