// Standalone Perlin turbulence kernel (B6) for Hopper (sm_90a).
//
// Replaces the TPU kernel `miniraytracer_tpu/ops/noise.py::_turb_kernel`
// (launched by `flash_turbulence`): for each point p, the 7-octave
// turbulence |sum_i 0.5^i noise(2^i p)| of the reference's gradient noise
// (texture.cpp:68-165) from the scene's six 256-entry tables (px py pz gx gy
// gz). The plain PyTorch version is
// `miniraytracer_tpu_torch/ops/noise.py::flash_turbulence_plain`.
//
// Design. One thread a point, 256-thread blocks, grid ceil(N/256). Each block
// first stages the 6 KB of tables in shared memory (the TPU kernel keeps them
// in VMEM as lane-replicated tiles for its lane gather; here a lookup is one
// shared-memory load), then each thread calls `physics.cuh::turbulence`, the
// device function that the fused kernels B1, B4 and B5 run inside their
// bounce: one turbulence for all four, so they agree to the bit. It takes
// the table through a generic pointer, which addresses shared memory as well.
//
// What bounds it on this card: operations. Per point 7 octaves x 8 corners,
// about 710 fp32 instructions (--fmad=false; counted in chip_smoke.py) and 210
// table loads from shared memory, against 16 bytes of device-memory traffic
// (three coordinates in, one value out). At the work queue's 131,072 points
// that is ~2.8 us of fp32 work and ~0.6 us of traffic; the launch costs more
// than either, which no design of the kernel can change (fusing it into its
// caller can).
//
// Build: nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a
//        --fmad=false (no --use_fast_math), see utils/kernels.py.

#include "physics.cuh"

// Threads a block. The g++ host emulation runs blocks of one thread, for
// which its no-op __syncthreads() is right.
#ifndef MRT_NOISE_THREADS
#define MRT_NOISE_THREADS 256
#endif

namespace {

constexpr int TABLE_WORDS = 6 * 256;

__global__ void __launch_bounds__(MRT_NOISE_THREADS)
turbulence_kernel(const float* __restrict__ ptab, const float* __restrict__ px,
                  const float* __restrict__ py, const float* __restrict__ pz,
                  float* __restrict__ out, int n) {
  __shared__ float tab[TABLE_WORDS];
  for (int k = threadIdx.x; k < TABLE_WORDS; k += blockDim.x) tab[k] = ptab[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = turbulence(tab, v3(px[i], py[i], pz[i]));
}

}  // namespace

extern "C" {

// Turbulence at the n points (px, py, pz) from the (6, 256) tables `ptab`,
// into `out`, on `stream`. Device pointers. Returns the launch's cudaError_t
// (0 on success). Does not synchronise.
int mrt_turbulence(const float* ptab, const float* px, const float* py, const float* pz,
                   float* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int threads = MRT_NOISE_THREADS;
  const int blocks = (n + threads - 1) / threads;
  MRT_LAUNCH(turbulence_kernel, blocks, threads, 0, stream, ptab, px, py, pz, out, n);
  return (int)cudaGetLastError();
}

const char* mrt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
