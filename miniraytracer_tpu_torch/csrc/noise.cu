// Standalone Perlin turbulence kernel (B6) for Hopper (sm_90a).
//
// Replaces the TPU kernel `miniraytracer_tpu/ops/noise.py::_turb_kernel`
// (launched by `flash_turbulence`): for each point p, the 7-octave
// turbulence |sum_i 0.5^i noise(2^i p)| of the reference's gradient noise
// (texture.cpp:68-165) from the scene's six 256-entry tables (px py pz gx gy
// gz). The plain PyTorch version is
// `miniraytracer_tpu_torch/ops/noise.py::flash_turbulence_plain`.
//
// Design. A persistent grid of 512-thread blocks (as many as the card holds
// at once, no more than the points fill: 256 at the work queue's 131,072
// points), each thread striding over the points (a point costs the same
// wherever it lies, so a static stride balances as well as a counter
// would). Each block first stages the 6 KB of tables in shared memory (the
// TPU kernel keeps them in VMEM as lane-replicated tiles for its lane
// gather; here a lookup is one shared-memory load), then each thread calls
// `physics.cuh::turbulence`, the device function that the fused kernels
// B1, B2, B4 and B5 run inside their bounce: one turbulence for all, so
// they agree to the bit. It takes the table through a generic pointer,
// which addresses shared memory as well.
//
// Measured (PERF.md section 6): half of the time is the launch, the staging
// and the points' loads and stores (a probe that computes no turbulence
// takes it), the rest the arithmetic. The first design's one thread a point
// in 512 blocks of 256 staged the tables 512 times; 256 blocks of 512
// threads stage them half as often, 5% faster; blocks of 1024 idle four SMs
// (2-3%). Not kept: the tables packed for fewer loads (the permutations as
// integers two neighbours a word, a 16-byte gradient row a lattice value:
// 77 shared-memory loads a point instead of 210, no float-to-int
// conversions), within 1.5% of the float tables, and in the fused kernels
// that staged them more registers; two or four points a thread in flight;
// the tables read from global memory.
//
// What bounds it on this card: operations. Per point 7 octaves x 8 corners,
// about 710 fp32 instructions (--fmad=false; counted in chip_smoke.py) and 210
// table loads from shared memory, against 16 bytes of device-memory traffic
// (three coordinates in, one value out). At the work queue's 131,072 points
// that is ~2.8 us of fp32 work and ~0.6 us of traffic; the launch and the
// staging cost about as much as the arithmetic, which no design of the
// kernel can change (fusing it into its caller can).
//
// Build: nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a
//        --fmad=false (no --use_fast_math), see utils/kernels.py.

#include "physics.cuh"

// Threads a block. The g++ host emulation runs blocks of one thread, for
// which its no-op __syncthreads() is right.
#ifndef MRT_NOISE_THREADS
#define MRT_NOISE_THREADS 512
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
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    out[i] = turbulence(tab, v3(px[i], py[i], pz[i]));
}

Grid turbulence_grid(int n) {
  return persistent_grid(turbulence_kernel, MRT_NOISE_THREADS, 0, n);
}

}  // namespace

extern "C" {

// Turbulence at the n points (px, py, pz) from the (6, 256) tables `ptab`,
// into `out`, on `stream`. Device pointers. Returns the launch's cudaError_t
// (0 on success). Does not synchronise.
int mrt_turbulence(const float* ptab, const float* px, const float* py, const float* pz,
                   float* out, int n, void* stream) {
  if (n <= 0) return 0;
  const Grid g = turbulence_grid(n);
  MRT_LAUNCH(turbulence_kernel, g.blocks, MRT_NOISE_THREADS, 0, stream, ptab, px, py, pz, out,
             n);
  return (int)cudaGetLastError();
}

// The grid mrt_turbulence launches for n points: blocks an SM holds, SMs,
// blocks, threads a block, dynamic shared memory in bytes (0: the tables are
// static shared memory).
void mrt_turbulence_grid(int n, int* out) {
  const Grid g = turbulence_grid(n);
  out[0] = g.per_sm;
  out[1] = g.sms;
  out[2] = g.blocks;
  out[3] = MRT_NOISE_THREADS;
  out[4] = 0;
}

const char* mrt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
