// Dense nearest-hit sweeps for Hopper (sm_90a): for every ray the closest
// triangle, or the closest sphere, over ALL primitives of the set.
//
// Replaces the TPU kernels `miniraytracer_tpu/ops/flash.py::_kernel` (launched
// by `flash_tri_hit`) and `::_sphere_kernel` (launched by `flash_sphere_hit`).
// They compute, per (primitive, ray) pair, inner products of a row of
// per-primitive coefficients with a per-ray feature vector:
//
//   triangles: det, uu, vv, tn = <(T,16) rows, [1, ro, rd, ro (x) rd]>;
//     backface flip only when inside > 0 and det < 0; valid iff sdet >= 1e-5,
//     suu >= 0, svv >= 0, suu + svv <= sdet and t = tn/det >= tmin;
//   spheres: b, c = <(S,24) rows (17 columns used), [1, ro, rd, ro.rd, |ro|^2,
//     time, time^2, time*ro, time*rd]>; disc = b^2 - c; the front root if
//     > tmin, else the back root, and that only when inside > 0;
//
// and keep a running (min t, first index) per ray. Out: t (3e38 = miss) and
// the index. The plain PyTorch versions are `flash_tri_hit_plain` and
// `flash_sphere_hit_plain` in `miniraytracer_tpu_torch/ops/flash.py`.
//
// Design. One thread per ray: it builds its 16 (17) features in registers from
// ro, rd (and time), which is all it reads of the ray. A block of 128 rays
// stages a tile of coefficient rows in shared memory; every thread sweeps the
// tile in index order (all threads read the same row: a broadcast) and keeps
// (best_t, best_i) with a strict `<`, so the lowest index wins a tie. Each
// inner product is summed term by term in column order, as the plain version
// sums it: c = |ro|^2 - 2 ro.P + |P|^2 - r^2 cancels heavily on a radius-1000
// sphere, so the order is part of the result. The TPU form is a matrix
// product on (512, 128) tiles padded with zero rows and zero columns; none of
// that padding is kept. Comparisons are explicit (never fminf/fmaxf): a dead
// lane arrives as a NaN ray, every test on it is false, and it comes back a
// miss. t = tn/det is 0/0 on an all-zero (inactive) row and is masked by
// sdet >= 1e-5.
//
// What bounds it on this card: fp32 instructions. Per pair about 2 x 17
// multiply-adds (unfused) plus the root and the tests for a sphere, 4 x 16
// plus ~15 for a triangle; the bytes (8 or 7 words a ray in, 2 out, the
// tables once) are negligible. A tensor-core form (it must not round the
// inputs to TF32 or bf16: winners change) is later work.
//
// Build: nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a
//        --fmad=false (no --use_fast_math), see utils/kernels.py.

#ifdef MRT_HOST_EMULATION
#include "host_emulation.h"
#else
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#ifndef MRT_LAUNCH
#define MRT_LAUNCH(kernel, blocks, threads, smem, stream, ...) \
  kernel<<<(blocks), (threads), (smem), (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

// threads (rays) of a block; a host emulation runs blocks of one thread, for
// which __syncthreads() may be a no-op
#ifndef MRT_FLASH_THREADS
#define MRT_FLASH_THREADS 128
#endif

namespace {

constexpr float INF = 3.0e38f;
constexpr float TRI_EPS = 1e-5f;
constexpr int TRI_F = 16;     // triangle features = table width
constexpr int SPH_W = 24;     // sphere table width
constexpr int SPH_F = 17;     // sphere features in use
constexpr int TILE = 64;      // coefficient rows staged at a time

// sum_k row[k] * f[k], term by term in column order
template <int F>
__device__ __forceinline__ float dot_row(const float* __restrict__ row, const float (&f)[F]) {
  float acc = row[0] * f[0];
#pragma unroll
  for (int k = 1; k < F; ++k) acc = acc + row[k] * f[k];
  return acc;
}

__global__ void __launch_bounds__(MRT_FLASH_THREADS)
flash_tri_kernel(const float* __restrict__ c_det, const float* __restrict__ c_uu,
                 const float* __restrict__ c_vv, const float* __restrict__ c_tn,
                 const float* __restrict__ rox, const float* __restrict__ roy,
                 const float* __restrict__ roz, const float* __restrict__ rdx,
                 const float* __restrict__ rdy, const float* __restrict__ rdz,
                 const int* __restrict__ inside_in, float* __restrict__ t_out,
                 int* __restrict__ i_out, int n, int T, float tmin) {
  __shared__ float tile[4][TILE * TRI_F];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = lane < n;
  const int src = live ? lane : n - 1;  // a thread past the end still helps stage
  const float ro[3] = {rox[src], roy[src], roz[src]};
  const float rd[3] = {rdx[src], rdy[src], rdz[src]};
  const bool inside = inside_in[src] > 0;
  float f[TRI_F];
  f[0] = 1.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    f[1 + a] = ro[a];
    f[4 + a] = rd[a];
#pragma unroll
    for (int b = 0; b < 3; ++b) f[7 + 3 * a + b] = ro[a] * rd[b];
  }
  float best_t = INF;
  int best_i = 0;
  for (int base = 0; base < T; base += TILE) {
    const int rows = min(TILE, T - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < rows * TRI_F; k += blockDim.x) {
      tile[0][k] = c_det[base * TRI_F + k];
      tile[1][k] = c_uu[base * TRI_F + k];
      tile[2][k] = c_vv[base * TRI_F + k];
      tile[3][k] = c_tn[base * TRI_F + k];
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float det = dot_row<TRI_F>(&tile[0][r * TRI_F], f);
      const float uu = dot_row<TRI_F>(&tile[1][r * TRI_F], f);
      const float vv = dot_row<TRI_F>(&tile[2][r * TRI_F], f);
      const float tn = dot_row<TRI_F>(&tile[3][r * TRI_F], f);
      // backface flip (triangle.cpp:226-235): allowed only when inside
      const float sign = (inside && det < 0.0f) ? -1.0f : 1.0f;
      const float sdet = det * sign, suu = uu * sign, svv = vv * sign;
      const float t = tn / det;
      const bool valid = sdet >= TRI_EPS && suu >= 0.0f && svv >= 0.0f &&
                         suu + svv <= sdet && t >= tmin;
      if (valid && t < best_t) {
        best_t = t;
        best_i = base + r;
      }
    }
  }
  if (live) {
    t_out[lane] = best_t;
    i_out[lane] = best_i;
  }
}

__global__ void __launch_bounds__(MRT_FLASH_THREADS)
flash_sphere_kernel(const float* __restrict__ cb, const float* __restrict__ cc,
                    const float* __restrict__ rox, const float* __restrict__ roy,
                    const float* __restrict__ roz, const float* __restrict__ rdx,
                    const float* __restrict__ rdy, const float* __restrict__ rdz,
                    const float* __restrict__ time_in, const int* __restrict__ inside_in,
                    float* __restrict__ t_out, int* __restrict__ i_out, int n, int S,
                    float tmin) {
  __shared__ float tile[2][TILE * SPH_F];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = lane < n;
  const int src = live ? lane : n - 1;
  const float ro[3] = {rox[src], roy[src], roz[src]};
  const float rd[3] = {rdx[src], rdy[src], rdz[src]};
  const float time = time_in[src];
  const bool inside = inside_in[src] > 0;
  float f[SPH_F];
  f[0] = 1.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    f[1 + a] = ro[a];
    f[4 + a] = rd[a];
    f[11 + a] = time * ro[a];
    f[14 + a] = time * rd[a];
  }
  f[7] = ro[0] * rd[0] + ro[1] * rd[1] + ro[2] * rd[2];
  f[8] = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2];
  f[9] = time;
  f[10] = time * time;
  float best_t = INF;
  int best_i = 0;
  for (int base = 0; base < S; base += TILE) {
    const int rows = min(TILE, S - base);
    __syncthreads();
    // the 7 pad columns of the (S, 24) tables stay in device memory
    for (int k = threadIdx.x; k < rows * SPH_F; k += blockDim.x) {
      const int r = k / SPH_F, col = k - r * SPH_F;
      tile[0][k] = cb[(base + r) * SPH_W + col];
      tile[1][k] = cc[(base + r) * SPH_W + col];
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float b = dot_row<SPH_F>(&tile[0][r * SPH_F], f);
      const float c = dot_row<SPH_F>(&tile[1][r * SPH_F], f);
      const float disc = b * b - c;
      const bool ok = disc > 0.0f;
      const float sq = sqrtf(ok ? disc : 0.0f);
      const float t_front = -b - sq;
      const float t_back = -b + sq;
      const bool front_ok = ok && t_front > tmin;
      const bool back_ok = ok && inside && t_back > tmin;
      if (front_ok || back_ok) {
        const float t = front_ok ? t_front : t_back;
        if (t < best_t) {
          best_t = t;
          best_i = base + r;
        }
      }
    }
  }
  if (live) {
    t_out[lane] = best_t;
    i_out[lane] = best_i;
  }
}

}  // namespace

extern "C" {

// Launch a sweep on `stream`. Pointers are device pointers to contiguous
// arrays: tables (T,16) or (S,24) f32, ray components (n,) f32, inside (n,)
// i32, outputs t (n,) f32 and idx (n,) i32. Returns the launch's cudaError_t
// (0 on success). Does not synchronise.
int mrt_flash_tri_hit(const float* c_det, const float* c_uu, const float* c_vv,
                      const float* c_tn, const float* rox, const float* roy, const float* roz,
                      const float* rdx, const float* rdy, const float* rdz, const int* inside,
                      float* t_out, int* i_out, int n, int T, float tmin, void* stream) {
  if (n <= 0) return 0;
  const int threads = MRT_FLASH_THREADS;
  const int blocks = (n + threads - 1) / threads;
  MRT_LAUNCH(flash_tri_kernel, blocks, threads, 0, stream, c_det, c_uu, c_vv, c_tn, rox, roy,
             roz, rdx, rdy, rdz, inside, t_out, i_out, n, T, tmin);
  return (int)cudaGetLastError();
}

int mrt_flash_sphere_hit(const float* cb, const float* cc, const float* rox, const float* roy,
                         const float* roz, const float* rdx, const float* rdy,
                         const float* rdz, const float* time, const int* inside, float* t_out,
                         int* i_out, int n, int S, float tmin, void* stream) {
  if (n <= 0) return 0;
  const int threads = MRT_FLASH_THREADS;
  const int blocks = (n + threads - 1) / threads;
  MRT_LAUNCH(flash_sphere_kernel, blocks, threads, 0, stream, cb, cc, rox, roy, roz, rdx, rdy,
             rdz, time, inside, t_out, i_out, n, S, tmin);
  return (int)cudaGetLastError();
}

const char* mrt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
