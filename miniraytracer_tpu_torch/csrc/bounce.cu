// Fused wavefront render kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `miniraytracer_tpu/ops/bounce.py::_make_kernel`
// (launched by `fused_render_blocks`). It computes what that kernel computes:
// for each lane (one pixel), the reference's trace() body (main.cpp:66-118)
// -- nearest hit over spheres, rects, triangles, boxes and volumes, material
// dispatch, the 50/50 MIS light mixture, 7-octave Perlin -- then the
// miss/emit/throughput advance, the draw2 merge with its NaN reuse and
// luminance clamp (main.cpp:214-229), and regeneration with a new camera ray,
// until the lane has rendered all its samples. The plain PyTorch version is
// `miniraytracer_tpu_torch/ops/bounce.py` (`bounce_physics`, `wave_step`);
// both use the same counter-keyed RNG slots, the same where-guards and eps
// margins, and the same op order.
//
// Design. One thread per lane, 128-thread blocks, grid ceil(N/128). Each
// thread loops the wave step until its own lane is no longer alive: a dead
// lane's further masked steps (the TPU kernel runs them in (8,128) tiles,
// COND_EVERY steps between checks) change only its depth and key, and the
// contract is accum, count and rays. The first camera ray is built in the
// kernel with the same formula as `models/camera.get_rays`.
//
// What bounds it on this card: per-lane ALU work (the hit sweep, shading
// transcendentals, Perlin lookups) and warp divergence between lanes whose
// paths end at different bounces; memory traffic is tiny. The whole path
// state (~80 B: accum, ro, rd, time, beta, radiance, count, inside, depth,
// key) stays in registers for the whole render; per lane the kernel reads
// one pixel id and writes accum, count and rays (20 B) once. The scene
// tables are a few KB of read-only floats read through const __restrict__
// pointers in loops over run-time counts; they stay resident in L1.
// Shared-memory staging, divergence control (path regeneration already
// keeps a lane busy) and occupancy tuning are later work.
//
// The per-bounce physics and the wave step (`live_step`) live in physics.cuh,
// shared with bounce_ad.cu and hybrid.cu.
//
// Build: nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a
//        --fmad=false (no --use_fast_math), see utils/kernels.py.

#include "physics.cuh"

namespace {

__global__ void __launch_bounds__(128)
fused_render_kernel(Tables tb, RenderParams P, const int* __restrict__ pix_in,
                    float* __restrict__ accum_out, int* __restrict__ count_out,
                    int* __restrict__ rays_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P.n) return;
  const uint32_t pix = (uint32_t)pix_in[lane];
  Lane s;
  s.accum = v3(0.0f, 0.0f, 0.0f);
  s.count = 0;
  int rays = 0;
  bool alive = P.n_samples > 0;
  if (alive) start_sample(tb, P, pix, s);
  const ExtCand no_ext{};
  const Atlas no_atlas{};
  // ops/bounce.py::wave_step, looped on this lane until it is dead
  while (alive) alive = live_step<false, false, false>(tb, P, pix, s, rays, no_ext, no_atlas);
  accum_out[3 * lane] = s.accum.x;
  accum_out[3 * lane + 1] = s.accum.y;
  accum_out[3 * lane + 2] = s.accum.z;
  count_out[lane] = s.count;
  rays_out[lane] = rays;
}

}  // namespace

extern "C" {

// Launch the fused render on `stream`. Pointers are device pointers; `ip` is a
// host array of P_COUNT ints (physics.cuh: ParamIdx order). Returns the launch's
// cudaError_t (0 on success). Does not synchronise.
int mrt_fused_render(const float* sph, const float* rect, const float* tri, const float* box,
                     const float* vol, const float* mat, const float* tex, const float* cam,
                     const float* ptab, const int* pix, float* accum, int* count, int* rays,
                     const int* ip, float max_lum, void* stream) {
  Tables tb{sph, rect, tri, box, vol, mat, tex, cam, ptab};
  RenderParams P = read_render_params(ip, max_lum);
  if (P.n <= 0) return 0;
  const int threads = 128;
  const int blocks = (P.n + threads - 1) / threads;
  MRT_LAUNCH(fused_render_kernel, blocks, threads, 0, stream, tb, P, pix, accum, count, rays);
  return (int)cudaGetLastError();
}

const char* mrt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
