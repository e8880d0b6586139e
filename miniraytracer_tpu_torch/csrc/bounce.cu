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
// Design. A persistent grid (physics.cuh): as many 128-thread blocks as the
// card holds at once, each of whose threads takes a pixel from a work counter,
// renders its samples in order, writes accum, count and rays (20 B) and takes
// the next pixel. With one thread a pixel (the first design) a warp lasted as
// long as its slowest pixel. The loop is flat: every turn is one wave step
// (`bounce_step`) of the thread's current pixel, and a thread whose pixel ends
// takes the next in the same turn, so the warp's lanes keep tracing. A dead
// lane's further masked steps (the TPU kernel runs them in (8,128) tiles,
// COND_EVERY steps between checks) change only its depth and key, and the
// contract is accum, count and rays. The first camera ray is built in the
// kernel with the same formula as `models/camera.get_rays`.
//
// What bounds it on this card: per-lane ALU work (the hit sweep, shading
// transcendentals, Perlin lookups) and warp divergence between lanes whose
// paths end at different bounces; memory traffic is tiny. The whole path
// state (~80 B) stays in registers. Every ray reads every row of the scene
// tables, all lanes of a warp the same row: the block stages them in shared
// memory once (`stage_tables`; a scene beyond the budget runs the unstaged
// instance from global memory). No local memory: run-time indexing of arrays
// and of the light slots is written as selects, and sinf/cosf are CUDA's own
// with their slow range reduction in registers (`exact_sinf`).
//
// The per-bounce physics and the wave step (`bounce_step`) live in
// physics.cuh, shared with bounce_ad.cu and hybrid.cu.
//
// Build: nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a
//        --fmad=false (no --use_fast_math), see utils/kernels.py.

#include "physics.cuh"

// threads of a block; a host emulation runs blocks of one thread, for which
// its no-op __syncthreads() is right
#ifndef MRT_BOUNCE_THREADS
#define MRT_BOUNCE_THREADS 128
#endif

namespace {

__device__ __forceinline__ void store_pixel(int lane, const Lane& s, int rays,
                                            float* __restrict__ accum_out,
                                            int* __restrict__ count_out,
                                            int* __restrict__ rays_out) {
  accum_out[3 * lane] = s.accum.x;
  accum_out[3 * lane + 1] = s.accum.y;
  accum_out[3 * lane + 2] = s.accum.z;
  count_out[lane] = s.count;
  rays_out[lane] = rays;
}

// (threads, 1): with a minimum of one block an SM ptxas gives the kernel 84
// registers (5 blocks an SM) where it gives 77 without (6 blocks); the 84
// are 2% faster on the card (PERF.md section 6)
template <bool STAGED>
__global__ void __launch_bounds__(MRT_BOUNCE_THREADS, 1)
fused_render_kernel(Tables tb_in, RenderParams P, const int* __restrict__ pix_in,
                    float* __restrict__ accum_out, int* __restrict__ count_out,
                    int* __restrict__ rays_out, int* __restrict__ work) {
  MRT_DYNAMIC_SHARED(smem);
  Tables tb = tb_in;
  if (STAGED) tb = stage_tables(tb_in, P, smem);
  Lane s;
  s.accum = v3(0.0f, 0.0f, 0.0f);
  s.count = 0;
  int rays = 0;
  if (P.n_samples <= 0) {  // nothing to render: zeros
    for (int lane = claim_unit(work); lane < P.n; lane = claim_unit(work))
      store_pixel(lane, s, rays, accum_out, count_out, rays_out);
    return;
  }
  const ExtCand no_ext{};
  const Atlas no_atlas{};
  int lane = claim_unit(work);
  if (lane >= P.n) return;
  uint32_t pix = (uint32_t)pix_in[lane];
  start_sample(tb, P, pix, s);
  for (;;) {
    // ops/bounce.py::wave_step of this thread's pixel
    StepEnd end = bounce_step<false, false, false>(tb, P, s, rays, no_ext, no_atlas);
    if (end == STEP_DONE) {
      store_pixel(lane, s, rays, accum_out, count_out, rays_out);
      lane = claim_unit(work);
      if (lane >= P.n) return;
      pix = (uint32_t)pix_in[lane];
      s.accum = v3(0.0f, 0.0f, 0.0f);
      s.count = 0;
      rays = 0;
      end = STEP_NEXT_SAMPLE;
    }
    if (end == STEP_NEXT_SAMPLE) start_sample(tb, P, pix, s);
  }
}

template <bool STAGED>
Grid render_grid(const RenderParams& P) {
  return persistent_grid(fused_render_kernel<STAGED>, MRT_BOUNCE_THREADS,
                         STAGED ? stage_bytes(P) : 0, P.n);
}

}  // namespace

extern "C" {

// Launch the fused render on `stream`. Pointers are device pointers; `ip` is a
// host array of P_COUNT ints (physics.cuh: ParamIdx order); `work` is one int
// of device memory, the work counter, which this call zeroes on the stream.
// Returns the launch's cudaError_t (0 on success). Does not synchronise.
int mrt_fused_render(const float* sph, const float* rect, const float* tri, const float* box,
                     const float* vol, const float* mat, const float* tex, const float* cam,
                     const float* ptab, const int* pix, float* accum, int* count, int* rays,
                     const int* ip, float max_lum, void* stream, int* work) {
  Tables tb{sph, rect, tri, box, vol, mat, tex, cam, ptab};
  RenderParams P = read_render_params(ip, max_lum);
  if (P.n <= 0) return 0;
  cudaMemsetAsync(work, 0, sizeof(int), (cudaStream_t)stream);
  const int smem = stage_bytes(P);
  if (smem > 0) {
    const Grid g = render_grid<true>(P);
    MRT_LAUNCH(fused_render_kernel<true>, g.blocks, MRT_BOUNCE_THREADS, smem, stream, tb, P, pix,
               accum, count, rays, work);
  } else {
    const Grid g = render_grid<false>(P);
    MRT_LAUNCH(fused_render_kernel<false>, g.blocks, MRT_BOUNCE_THREADS, 0, stream, tb, P, pix,
               accum, count, rays, work);
  }
  return (int)cudaGetLastError();
}

// The grid mrt_fused_render launches for the parameter block `ip`: blocks an
// SM holds, SMs, blocks, threads a block, dynamic shared memory in bytes (0:
// the tables stay in global memory).
void mrt_fused_render_grid(const int* ip, int* out) {
  RenderParams P = read_render_params(ip, 0.0f);
  const int smem = stage_bytes(P);
  const Grid g = smem > 0 ? render_grid<true>(P) : render_grid<false>(P);
  out[0] = g.per_sm;
  out[1] = g.sms;
  out[2] = g.blocks;
  out[3] = MRT_BOUNCE_THREADS;
  out[4] = smem;
}

const char* mrt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
