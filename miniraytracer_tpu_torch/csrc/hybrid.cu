// The step kernels that take a hit candidate found outside them, for Hopper
// (sm_90a): the hybrid renderer's wave step, and further down the work queue's
// shade step.
//
// Replaces the TPU kernel `miniraytracer_tpu/ops/hybrid.py::_make_step_kernel`
// (launched by `_step_call`). It computes what that kernel computes: ONE wave
// step (`ops/bounce.py::wave_step`: bounce, miss/emit/throughput advance, draw2
// merge, regeneration) on every lane, with the nearest-hit sweep over the
// scene tables SEEDED by a candidate found outside the kernel. The candidate
// is the winner of the dense sweeps of flash.cu over the primitive sets that
// are too large for the tables (`ops/hybrid.py::_external_candidate`): rows
// (t, nx, ny, nz, mat_f), or in ext-material mode 11 rows that also carry the
// winner's material (mtype, mparam, albedo rgb, texel index), evaluated from
// the scene's full tables, because the kernel's own material tables then hold
// only what the in-table primitives use. The plain PyTorch version is
// `hybrid_step_plain` in `miniraytracer_tpu_torch/ops/hybrid.py`.
//
// Row contract (as the TPU kernel's): in f32 state (17, N) = accum(3) ro(3)
// rd(3) time beta(3) radiance(3) alive; i32 state (3, N) = count, inside,
// depth; key bits (N,); ray counter (N,) (i32 here, f32 there); pixel ids (N,);
// ext (5 or 11, N). Out: new state, keys and ray counter. A dead lane changes
// only its depth.
//
// Design. One thread per lane, 128-thread blocks: load the lane's 22 words and
// its candidate, run physics.cuh's `live_step` once if the lane is alive,
// store. ext / ext-material / image are template switches, so the instance
// without them is the code of the fused render. Two departures from the TPU
// shape: the image texel is fetched and multiplied into the throughput HERE
// (there the kernel reports a texel index as a float row and a gather between
// steps applies it), and the ray counter is an integer.
//
// What bounds it on this card: per-lane fp32 work of the shading (the
// in-table sweep is short: the big sets were swept outside) against 22 + 5 or
// 11 words read and 22 written per lane; at one step a launch the two are of
// the same order, and divergence between lanes of a warp comes on top.
//
// Build: nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a
//        --fmad=false (no --use_fast_math), see utils/kernels.py.

#include "physics.cuh"

// Threads a block of the shade step (the g++ host emulation runs blocks of
// one thread).
#ifndef MRT_SHADE_THREADS
#define MRT_SHADE_THREADS 128
#endif

namespace {

// state rows (ops/bounce.py: R_*, I_*)
constexpr int R_ACC = 0, R_RO = 3, R_RD = 6, R_TIME = 9, R_BETA = 10, R_RAD = 13, R_ALIVE = 16;
constexpr int I_COUNT = 0, I_INSIDE = 1, I_DEPTH = 2;

// appended to the render kernels' parameter block (physics.cuh: ParamIdx)
enum HybridParamIdx { H_EXT_MAT = P_COUNT, H_IMAGE, H_N_IMG, H_IH, H_IW, H_COUNT };

__device__ __forceinline__ V3 load_row3(const float* __restrict__ f, int row, int n, int lane) {
  return v3(f[(size_t)row * n + lane], f[(size_t)(row + 1) * n + lane],
            f[(size_t)(row + 2) * n + lane]);
}

__device__ __forceinline__ void store_row3(float* __restrict__ f, int row, int n, int lane, V3 v) {
  f[(size_t)row * n + lane] = v.x;
  f[(size_t)(row + 1) * n + lane] = v.y;
  f[(size_t)(row + 2) * n + lane] = v.z;
}

// a lane's candidate from its 5 (or, with EXT_MAT, 11) rows
template <bool EXT_MAT>
__device__ __forceinline__ ExtCand load_ext(const float* __restrict__ ext_in, int n, int lane) {
  ExtCand ext{};
  const float* e = ext_in + lane;
  ext.t = e[0];
  ext.nx = e[(size_t)n];
  ext.ny = e[(size_t)2 * n];
  ext.nz = e[(size_t)3 * n];
  ext.mat = e[(size_t)4 * n];
  if (EXT_MAT) {
    ext.mtype = e[(size_t)5 * n];
    ext.mparam = e[(size_t)6 * n];
    ext.ar = e[(size_t)7 * n];
    ext.ag = e[(size_t)8 * n];
    ext.ab = e[(size_t)9 * n];
    ext.img = e[(size_t)10 * n];
  }
  return ext;
}

template <bool EXT_MAT, bool IMAGE>
__global__ void __launch_bounds__(128)
hybrid_step_kernel(Tables tb, RenderParams P, Atlas atlas, const float* __restrict__ f_in,
                   const int* __restrict__ i_in, const uint32_t* __restrict__ k_in,
                   const int* __restrict__ rays_in, const int* __restrict__ pix_in,
                   const float* __restrict__ ext_in, float* __restrict__ f_out,
                   int* __restrict__ i_out, uint32_t* __restrict__ k_out,
                   int* __restrict__ rays_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = P.n;
  if (lane >= n) return;
  Lane s;
  s.accum = load_row3(f_in, R_ACC, n, lane);
  s.ro = load_row3(f_in, R_RO, n, lane);
  s.rd = load_row3(f_in, R_RD, n, lane);
  s.time = f_in[(size_t)R_TIME * n + lane];
  s.beta = load_row3(f_in, R_BETA, n, lane);
  s.rad = load_row3(f_in, R_RAD, n, lane);
  bool alive = f_in[(size_t)R_ALIVE * n + lane] > 0.0f;
  s.count = i_in[(size_t)I_COUNT * n + lane];
  s.inside = i_in[(size_t)I_INSIDE * n + lane];
  s.depth = i_in[(size_t)I_DEPTH * n + lane];
  s.key = k_in[lane];
  int rays = rays_in[lane];
  if (alive) {
    const ExtCand ext = load_ext<EXT_MAT>(ext_in, n, lane);
    alive = live_step<true, EXT_MAT, IMAGE>(tb, P, (uint32_t)pix_in[lane], s, rays, ext, atlas);
  } else {
    s.depth += 1;
  }
  store_row3(f_out, R_ACC, n, lane, s.accum);
  store_row3(f_out, R_RO, n, lane, s.ro);
  store_row3(f_out, R_RD, n, lane, s.rd);
  f_out[(size_t)R_TIME * n + lane] = s.time;
  store_row3(f_out, R_BETA, n, lane, s.beta);
  store_row3(f_out, R_RAD, n, lane, s.rad);
  f_out[(size_t)R_ALIVE * n + lane] = alive ? 1.0f : 0.0f;
  i_out[(size_t)I_COUNT * n + lane] = s.count;
  i_out[(size_t)I_INSIDE * n + lane] = s.inside;
  i_out[(size_t)I_DEPTH * n + lane] = s.depth;
  k_out[lane] = s.key;
  rays_out[lane] = rays;
}

// ---------------------------------------------------------------------------
// The work queue's shade step
// ---------------------------------------------------------------------------
// Replaces the TPU kernel `miniraytracer_tpu/ops/hybrid.py::_make_shade_kernel`
// (launched by `_shade_call`, for `make_workqueue_shader`). The work-queue
// renderer (`models/integrator.py::render_workqueue_pixels`) keeps claiming,
// merging and regeneration in tensor operations, because they are global
// (a prefix sum, a scatter); only the per-bounce shading is a kernel: the
// bounce with the outside candidate, sky or emission into the radiance, the
// scatter weight into the throughput, and whether the lane goes on. No merge,
// no regeneration, no camera. The plain PyTorch version is `shade_step_plain`
// in `miniraytracer_tpu_torch/ops/hybrid.py`.
//
// Row contract (as the TPU kernel's): in f32 (15, N) = ro(3) rd(3) time
// beta(3) radiance(3) depth_ok alive; inside (N,) i32; the key already folded
// with the depth (N,); ext (5 or 11, N). Out f32 (13, N) = cont p(3) new_rd(3)
// beta(3) radiance(3), and new_inside (N,) i32. p, new_rd and new_inside are
// zero where cont is 0; a dead lane keeps its throughput and radiance.
//
// Design. A persistent grid: as many 128-thread blocks as the card holds at
// once (the occupancy API x the SMs), no more than the lanes fill, each
// thread striding over the lanes. The first design, one thread a lane, ran
// earth's 131,072 lanes as 1,024 blocks in 1.1 waves, the last mostly
// empty; striding takes that tail (3% on earth; book2_final's 65,536 lanes
// fill half a wave, so there the grid is the same). A lane runs
// `shade_advance` of physics.cuh, so both steps shade with the same code.
// Measured and not kept (PERF.md section 6): a work counter as B1's and B2's
// (a lane is short, and the atomics of the warps' claims on one address
// cost more than the balance they buy: 11-15% slower than striding); the
// scene tables staged in shared memory (from 3% faster to 7% slower by
// build, with the float Perlin tables or packed ones: the register
// allocation moved more than the loads did); blocks of 64 or 256 threads,
// and of 256 only under a wave (within 1%). The image texel of a lane that
// goes on is fetched and multiplied into the throughput HERE; the TPU kernel
// emits a texel-index row and its caller gathers and multiplies after the
// launch. The TPU kernel's padding of the lanes to a multiple of 1024 and
// its (8, 128) tiling are not kept.
//
// What bounds it: as the hybrid step, per-lane fp32 work of the shading
// against 17 + 5 or 11 words read and 14 written per lane.

constexpr int SH_RO = 0, SH_RD = 3, SH_TIME = 6, SH_BETA = 7, SH_RAD = 10, SH_DOK = 13,
              SH_ALIVE = 14;
constexpr int SO_CONT = 0, SO_P = 1, SO_RD = 4, SO_BETA = 7, SO_RAD = 10;

// One lane of the shade step.
template <bool EXT_MAT, bool IMAGE>
__device__ __forceinline__ void shade_lane(const Tables& tb, const RenderParams& P,
                                           const Atlas& atlas, const float* __restrict__ f_in,
                                           const int* __restrict__ inside_in,
                                           const uint32_t* __restrict__ k_in,
                                           const float* __restrict__ ext_in,
                                           float* __restrict__ f_out, int* __restrict__ i_out,
                                           int lane) {
  const int n = P.n;
  V3 beta = load_row3(f_in, SH_BETA, n, lane);
  V3 rad = load_row3(f_in, SH_RAD, n, lane);
  bool cont = false;
  V3 p = v3(0.0f, 0.0f, 0.0f), new_rd = v3(0.0f, 0.0f, 0.0f);
  int new_inside = 0;
  if (f_in[(size_t)SH_ALIVE * n + lane] > 0.0f) {
    const ExtCand ext = load_ext<EXT_MAT>(ext_in, n, lane);
    Bounce b;
    cont = shade_advance<true, EXT_MAT, IMAGE>(
        tb, P, load_row3(f_in, SH_RO, n, lane), load_row3(f_in, SH_RD, n, lane),
        f_in[(size_t)SH_TIME * n + lane], inside_in[lane], k_in[lane],
        f_in[(size_t)SH_DOK * n + lane] > 0.0f, ext, atlas, beta, rad, b);
    if (cont) {
      p = b.p;
      new_rd = b.new_rd;
      new_inside = b.new_inside;
    }
  }
  f_out[(size_t)SO_CONT * n + lane] = cont ? 1.0f : 0.0f;
  store_row3(f_out, SO_P, n, lane, p);
  store_row3(f_out, SO_RD, n, lane, new_rd);
  store_row3(f_out, SO_BETA, n, lane, beta);
  store_row3(f_out, SO_RAD, n, lane, rad);
  i_out[lane] = new_inside;
}

template <bool EXT_MAT, bool IMAGE>
__global__ void __launch_bounds__(MRT_SHADE_THREADS)
shade_step_kernel(Tables tb, RenderParams P, Atlas atlas, const float* __restrict__ f_in,
                  const int* __restrict__ inside_in, const uint32_t* __restrict__ k_in,
                  const float* __restrict__ ext_in, float* __restrict__ f_out,
                  int* __restrict__ i_out) {
  for (int lane = blockIdx.x * blockDim.x + threadIdx.x; lane < P.n;
       lane += gridDim.x * blockDim.x)
    shade_lane<EXT_MAT, IMAGE>(tb, P, atlas, f_in, inside_in, k_in, ext_in, f_out, i_out, lane);
}

// The kernel instance and the grid mrt_shade_step launches for the
// parameter block `ip`.
using ShadeKernel = void (*)(Tables, RenderParams, Atlas, const float*, const int*,
                             const uint32_t*, const float*, float*, int*);

ShadeKernel shade_kernel(const int* ip) {
  const bool em = ip[H_EXT_MAT] != 0, im = ip[H_IMAGE] != 0;
  return em ? (im ? shade_step_kernel<true, true> : shade_step_kernel<true, false>)
            : (im ? shade_step_kernel<false, true> : shade_step_kernel<false, false>);
}

Grid shade_grid(ShadeKernel kernel, int n) {
  return persistent_grid(kernel, MRT_SHADE_THREADS, 0, n);
}

}  // namespace

extern "C" {

// Launch one hybrid step on `stream`. Pointers are device pointers; `images`
// is the atlas (n_img, ih, iw) of u32 texels; `ip` is a host array of H_COUNT
// ints (the render kernels' block, then ext_mat, image, n_img, ih, iw).
// Returns the launch's cudaError_t (0 on success). Does not synchronise.
int mrt_hybrid_step(const float* sph, const float* rect, const float* tri, const float* box,
                    const float* vol, const float* mat, const float* tex, const float* cam,
                    const float* ptab, const uint32_t* images, const float* f_in,
                    const int* i_in, const uint32_t* k_in, const int* rays_in, const int* pix,
                    const float* ext, float* f_out, int* i_out, uint32_t* k_out, int* rays_out,
                    const int* ip, float max_lum, void* stream) {
  Tables tb{sph, rect, tri, box, vol, mat, tex, cam, ptab};
  RenderParams P = read_render_params(ip, max_lum);
  Atlas atlas{images, ip[H_N_IMG], ip[H_IH], ip[H_IW]};
  if (P.n <= 0) return 0;
  const int threads = 128;
  const int blocks = (P.n + threads - 1) / threads;
  const bool em = ip[H_EXT_MAT] != 0, im = ip[H_IMAGE] != 0;
  auto kernel = em ? (im ? hybrid_step_kernel<true, true> : hybrid_step_kernel<true, false>)
                   : (im ? hybrid_step_kernel<false, true> : hybrid_step_kernel<false, false>);
  MRT_LAUNCH(kernel, blocks, threads, 0, stream, tb, P, atlas, f_in, i_in, k_in, rays_in, pix,
             ext, f_out, i_out, k_out, rays_out);
  return (int)cudaGetLastError();
}

// Launch one shade step on `stream`: pointers as `mrt_hybrid_step`'s, the lane
// rows as the row contract above says; of `ip` the lane count, the scene's
// dimensions and the five appended words are read.
int mrt_shade_step(const float* sph, const float* rect, const float* tri, const float* box,
                   const float* vol, const float* mat, const float* tex, const float* cam,
                   const float* ptab, const uint32_t* images, const float* f_in,
                   const int* inside_in, const uint32_t* k_in, const float* ext, float* f_out,
                   int* i_out, const int* ip, void* stream) {
  Tables tb{sph, rect, tri, box, vol, mat, tex, cam, ptab};
  RenderParams P = read_render_params(ip, 0.0f);
  Atlas atlas{images, ip[H_N_IMG], ip[H_IH], ip[H_IW]};
  if (P.n <= 0) return 0;
  const ShadeKernel kernel = shade_kernel(ip);
  const Grid g = shade_grid(kernel, P.n);
  MRT_LAUNCH(kernel, g.blocks, MRT_SHADE_THREADS, 0, stream, tb, P, atlas, f_in, inside_in, k_in,
             ext, f_out, i_out);
  return (int)cudaGetLastError();
}

// The grid mrt_shade_step launches for the parameter block `ip`: blocks an
// SM holds, SMs, blocks, threads a block, dynamic shared memory in bytes
// (always 0: the tables stay in global memory).
void mrt_shade_step_grid(const int* ip, int* out) {
  const Grid g = shade_grid(shade_kernel(ip), ip[P_N]);
  out[0] = g.per_sm;
  out[1] = g.sms;
  out[2] = g.blocks;
  out[3] = MRT_SHADE_THREADS;
  out[4] = 0;
}

const char* mrt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
