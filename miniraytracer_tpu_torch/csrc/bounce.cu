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
// The per-bounce physics lives in physics.cuh, shared with bounce_ad.cu.
//
// Build: nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a
//        --fmad=false (no --use_fast_math), see utils/kernels.py.

#include "physics.cuh"

namespace {

// Integer parameter block, in the order ops/bounce.py::_launch_kernel packs it.
enum ParamIdx {
  P_N, P_WIDTH, P_HEIGHT, P_SQ, P_MAX_BOUNCES, P_SAMPLE_LO, P_N_SAMPLES,
  P_S, P_R, P_TC, P_BX, P_V, P_M, P_X, P_NLIGHTS,
  P_LTYPE, P_LIDX = P_LTYPE + MAX_LIGHTS, P_USE_SKY = P_LIDX + MAX_LIGHTS,
  P_EXACT_COS, P_PERLIN, P_COUNT
};
static_assert(P_COUNT == 26, "parameter block size");

struct Params : SceneDims {
  int n, width, height, sq, max_bounces, sample_lo, n_samples;
  float max_lum;
};

struct Lane {
  V3 accum, ro, rd, beta, rad;
  float time;
  int count, inside, depth;
  uint32_t key;
};

// start absolute sample `sample_lo + count` of pixel `pix` (regeneration)
__device__ __forceinline__ void start_sample(const Tables& tb, const Params& P, uint32_t pix,
                                             Lane& s) {
  int samp = P.sample_lo + s.count;
  s.key = ray_key(pix, (uint32_t)samp);
  int ci = min(max(samp, 0), P.sq * P.sq - 1);
  float off_x = ((float)(ci / P.sq) + 0.5f) / (float)P.sq;
  float off_y = ((float)(ci % P.sq) + 0.5f) / (float)P.sq;
  float xpix = (float)(pix % (uint32_t)P.width);
  float ypix = (float)(pix / (uint32_t)P.width);
  float ss = (xpix + off_x) / (float)P.width;
  float tt = (ypix + off_y) / (float)P.height;
  camera_ray(tb.cam, ss, tt, s.key, s.ro, s.rd, s.time);
  s.inside = 0;
  s.beta = v3(1.0f, 1.0f, 1.0f);
  s.rad = v3(0.0f, 0.0f, 0.0f);
  s.depth = 0;
}

__global__ void __launch_bounds__(128)
fused_render_kernel(Tables tb, Params P, const int* __restrict__ pix_in,
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
  while (alive) {
    // one wave step (ops/bounce.py::wave_step) on a live lane
    ++rays;
    uint32_t keys_b = fold(s.key, (uint32_t)s.depth);
    bool depth_ok = s.depth < P.max_bounces;
    Bounce b = bounce_physics(tb, P, s.ro, s.rd, s.time, s.inside, keys_b);
    bool scattered = depth_ok && !b.is_light;
    bool add_emitted = !(scattered && b.is_specular);
    if (!b.hit) {
      // sky gradient or black (main.cpp:110-116); black is still multiplied
      // in, as in the plain version, so a non-finite throughput shows
      V3 bg = v3(0.0f, 0.0f, 0.0f);
      if (P.use_sky) {
        float tsky = 0.5f * (s.rd.y + 1.0f);
        bg = v3((1.0f - tsky) + tsky * 0.5f, (1.0f - tsky) + tsky * 0.7f,
                (1.0f - tsky) + tsky * 1.0f);
      }
      s.rad = s.rad + s.beta * bg;
    } else if (add_emitted) {
      s.rad = s.rad + s.beta * b.emitted;
    }
    bool cont = b.hit && scattered;
    if (cont) {
      s.beta = s.beta * b.weight;
      cont = s.beta.x > 0.0f || s.beta.y > 0.0f || s.beta.z > 0.0f;
    }
    if (cont) {
      s.ro = b.p;
      s.rd = b.new_rd;
      s.inside = b.new_inside;
      s.depth += 1;
      continue;
    }
    // finished: draw2 merge with NaN reuse and luminance clamp
    float cnt_f = (float)s.count;
    bool has_prev = s.count > 0;
    float inv_prev = 1.0f / fmaxf(cnt_f, 1.0f);
    V3 prev_avg = has_prev ? s.accum * inv_prev : v3(0.0f, 0.0f, 0.0f);
    bool finite = isfinite(s.rad.x) && isfinite(s.rad.y) && isfinite(s.rad.z);
    V3 color = finite ? s.rad : prev_avg;
    V3 new_avg = has_prev ? prev_avg + (color - prev_avg) * (1.0f / (cnt_f + 1.0f)) : color;
    float lum = 0.212655f * new_avg.x + 0.715158f * new_avg.y + 0.072187f * new_avg.z;
    float lscale = lum > P.max_lum ? P.max_lum / fmaxf(lum, 1e-12f) : 1.0f;
    new_avg = new_avg * lscale;
    s.accum = new_avg * (cnt_f + 1.0f);
    s.count += 1;
    alive = s.count < P.n_samples;
    if (alive) start_sample(tb, P, pix, s);
  }
  accum_out[3 * lane] = s.accum.x;
  accum_out[3 * lane + 1] = s.accum.y;
  accum_out[3 * lane + 2] = s.accum.z;
  count_out[lane] = s.count;
  rays_out[lane] = rays;
}

}  // namespace

extern "C" {

// Launch the fused render on `stream`. Pointers are device pointers; `ip` is a
// host array of P_COUNT ints (ParamIdx order). Returns the launch's
// cudaError_t (0 on success). Does not synchronise.
int mrt_fused_render(const float* sph, const float* rect, const float* tri, const float* box,
                     const float* vol, const float* mat, const float* tex, const float* cam,
                     const float* ptab, const int* pix, float* accum, int* count, int* rays,
                     const int* ip, float max_lum, void* stream) {
  Tables tb{sph, rect, tri, box, vol, mat, tex, cam, ptab};
  Params P;
  P.n = ip[P_N];
  P.width = ip[P_WIDTH];
  P.height = ip[P_HEIGHT];
  P.sq = ip[P_SQ];
  P.max_bounces = ip[P_MAX_BOUNCES];
  P.sample_lo = ip[P_SAMPLE_LO];
  P.n_samples = ip[P_N_SAMPLES];
  P.S = ip[P_S];
  P.R = ip[P_R];
  P.Tc = ip[P_TC];
  P.Bx = ip[P_BX];
  P.V = ip[P_V];
  P.M = ip[P_M];
  P.X = ip[P_X];
  P.n_lights = ip[P_NLIGHTS];
  for (int i = 0; i < MAX_LIGHTS; ++i) {
    P.ltype[i] = ip[P_LTYPE + i];
    P.lidx[i] = ip[P_LIDX + i];
  }
  P.use_sky = ip[P_USE_SKY];
  P.exact_cos = ip[P_EXACT_COS];
  P.perlin = ip[P_PERLIN];
  P.max_lum = max_lum;
  if (P.n <= 0) return 0;
  const int threads = 128;
  const int blocks = (P.n + threads - 1) / threads;
  MRT_LAUNCH(fused_render_kernel, blocks, threads, 0, stream, tb, P, pix, accum, count, rays);
  return (int)cudaGetLastError();
}

const char* mrt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
