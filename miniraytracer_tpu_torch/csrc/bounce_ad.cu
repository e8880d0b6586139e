// The differentiable scan step for Hopper (sm_90a): forward kernel and its
// hand-derived backward.
//
// Replaces the two TPU kernels of `miniraytracer_tpu/ops/bounce_ad.py`:
// `_make_fwd_kernel` (launched by `run_fwd`) and `_make_bwd_kernel` (launched
// by `run_bwd`). One lane is one pixel tracing its samples one after the
// other; the lane state is (rows, N) tensors (19 float rows, 3 int rows, the
// path key).
//
// mrt_ad_step_fwd runs `k_sub` sub-steps of `_pixel_step_math`: one bounce
// (physics.cuh, the same device function the fused render uses), the fold of
// a finished finite sample into (sum, nvalid), and regeneration of the lane
// with its next sample while the claim window is open.
//
// Scenes outside the fused class (ops/hybrid.py: big sphere, triangle and box
// sets, more materials than the tables hold, image textures) take the step in
// its ext modes, one sub-step a launch, as the hybrid step kernel does: EXT,
// an (NE, n) candidate from outside seeds the nearest-hit sweep and is a
// DIFFERENTIABLE input (its cotangent `d_ext` comes out of the backward, row
// by row, one thread a lane); EXT_MAT, the candidate brings its material
// (NE = 11); IMAGE, the image texel of a lane that goes on is fetched here and
// multiplied into its throughput (the TPU kernel reports the texel index and
// the scan multiplies it in between launches). Both kernels are templates over
// the three switches; with all three off they are the fused class's kernels.
//
// mrt_ad_step_bwd is the vector-Jacobian product of those sub-steps. The TPU
// kernel gets it from `jax.vjp` traced inside the kernel; here the adjoint is
// written out. Every discrete choice (which primitive wins, material and
// texture type, light picked, light or material lobe, reflect or refract,
// front or back face, checker parity, every comparison) is piecewise
// constant: a select passes zero to the branch not taken. So a thread replays
// the sub-steps from the saved entry state (the counter-based RNG makes the
// replay exact), keeps each sub-step's entry state and bounce record, then
// walks them backwards and differentiates only the chain the lane took:
// t(winner) -> p -> normal -> albedo/emitted -> direction and pdf -> weight,
// new direction -> throughput, radiance, sum. Guards keep their meaning: the
// masked side of a guarded sqrt or division gets a zero cotangent, never
// 0*inf. At a tie of max/min/clamp/abs (measure zero) this code takes the
// zero or one-sided derivative where JAX would split it.
//
// Cotangents of the differentiable table entries (sphere centres and radii,
// triangle base vertices, material parameters, texture colours; the order of
// `ops/bounce_ad.py::diff_indices`) are summed over lanes: each lane adds the
// few entries its path touched to a per-block shared-memory array with
// atomicAdd, and the block adds its non-zero entries to the global vector
// with one atomicAdd each. The TPU kernel carried one accumulator across a
// sequential grid; blocks here run in any order, and a (blocks, n_diff)
// buffer would cost a second pass per launch. Float atomics make the sums
// differ from run to run at about 1e-6 relative.
//
// What bounds them on this card: per-lane ALU work and warp divergence, as in
// the fused render; the state traffic (19+3+1 words in and out per lane per
// launch, 13+3+1+19 in and 19 out for the backward) is what `k_sub` sub-steps
// per launch amortise. The backward keeps `k_sub` entry states and bounce
// records in local memory. One thread per lane, 128-thread blocks.
//
// Build: as bounce.cu (utils/kernels.py), --fmad=false so that the replay
// takes the decisions the plain version takes.

#include "physics.cuh"

#ifndef MRT_AD_THREADS
#define MRT_AD_THREADS 128
#endif

namespace {

constexpr int NF = 19, NJ = 3, NRES = 13;
// float rows (ops/bounce_ad.py A_*)
constexpr int A_SUM = 0, A_RO = 3, A_RD = 6, A_TIME = 9, A_BETA = 10, A_RAD = 13, A_ALIVE = 16,
              A_NV = 17, A_RAYS = 18;
constexpr int MAX_KSUB = 8;
// candidate rows (ops/hybrid.py NE, NE_MAT): t, nx, ny, nz, mat_f, then in
// ext-material mode mtype, mparam, albedo r g b, texel index
constexpr int E_T = 0, E_N = 1, E_MAT = 4, E_MTYPE = 5, E_MPARAM = 6, E_ALB = 7, E_IMG = 10;
constexpr int NE = 5, NE_MAT = 11;
// 4 per sphere, 3 per triangle, 1 per material, 6 per texture at the caps
constexpr int MAX_NDIFF = 4 * 64 + 3 * 64 + 24 + 6 * 24;

// Integer parameter block, in the order ops/bounce_ad.py::kernel_params packs it.
enum AdParamIdx {
  Q_N, Q_WIDTH, Q_HEIGHT, Q_SQ_OFF, Q_MAX_BOUNCES, Q_SPP, Q_CLAIM_LIMIT, Q_KSUB, Q_TSTEP,
  Q_S, Q_R, Q_TC, Q_BX, Q_V, Q_M, Q_X, Q_NLIGHTS,
  Q_LTYPE, Q_LIDX = Q_LTYPE + MAX_LIGHTS, Q_USE_SKY = Q_LIDX + MAX_LIGHTS,
  Q_EXACT_COS, Q_PERLIN, Q_COUNT
};
static_assert(Q_COUNT == 28, "parameter block size");

// The ext-mode block, in the order ops/bounce_ad.py::ext_params packs it: the
// three switches and the image atlas's shape.
enum AdExtIdx { X_EXT, X_EXT_MAT, X_IMAGE, X_N_IMG, X_IH, X_IW, X_COUNT };
static_assert(X_COUNT == 6, "ext parameter block size");

struct AdParams : SceneDims {
  int n, width, height, sq_off, max_bounces, spp, claim_limit, k_sub, t_step;
};

// the part of the lane state that the step reads (sum, nvalid and rays enter
// additively and are carried beside it)
struct LaneState {
  V3 ro, rd, beta, rad;
  float time;
  bool alive;
  int count, inside, depth;
  uint32_t key;
};

// what the adjoint needs of one sub-step besides its entry state
struct SubRec {
  Bounce b;
  uint32_t keys_b;
  bool cont0, cont, take, regen, emit;
};

__device__ __forceinline__ V3 sky(float rdy) {
  float tsky = 0.5f * (rdy + 1.0f);
  return v3((1.0f - tsky) + tsky * 0.5f, (1.0f - tsky) + tsky * 0.7f,
            (1.0f - tsky) + tsky * 1.0f);
}

// One sub-step (ops/bounce_ad.py::_pixel_step_math) at global step `t_global`.
template <bool EXT, bool EXT_MAT, bool IMAGE>
__device__ void ad_substep(const Tables& tb, const AdParams& P, const ExtCand& ext,
                           const Atlas& atlas, uint32_t pix, int sampbase, int t_global,
                           LaneState& s, V3& summ, float& nvalid, float& rays, SubRec* rec) {
  if (!s.alive) {  // a dead lane changes only its depth
    s.depth += 1;
    return;
  }
  rays = rays + 1.0f;
  uint32_t keys_b = fold(s.key, (uint32_t)s.depth);
  bool depth_ok = s.depth < P.max_bounces;
  Bounce b =
      bounce_physics_t<EXT, EXT_MAT, IMAGE>(tb, P, s.ro, s.rd, s.time, s.inside, keys_b, ext, atlas);
  bool scattered = depth_ok && !b.is_light;
  bool add_emitted = !(scattered && b.is_specular);
  if (!b.hit) {
    // black is still multiplied in, so a non-finite throughput shows
    V3 bg = P.use_sky ? sky(s.rd.y) : v3(0.0f, 0.0f, 0.0f);
    s.rad = s.rad + s.beta * bg;
  } else if (add_emitted) {
    s.rad = s.rad + s.beta * b.emitted;
  }
  bool cont0 = b.hit && scattered;
  bool cont = cont0;
  if (cont0) {
    s.beta = s.beta * b.weight;
    cont = s.beta.x > 0.0f || s.beta.y > 0.0f || s.beta.z > 0.0f;
  }
  V3 texel;
  if (IMAGE && cont && pending_texel(atlas, b, texel)) s.beta = s.beta * texel;
  bool take = false, regen = false;
  if (!cont) {
    // finished: fold the sample under the all-channel finite mask
    take = isfinite(s.rad.x) && isfinite(s.rad.y) && isfinite(s.rad.z);
    if (take) {
      summ = summ + s.rad;
      nvalid = nvalid + 1.0f;
    }
    s.count += 1;
    // claim the next sample while the claim window is open
    regen = s.count < P.spp && t_global < P.claim_limit;
  }
  if (rec) {
    rec->b = b;
    rec->keys_b = keys_b;
    rec->cont0 = cont0;
    rec->cont = cont;
    rec->take = take;
    rec->regen = regen;
    rec->emit = b.hit && add_emitted;
  }
  if (regen) {
    int samp = sampbase + s.count;
    s.key = ray_key(pix, (uint32_t)samp);
    int ci = samp % (P.sq_off * P.sq_off);
    float off_x = ((float)(ci / P.sq_off) + 0.5f) / (float)P.sq_off;
    float off_y = ((float)(ci % P.sq_off) + 0.5f) / (float)P.sq_off;
    float xpix = (float)(pix % (uint32_t)P.width);
    float ypix = (float)(pix / (uint32_t)P.width);
    float ss = (xpix + off_x) / (float)P.width;
    float tt = (ypix + off_y) / (float)P.height;
    camera_ray(tb.cam, ss, tt, s.key, s.ro, s.rd, s.time);
    s.inside = 0;
    s.beta = v3(1.0f, 1.0f, 1.0f);
    s.rad = v3(0.0f, 0.0f, 0.0f);
    s.depth = 0;
  } else if (cont) {
    s.ro = b.p;
    s.rd = b.new_rd;
    s.inside = b.new_inside;
    s.depth += 1;
  } else {
    s.depth += 1;
    s.alive = false;
  }
}

__device__ __forceinline__ LaneState load_state(const float* __restrict__ f, int stride,
                                                const int* __restrict__ ist,
                                                const int* __restrict__ keys, int n, int lane) {
  // `f` points at the row of ro.x; rows are `stride` apart
  LaneState s;
  s.ro = v3(f[0 * stride + lane], f[1 * stride + lane], f[2 * stride + lane]);
  s.rd = v3(f[3 * stride + lane], f[4 * stride + lane], f[5 * stride + lane]);
  s.time = f[6 * stride + lane];
  s.beta = v3(f[7 * stride + lane], f[8 * stride + lane], f[9 * stride + lane]);
  s.rad = v3(f[10 * stride + lane], f[11 * stride + lane], f[12 * stride + lane]);
  s.alive = f[13 * stride + lane] > 0.0f;
  s.count = ist[lane];
  s.inside = ist[n + lane];
  s.depth = ist[2 * n + lane];
  s.key = (uint32_t)keys[lane];
  return s;
}

__device__ __forceinline__ void store3(float* __restrict__ f, int row, int n, int lane, V3 a) {
  f[row * n + lane] = a.x;
  f[(row + 1) * n + lane] = a.y;
  f[(row + 2) * n + lane] = a.z;
}

template <bool EXT, bool EXT_MAT>
__device__ __forceinline__ ExtCand load_ext(const float* __restrict__ e, int n, int lane) {
  ExtCand c{};
  if (EXT) {
    c.t = e[E_T * n + lane];
    c.nx = e[E_N * n + lane];
    c.ny = e[(E_N + 1) * n + lane];
    c.nz = e[(E_N + 2) * n + lane];
    c.mat = e[E_MAT * n + lane];
  }
  if (EXT_MAT) {
    c.mtype = e[E_MTYPE * n + lane];
    c.mparam = e[E_MPARAM * n + lane];
    c.ar = e[E_ALB * n + lane];
    c.ag = e[(E_ALB + 1) * n + lane];
    c.ab = e[(E_ALB + 2) * n + lane];
    c.img = e[E_IMG * n + lane];
  }
  return c;
}

// ---------------------------------------------------------------------------
// B2: the forward step
// ---------------------------------------------------------------------------

template <bool EXT, bool EXT_MAT, bool IMAGE>
__global__ void __launch_bounds__(MRT_AD_THREADS)
ad_step_fwd_kernel(Tables tb, AdParams P, Atlas atlas, const float* __restrict__ f_in,
                   const int* __restrict__ i_in, const int* __restrict__ k_in,
                   const int* __restrict__ pix_in, const int* __restrict__ sb_in,
                   const float* __restrict__ ext_in, float* __restrict__ f_out,
                   int* __restrict__ i_out, int* __restrict__ k_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = P.n;
  if (lane >= n) return;
  const uint32_t pix = (uint32_t)pix_in[lane];
  const int sampbase = sb_in[lane];
  LaneState s = load_state(f_in + A_RO * n, n, i_in, k_in, n, lane);
  V3 summ = v3(f_in[lane], f_in[n + lane], f_in[2 * n + lane]);
  float nvalid = f_in[A_NV * n + lane];
  float rays = f_in[A_RAYS * n + lane];
  const ExtCand ext = load_ext<EXT, EXT_MAT>(ext_in, n, lane);
  for (int j = 0; j < P.k_sub; ++j)
    ad_substep<EXT, EXT_MAT, IMAGE>(tb, P, ext, atlas, pix, sampbase, P.t_step * P.k_sub + j,
                                    s, summ, nvalid, rays, nullptr);
  store3(f_out, A_SUM, n, lane, summ);
  store3(f_out, A_RO, n, lane, s.ro);
  store3(f_out, A_RD, n, lane, s.rd);
  f_out[A_TIME * n + lane] = s.time;
  store3(f_out, A_BETA, n, lane, s.beta);
  store3(f_out, A_RAD, n, lane, s.rad);
  f_out[A_ALIVE * n + lane] = s.alive ? 1.0f : 0.0f;
  f_out[A_NV * n + lane] = nvalid;
  f_out[A_RAYS * n + lane] = rays;
  i_out[lane] = s.count;
  i_out[n + lane] = s.inside;
  i_out[2 * n + lane] = s.depth;
  k_out[lane] = (int)s.key;
}

// ---------------------------------------------------------------------------
// B3: the adjoint
// ---------------------------------------------------------------------------

__device__ __forceinline__ void acc(float* dt, int i, float v) {
  if (v != 0.0f) atomicAdd(dt + i, v);
}

__device__ __forceinline__ void acc3(float* dt, int i, V3 v) {
  acc(dt, i, v.x);
  acc(dt, i + 1, v.y);
  acc(dt, i + 2, v.z);
}

// offsets into the flat table cotangent (ops/bounce_ad.py::diff_indices)
struct DiffBase {
  int sph_rad, tri, mat, tex_c0, tex_c1;
};

__device__ __forceinline__ DiffBase diff_base(const SceneDims& P) {
  DiffBase d;
  d.sph_rad = 3 * P.S;
  d.tri = 4 * P.S;
  d.mat = d.tri + 3 * P.Tc;
  d.tex_c0 = d.mat + P.M;
  d.tex_c1 = d.tex_c0 + 3 * P.X;
  return d;
}

// Cotangent of the candidate from outside (rows E_T, E_N, E_MPARAM, E_ALB; the
// material id, the material type and the texel index are discrete: zero).
struct ExtCot {
  float t, mparam;
  V3 n, alb;
};

// a -> normalize(a): cotangent of a from the cotangent of the result
__device__ __forceinline__ V3 normalize_bwd(V3 a, V3 g) {
  float n2 = dot(a, a);
  if (!(n2 > 1e-20f)) return v3(0.0f, 0.0f, 0.0f);
  float inv = 1.0f / sqrtf(n2);
  return g * inv - a * (dot(g, a) * (inv * inv * inv));
}

// (u, v) = onb_from_w(n): adds the cotangent of n
__device__ __forceinline__ V3 onb_bwd(V3 n, V3 g_u, V3 g_v) {
  bool big_x = fabsf(n.x) > 0.9f;
  V3 a = v3(big_x ? 0.0f : 1.0f, big_x ? 1.0f : 0.0f, 0.0f);
  V3 c = cross(n, a);
  V3 v = normalize(c);
  // u = n x v
  V3 g_n = cross(v, g_u);
  V3 g_vt = g_v + cross(g_u, n);
  // v = normalize(n x a)
  V3 g_c = normalize_bwd(c, g_vt);
  return g_n + cross(a, g_c);
}

// refl = rd - nrm * (2 * dot(rd, nrm))
__device__ __forceinline__ void reflect_bwd(V3 rd, V3 nrm, V3 g_refl, V3& g_rd, V3& g_nrm) {
  float k = 2.0f * dot(rd, nrm);
  float g_dot = 2.0f * (-dot(g_refl, nrm));
  g_rd = g_rd + g_refl + nrm * g_dot;
  g_nrm = g_nrm + g_refl * (-k) + rd * g_dot;
}

// cotangent of a sphere's centre at `time`: c0 gets (1 - fmv), time gets the
// motion term
__device__ __forceinline__ void sphere_center_bwd(const float* __restrict__ sph, int S, int si,
                                                  float time, V3 g_cen, float* dt,
                                                  float& d_time) {
  V3 c0, c1;
  float fmv;
  sphere_center(sph, S, si, time, c0, c1, fmv);
  acc3(dt, 3 * si, g_cen * (1.0f - fmv));
  int o = 6 * S;
  float t0s = sph[o + si], t1s = sph[o + S + si], mov = sph[o + 2 * S + si];
  if (mov > 0) d_time = d_time + dot(g_cen, c1 - c0) / (t1s - t0s);
}

// signed turbulence sum (before the abs) and its gradient w.r.t. the point
__device__ float turbulence_grad(const float* __restrict__ ptab, V3 p, V3& grad) {
  float acc_t = 0.0f;
  float weight = 1.0f, scale = 1.0f;
  float c[3] = {p.x, p.y, p.z};
  float g[3] = {0.0f, 0.0f, 0.0f};
  for (int oct = 0; oct < PERLIN_DEPTH; ++oct) {
    int ic[3];
    float fr[3], h[3], dh[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float pf = floorf(c[a]);
      fr[a] = c[a] - pf;
      h[a] = fr[a] * fr[a] * (3.0f - 2.0f * fr[a]);
      dh[a] = 6.0f * fr[a] * (1.0f - fr[a]);
      ic[a] = (int)pf;
    }
    int pv[6];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pv[2 * a] = (int)ptab[a * 256 + (ic[a] & 255)];
      pv[2 * a + 1] = (int)ptab[a * 256 + ((ic[a] + 1) & 255)];
    }
    float accn = 0.0f;
    float dacc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int di = 0; di < 2; ++di) {
      float ax = di ? h[0] : 1.0f - h[0];
      float dax = di ? dh[0] : -dh[0];
      float wx = fr[0] - (float)di;
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        float ay = dj ? h[1] : 1.0f - h[1];
        float day = dj ? dh[1] : -dh[1];
        float wy = fr[1] - (float)dj;
#pragma unroll
        for (int dk = 0; dk < 2; ++dk) {
          float az = dk ? h[2] : 1.0f - h[2];
          float daz = dk ? dh[2] : -dh[2];
          float wz = fr[2] - (float)dk;
          int gi = pv[di] ^ pv[2 + dj] ^ pv[4 + dk];
          float gx = ptab[3 * 256 + gi], gy = ptab[4 * 256 + gi], gz = ptab[5 * 256 + gi];
          float d = gx * wx + gy * wy + gz * wz;
          accn = accn + ax * ay * az * d;
          dacc[0] = dacc[0] + (dax * ay * az * d + ax * ay * az * gx);
          dacc[1] = dacc[1] + (ax * day * az * d + ax * ay * az * gy);
          dacc[2] = dacc[2] + (ax * ay * daz * d + ax * ay * az * gz);
        }
      }
    }
    acc_t = acc_t + weight * accn;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      g[a] = g[a] + (weight * scale) * dacc[a];
      c[a] = c[a] * 2.0f;
    }
    weight *= 0.5f;
    scale *= 2.0f;
  }
  grad = v3(g[0], g[1], g[2]);
  return acc_t;
}

// transpose of the rotate_y of boxes: local-frame cotangent -> world frame
__device__ __forceinline__ V3 unrotate(float sinb, float cosb, const float g[3]) {
  return v3(cosb * g[0] + sinb * g[2], g[1], cosb * g[2] - sinb * g[0]);
}

// t = (bound - bl[a]) * slab_inv(bd[a]) of a rotated box: cotangents of the
// world-frame ro - offset and rd
__device__ __forceinline__ void slab_bwd(float sinb, float cosb, V3 rol, V3 rd, int a,
                                         float bound, float g_t, V3& d_ro, V3& d_rd) {
  float bl[3] = {cosb * rol.x - sinb * rol.z, rol.y, cosb * rol.z + sinb * rol.x};
  float bd[3] = {cosb * rd.x - sinb * rd.z, rd.y, cosb * rd.z + sinb * rd.x};
  float da = bd[a];
  float invd = slab_inv(da);
  float g_bl[3] = {0.0f, 0.0f, 0.0f}, g_bd[3] = {0.0f, 0.0f, 0.0f};
  g_bl[a] = -g_t * invd;
  float g_invd = g_t * (bound - bl[a]);
  g_bd[a] = fabsf(da) > 1e-12f ? -g_invd * invd * invd : 0.0f;
  d_ro = d_ro + unrotate(sinb, cosb, g_bl);
  d_rd = d_rd + unrotate(sinb, cosb, g_bd);
}

// roots t = -b -/+ sqrt(b*b - c) of a sphere about `cen` (root 0 front, 1
// back): cotangents of ro, rd, the centre and the radius
__device__ __forceinline__ void sphere_root_bwd(V3 ro, V3 rd, V3 cen, float rad, int root,
                                                float g_t, V3& d_ro, V3& d_rd, V3& g_cen,
                                                float& g_rad) {
  V3 oc = ro - cen;
  float b = dot(oc, rd);
  float c = dot(oc, oc) - rad * rad;
  float disc = b * b - c;
  float sqd = sqrtf(disc > 0.0f ? disc : 1.0f);
  float g_b = -g_t;
  float g_sqd = root ? g_t : -g_t;
  float g_disc = disc > 0.0f ? g_sqd * 0.5f / sqd : 0.0f;
  g_b = g_b + g_disc * 2.0f * b;
  float g_c = -g_disc;
  V3 g_oc = rd * g_b + oc * (2.0f * g_c);
  d_rd = d_rd + oc * g_b;
  g_rad = g_rad + g_c * (-2.0f * rad);
  d_ro = d_ro + g_oc;
  g_cen = g_cen - g_oc;
}

// Cotangents of the winner's hit distance and normal: p = ro + rd * t gets
// `g_p` (the normal's own hit point included), the normal gets `g_nrm`. A
// winner from outside passes both to its candidate rows.
template <bool EXT>
__device__ void geometry_adjoint(const Tables& tb, const SceneDims& P, const DiffBase& db,
                                 V3 ro, V3 rd, float time, int inside, const Bounce& b, V3 g_p,
                                 V3 g_nrm, V3& d_ro, V3& d_rd, float& d_time, float* dt,
                                 ExtCot& d_ext) {
  const int S = P.S, R = P.R, Tc = P.Tc, Bx = P.Bx, V = P.V;
  const float t = b.t;
  const int idx = b.w_idx;
  float g_t = 0.0f;
  if (EXT && b.w_kind == W_EXT) {
    d_ro = d_ro + g_p;
    d_rd = d_rd + g_p * t;
    d_ext.t = d_ext.t + dot(g_p, rd);
    d_ext.n = d_ext.n + g_nrm;
    return;
  }
  if (b.w_kind == W_SPHERE) {
    V3 c0, c1;
    float fmv;
    sphere_center(tb.sph, S, idx, time, c0, c1, fmv);
    float rad = tb.sph[9 * S + idx];
    V3 cen = v3(c0.x + fmv * (c1.x - c0.x), c0.y + fmv * (c1.y - c0.y),
                c0.z + fmv * (c1.z - c0.z));
    V3 p_hit = ro + rd * t;
    bool rad_ok = fabsf(rad) > 1e-20f;
    float ir = 1.0f / (rad_ok ? rad : 1.0f);
    V3 pc = p_hit - cen;
    V3 g_q = normalize_bwd(pc * ir, g_nrm);
    V3 g_phit = g_q * ir;
    float g_ir = dot(g_q, pc);
    float g_rad = rad_ok ? -g_ir * ir * ir : 0.0f;
    V3 g_cen = -g_phit;
    g_p = g_p + g_phit;
    d_ro = d_ro + g_p;
    d_rd = d_rd + g_p * t;
    g_t = dot(g_p, rd);
    sphere_root_bwd(ro, rd, cen, rad, b.w_sub, g_t, d_ro, d_rd, g_cen, g_rad);
    sphere_center_bwd(tb.sph, S, idx, time, g_cen, dt, d_time);
    acc(dt, db.sph_rad + idx, g_rad);
    return;
  }
  if (b.w_kind == W_TRI) {
    V3 mT = load3(tb.tri, 3 * idx), uT = load3(tb.tri, 3 * Tc + 3 * idx),
       vT = load3(tb.tri, 6 * Tc + 3 * idx);
    V3 mn = load3(tb.tri, 9 * Tc + 3 * idx), un = load3(tb.tri, 12 * Tc + 3 * idx),
       vn = load3(tb.tri, 15 * Tc + 3 * idx);
    V3 pv = cross(rd, vT);
    float det = dot(uT, pv);
    float sgn = (inside > 0 && det < 0.0f) ? -1.0f : 1.0f;
    float dets = det * sgn;
    V3 tv = ro - mT;
    float uu = dot(tv, pv) * sgn;
    V3 qv = cross(tv, uT);
    float vv = dot(rd, qv) * sgn;
    bool det_ok = dets > TRI_EPS;
    float safe_det = det_ok ? dets : 1.0f;
    float A = dot(vT, qv);
    float inv = 1.0f / safe_det;
    float uun = uu * inv, vvn = vv * inv;
    V3 m = mn * (1.0f - uun - vvn) + un * uun + vn * vvn;
    // the normal
    V3 g_m = normalize_bwd(m, g_nrm);
    float g_uun = dot(g_m, un - mn), g_vvn = dot(g_m, vn - mn);
    float g_uu = g_uun * inv, g_vv = g_vvn * inv;
    float g_inv = g_uun * uu + g_vvn * vv;
    float g_sd = -g_inv * inv * inv;
    // p = ro + rd * t
    d_ro = d_ro + g_p;
    d_rd = d_rd + g_p * t;
    g_t = dot(g_p, rd);
    // t = A / safe_det * sgn
    float g_A = g_t * sgn / safe_det;
    g_sd = g_sd - g_t * sgn * A / (safe_det * safe_det);
    float g_det = det_ok ? g_sd * sgn : 0.0f;
    V3 g_tv = pv * (g_uu * sgn);
    V3 g_pv = tv * (g_uu * sgn) + uT * g_det;
    d_rd = d_rd + qv * (g_vv * sgn);
    V3 g_qv = rd * (g_vv * sgn) + vT * g_A;
    g_tv = g_tv + cross(uT, g_qv);   // qv = tv x uT
    d_rd = d_rd + cross(vT, g_pv);   // pv = rd x vT
    d_ro = d_ro + g_tv;              // tv = ro - mT
    acc3(dt, db.tri + 3 * idx, -g_tv);
    return;
  }
  // constant normals from here on
  d_ro = d_ro + g_p;
  d_rd = d_rd + g_p * t;
  g_t = dot(g_p, rd);
  if (b.w_kind == W_RECT) {
    RectRow r = rect_row(tb.rect, R, idx);
    float dk = dot(r.ek, rd);
    bool dk_ok = fabsf(dk) > 1e-30f;
    float dk_safe = dk_ok ? dk : 1e-30f;
    d_ro = d_ro + r.ek * (-g_t / dk_safe);
    float g_dk = dk_ok ? -g_t * t / dk_safe : 0.0f;
    d_rd = d_rd + r.ek * g_dk;
  } else if (b.w_kind == W_BOX) {
    const float* box = tb.box;
    int a = b.w_sub >> 1, side = b.w_sub & 1;
    float bound = side ? box[3 * Bx + 3 * idx + a] : box[3 * idx + a];
    float sinb = box[6 * Bx + 2 * idx], cosb = box[6 * Bx + 2 * idx + 1];
    V3 rol = ro - load3(box, 8 * Bx + 3 * idx);
    slab_bwd(sinb, cosb, rol, rd, a, bound, g_t, d_ro, d_rd);
  } else if (b.w_kind == W_VOL) {
    // tvol = max(rec1, TMIN) + hit_dist: only the boundary entry rec1 moves
    const float* bp = tb.vol + 12 * idx;
    float btype = tb.vol[12 * V + idx];
    if (btype == (float)VOLB_SPHERE) {
      V3 cen = load3(bp, 0);
      V3 oc = ro - cen;
      float bq = dot(oc, rd);
      float disc = bq * bq - (dot(oc, oc) - bp[3] * bp[3]);
      float sqd = sqrtf(disc > 0.0f ? disc : 1.0f);
      float rec1 = b.w_sub ? -bq + sqd : -bq - sqd;
      if (rec1 > TMIN) {
        V3 g_cen = v3(0.0f, 0.0f, 0.0f);
        float g_rad = 0.0f;
        sphere_root_bwd(ro, rd, cen, bp[3], b.w_sub, g_t, d_ro, d_rd, g_cen, g_rad);
      }
    } else {
      int a = b.w_sub >> 1, side = b.w_sub & 1;
      float sin_t = bp[6], cos_t = bp[7];
      V3 rol = ro - load3(bp, 8);
      float bound = side ? bp[3 + a] : bp[a];
      float bla = a == 0 ? cos_t * rol.x - sin_t * rol.z
                         : (a == 1 ? rol.y : cos_t * rol.z + sin_t * rol.x);
      float bda = a == 0 ? cos_t * rd.x - sin_t * rd.z
                         : (a == 1 ? rd.y : cos_t * rd.z + sin_t * rd.x);
      float rec1 = (bound - bla) * slab_inv(bda);
      if (rec1 > TMIN) slab_bwd(sin_t, cos_t, rol, rd, a, bound, g_t, d_ro, d_rd);
    }
  }
}

// Adjoint of the light pdf of the diffuse lobe, the sum over every light of
// its pdf at direction d from p; g_term is the cotangent of each light's term.
__device__ void light_pdf_adjoint(const Tables& tb, const SceneDims& P, const DiffBase& db, V3 p,
                                  V3 d, float time, float g_term, V3& g_p, V3& g_d,
                                  float& d_time, float* dt) {
  const int S = P.S, R = P.R, nL = P.n_lights;
  for (int li = 0; li < nL; ++li) {
    int lidx = P.lidx[li];
    if (P.ltype[li] == PRIM_SPHERE) {
      V3 c0l, c1l;
      float fmv;
      sphere_center(tb.sph, S, lidx, time, c0l, c1l, fmv);
      float radl = tb.sph[9 * S + lidx];
      V3 cenl = c0l + (c1l - c0l) * fmv;
      V3 oc = p - cenl;
      float bq = dot(oc, d);
      float cq = dot(oc, oc) - radl * radl;
      float disc = bq * bq - cq;
      float sqd = sqrtf(disc > 0.0f ? disc : 1.0f);
      bool hitl = disc > 0.0f && -bq - sqd > TMIN;
      V3 to_c = cenl - p;
      float dist_sq = dot(to_c, to_c);
      float raw = 1.0f - radl * radl / fmaxf(dist_sq, 1e-30f);
      float cm_arg = clampf(raw, 0.0f, 1.0f);
      float cos_max = cm_arg > 1e-12f ? sqrtf(cm_arg) : 0.0f;
      float sa = TWO_PI_F * (1.0f - cos_max);
      if (hitl && sa > 1e-12f && cm_arg > 1e-12f && raw < 1.0f && dist_sq > 1e-30f) {
        // term = 1 / sa
        float g_sa = -g_term / (sa * sa);
        float g_cm = -TWO_PI_F * g_sa;
        float g_arg = g_cm * 0.5f / cos_max;
        float g_r = g_arg * (-2.0f * radl / dist_sq);
        float g_ds = g_arg * radl * radl / (dist_sq * dist_sq);
        V3 g_toc = to_c * (2.0f * g_ds);
        g_p = g_p - g_toc;
        sphere_center_bwd(tb.sph, S, lidx, time, g_toc, dt, d_time);
        acc(dt, db.sph_rad + lidx, g_r);
      }
    } else {
      RectRow r = rect_row(tb.rect, R, lidx);
      float dk = dot(r.ek, d);
      bool facing = dk * r.sgn <= 0.0f;
      bool dk_ok = fabsf(dk) > 1e-30f;
      float dk_safe = dk_ok ? dk : 1e-30f;
      float t = (r.kk - dot(r.ek, p)) / dk_safe;
      float iiv = dot(r.ei, p) + t * dot(r.ei, d);
      float jjv = dot(r.ej, p) + t * dot(r.ej, d);
      if (facing && t >= TMIN && iiv >= r.i0 && iiv <= r.i1 && jjv >= r.j0 && jjv <= r.j1) {
        // term = t*t / max(cosine * area, 1e-12)
        float area = (r.i1 - r.i0) * (r.j1 - r.j0);
        float x = dot(d, r.ek) * r.sgn;
        float den = fabsf(x) * area;
        float g_t, g_dk = 0.0f;
        if (den > 1e-12f) {
          g_t = g_term * 2.0f * t / den;
          float g_cos = -g_term * t * t / (den * den) * area;
          g_dk = g_cos * (x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f)) * r.sgn;
        } else {
          g_t = g_term * 2.0f * t / 1e-12f;
        }
        g_p = g_p + r.ek * (-g_t / dk_safe);
        if (dk_ok) g_dk = g_dk - g_t * t / dk_safe;
        g_d = g_d + r.ek * g_dk;
      }
    }
  }
}

// Adjoint of the direction generated toward the picked light (cotangent
// g_gen), for a lane that sampled the lights.
__device__ void light_gen_adjoint(const Tables& tb, const SceneDims& P, const DiffBase& db, V3 p,
                                  float time, uint32_t keys_b, V3 g_gen, V3& g_p, float& d_time,
                                  float* dt) {
  const int S = P.S, nL = P.n_lights;
  float u_pick = uniform(keys_b, SLOT_LPICK);
  float u_a = uniform(keys_b, SLOT_LA);
  float u_b = uniform(keys_b, SLOT_LB);
  int li = min(max((int)(u_pick * (float)nL), 0), nL - 1);
  int lidx = P.lidx[li];
  if (P.ltype[li] != PRIM_SPHERE) {
    g_p = g_p - g_gen;  // gen = (point on the rect) - p
    return;
  }
  V3 c0l, c1l;
  float fmv;
  sphere_center(tb.sph, S, lidx, time, c0l, c1l, fmv);
  float radl = tb.sph[9 * S + lidx];
  V3 cenl = c0l + (c1l - c0l) * fmv;
  V3 to_c = cenl - p;
  float dist_sq = dot(to_c, to_c);
  V3 wl = normalize(to_c), ul, vl;
  onb_from_w(wl, ul, vl);
  float raw = 1.0f - radl * radl / fmaxf(dist_sq, 1e-30f);
  float frac = clampf(raw, 0.0f, 1.0f);
  bool f_ok = frac > 1e-12f;
  float sqf = f_ok ? sqrtf(frac) : 0.0f;
  float z = 1.0f + u_b * (sqf - 1.0f);
  float phi = TWO_PI_F * u_a;
  float z2 = z * z;
  bool z_ok = z2 < ONE_M_1EM12;
  float sl = z_ok ? sqrtf(1.0f - z2) : 0.0f;
  float cphi = cosf(phi), sphi = sinf(phi);
  // gen = ul * (cphi * sl) + vl * (sphi * sl) + wl * z
  V3 g_ul = g_gen * (cphi * sl), g_vl = g_gen * (sphi * sl), g_wl = g_gen * z;
  float g_sl = dot(g_gen, ul) * cphi + dot(g_gen, vl) * sphi;
  float g_z = dot(g_gen, wl);
  if (z_ok) g_z = g_z + (-g_sl * 0.5f / sl) * 2.0f * z;
  float g_sqf = g_z * u_b;
  float g_frac = f_ok ? g_sqf * 0.5f / sqf : 0.0f;
  float g_r = 0.0f, g_ds = 0.0f;
  if (raw > 0.0f && raw < 1.0f && dist_sq > 1e-30f) {
    g_r = g_frac * (-2.0f * radl / dist_sq);
    g_ds = g_frac * radl * radl / (dist_sq * dist_sq);
  }
  g_wl = g_wl + onb_bwd(wl, g_ul, g_vl);
  V3 g_toc = normalize_bwd(to_c, g_wl) + to_c * (2.0f * g_ds);
  g_p = g_p - g_toc;
  sphere_center_bwd(tb.sph, S, lidx, time, g_toc, dt, d_time);
  acc(dt, db.sph_rad + lidx, g_r);
}

// Adjoint of one bounce (physics.cuh::bounce_physics_t) on a lane that hit:
// from the cotangents of p, new_rd, weight and emitted to those of ro, rd,
// time (added to d_*), of the table entries (added to dt) and of the
// candidate from outside (added to d_ext).
template <bool EXT, bool EXT_MAT, bool IMAGE>
__device__ void physics_adjoint(const Tables& tb, const SceneDims& P, const ExtCand& ext, V3 ro,
                                V3 rd, float time, int inside, uint32_t keys_b, const Bounce& b,
                                V3 g_p, V3 g_nrd, V3 g_w, V3 g_em, V3& d_ro, V3& d_rd,
                                float& d_time, float* dt, ExtCot& d_ext) {
  const DiffBase db = diff_base(P);
  const V3 p = b.p, nrm = b.nrm;
  const V3 zero3 = v3(0.0f, 0.0f, 0.0f);
  V3 g_nrm = zero3;

  // material and texture of the winner, as the forward pass reads them
  const int w_mat = b.w_mat;
  const bool has_mat = w_mat >= 0 && w_mat < P.M;
  float mtype = 0.0f, mparam = 0.0f, tex_id = 0.0f;
  if (has_mat) {
    mtype = tb.mat[w_mat];
    mparam = tb.mat[P.M + w_mat];
    tex_id = tb.mat[2 * P.M + w_mat];
  }
  const int X = P.X;
  const int xi = (int)tex_id;
  const bool has_tex = (float)xi == tex_id && xi >= 0 && xi < X;
  float ttype = 0.0f, tscale = 0.0f;
  V3 c0 = zero3, c1 = zero3;
  if (has_tex) {
    ttype = tb.tex[xi];
    c0 = load3(tb.tex, X + 3 * xi);
    c1 = load3(tb.tex, 4 * X + 3 * xi);
    tscale = tb.tex[7 * X + xi];
  }
  V3 albedo = c0;
  bool use_c1 = false, use_turb = false;
  if (ttype == (float)TEX_CHECKER) {
    float sines = sinf(tscale * p.x) * sinf(tscale * p.y) * sinf(tscale * p.z);
    if (sines < 0.0f) {
      albedo = c1;
      use_c1 = true;
    }
  }
  float turb_signed = 0.0f;
  V3 turb_grad = zero3;
  if (P.perlin && ttype == (float)TEX_PERLIN) {
    turb_signed = turbulence_grad(tb.ptab, v3(p.x * tscale, p.y * tscale, p.z * tscale),
                                  turb_grad);
    float turb = fabsf(turb_signed);
    albedo = v3(turb, turb, turb);
    use_turb = true;
  }
  // an image texel is a constant: the lane was shaded with albedo 1
  bool img_lane = false;
  if (IMAGE && ttype == (float)TEX_IMAGE && mtype != (float)MAT_DIELECTRIC &&
      mtype != (float)MAT_DIFFUSE_LIGHT && !(EXT_MAT && b.t == ext.t)) {
    albedo = v3(1.0f, 1.0f, 1.0f);
    img_lane = true;
  }
  // a winner from outside brings its material: its cotangents go to the rows
  const bool is_ext = EXT_MAT && b.t == ext.t;
  if (is_ext) {
    mtype = ext.mtype;
    mparam = ext.mparam;
    albedo = v3(ext.ar, ext.ag, ext.ab);
  }

  V3 g_alb = zero3;
  float g_mparam = 0.0f;
  const bool is_light = mtype == (float)MAT_DIFFUSE_LIGHT;
  const bool is_metal = mtype == (float)MAT_METAL;
  const bool is_diel = mtype == (float)MAT_DIELECTRIC;

  if (is_light) {
    // emitted = albedo * mparam on the lit side
    if (dot(nrm, rd) < 0.0f) {
      g_alb = g_em * mparam;
      g_mparam = dot(g_em, albedo);
    }
  } else if (is_metal) {
    // weight = albedo; new_rd = normalize(refl + fuzz * (1 - mparam))
    g_alb = g_w;
    V3 refl = rd - nrm * (2.0f * dot(rd, nrm));
    V3 fuzz = sample_in_ball(uniform(keys_b, SLOT_FUZZ), uniform(keys_b, SLOT_FUZZ + 1),
                             uniform(keys_b, SLOT_FUZZ + 2));
    V3 g_m = normalize_bwd(refl + fuzz * (1.0f - mparam), g_nrd);
    g_mparam = -dot(g_m, fuzz);
    reflect_bwd(rd, nrm, g_m, d_rd, g_nrm);
  } else if (is_diel) {
    // weight = 1; new_rd = reflect or refract
    V3 refl = rd - nrm * (2.0f * dot(rd, nrm));
    float ref_idx = mparam;
    float cosI = -dot(rd, nrm);
    bool entering = cosI >= 0.0f;
    V3 facing_n = entering ? nrm : -nrm;
    float nio = entering ? 1.0f / ref_idx : ref_idx;
    float ncosI = dot(rd, facing_n);
    float sinT2 = (nio * nio) * (1.0f - ncosI * ncosI);
    bool can_refract = sinT2 <= 1.0f;
    bool safe_r = sinT2 < ONE_M_1EM9;
    float cosT = safe_r ? sqrtf(1.0f - sinT2) : 0.0f;
    float K = nio * (-ncosI) - cosT;
    V3 refracted = rd * nio + facing_n * K;
    float cs_arg = clampf(1.0f - nio * nio * (1.0f - cosI * cosI), 0.0f, 1.0f);
    float cos_schlick = entering ? cosI : (cs_arg > 1e-12f ? sqrtf(cs_arg) : 0.0f);
    float reflect_prob = can_refract ? schlick(cos_schlick, ref_idx) : 1.0f;
    bool do_reflect = uniform(keys_b, SLOT_FRESNEL) < reflect_prob;
    if (do_reflect) {
      reflect_bwd(rd, nrm, normalize_bwd(refl, g_nrd), d_rd, g_nrm);
    } else {
      V3 g_r = normalize_bwd(refracted, g_nrd);
      d_rd = d_rd + g_r * nio;
      float g_nio = dot(g_r, rd);
      V3 g_fn = g_r * K;
      float g_K = dot(g_r, facing_n);
      g_nio = g_nio + g_K * (-ncosI);
      float g_ncosI = -g_K * nio;
      float g_cosT = -g_K;
      float g_sinT2 = safe_r ? -g_cosT * 0.5f / cosT : 0.0f;
      g_nio = g_nio + g_sinT2 * 2.0f * nio * (1.0f - ncosI * ncosI);
      g_ncosI = g_ncosI + g_sinT2 * (nio * nio) * (-2.0f * ncosI);
      d_rd = d_rd + facing_n * g_ncosI;
      g_fn = g_fn + rd * g_ncosI;
      g_nrm = g_nrm + (entering ? g_fn : -g_fn);
      g_mparam = entering ? -g_nio / (ref_idx * ref_idx) : g_nio;
    }
  } else {
    // lambertian / isotropic: weight = albedo * scatter_pdf / pdf, new_rd = d
    const bool is_iso = mtype == (float)MAT_ISOTROPIC;
    const int nL = P.n_lights;
    float u_ma = uniform(keys_b, SLOT_MA);
    float u_mb = uniform(keys_b, SLOT_MB);
    V3 loc = zero3, gen;
    if (is_iso) {
      gen = sample_on_sphere(u_ma, u_mb);
    } else {
      V3 uo, vo;
      onb_from_w(nrm, uo, vo);
      loc = sample_cosine(u_ma, u_mb, P.exact_cos != 0);
      gen = uo * loc.x + vo * loc.y + nrm * loc.z;
    }
    bool light_gen = false;
    float lpv = 0.0f;
    if (nL > 0) {
      float u_mix = uniform(keys_b, SLOT_MIX);
      if (u_mix < 0.5f) {
        // the forward pass normalised this direction into new_rd: recompute it
        light_gen = true;
        float u_pick = uniform(keys_b, SLOT_LPICK);
        float u_a = uniform(keys_b, SLOT_LA);
        float u_b = uniform(keys_b, SLOT_LB);
        int li = min(max((int)(u_pick * (float)nL), 0), nL - 1);
        int lidx = P.lidx[li];
        if (P.ltype[li] == PRIM_SPHERE) {
          V3 c0l, c1l;
          float fmv;
          sphere_center(tb.sph, P.S, lidx, time, c0l, c1l, fmv);
          float radl = tb.sph[9 * P.S + lidx];
          V3 cenl = c0l + (c1l - c0l) * fmv;
          V3 to_c = cenl - p;
          float dist_sq = dot(to_c, to_c);
          V3 wl = normalize(to_c), ul, vl;
          onb_from_w(wl, ul, vl);
          float frac = clampf(1.0f - radl * radl / fmaxf(dist_sq, 1e-30f), 0.0f, 1.0f);
          float sqf = frac > 1e-12f ? sqrtf(frac) : 0.0f;
          float z = 1.0f + u_b * (sqf - 1.0f);
          float phi = TWO_PI_F * u_a;
          float z2 = z * z;
          float sl = z2 < ONE_M_1EM12 ? sqrtf(1.0f - z2) : 0.0f;
          gen = ul * (cosf(phi) * sl) + vl * (sinf(phi) * sl) + wl * z;
        } else {
          RectRow r = rect_row(tb.rect, P.R, lidx);
          float iil = r.i0 + u_a * (r.i1 - r.i0);
          float jjl = r.j0 + u_b * (r.j1 - r.j0);
          gen = (r.ei * iil + r.ej * jjl + r.ek * r.kk) - p;
        }
      }
    }
    const V3 d = normalize(gen);
    if (nL > 0) {
      // the forward pass's light pdf value, for pdf_v
      for (int li = 0; li < nL; ++li) {
        int lidx = P.lidx[li];
        if (P.ltype[li] == PRIM_SPHERE) {
          V3 c0l, c1l;
          float fmv;
          sphere_center(tb.sph, P.S, lidx, time, c0l, c1l, fmv);
          float radl = tb.sph[9 * P.S + lidx];
          V3 cenl = c0l + (c1l - c0l) * fmv;
          V3 oc = p - cenl;
          float bq = dot(oc, d);
          float cq = dot(oc, oc) - radl * radl;
          float disc = bq * bq - cq;
          float sqd = sqrtf(disc > 0.0f ? disc : 1.0f);
          bool hitl = disc > 0.0f && -bq - sqd > TMIN;
          V3 to_c = cenl - p;
          float dist_sq = dot(to_c, to_c);
          float cm_arg = clampf(1.0f - radl * radl / fmaxf(dist_sq, 1e-30f), 0.0f, 1.0f);
          float cos_max = cm_arg > 1e-12f ? sqrtf(cm_arg) : 0.0f;
          float sa = TWO_PI_F * (1.0f - cos_max);
          if (hitl && sa > 0.0f) lpv = lpv + 1.0f / fmaxf(sa, 1e-12f);
        } else {
          RectRow r = rect_row(tb.rect, P.R, lidx);
          float dk = dot(r.ek, d);
          bool facing = dk * r.sgn <= 0.0f;
          float dk_safe = fabsf(dk) > 1e-30f ? dk : 1e-30f;
          float t = (r.kk - dot(r.ek, p)) / dk_safe;
          float iiv = dot(r.ei, p) + t * dot(r.ei, d);
          float jjv = dot(r.ej, p) + t * dot(r.ej, d);
          if (facing && t >= TMIN && iiv >= r.i0 && iiv <= r.i1 && jjv >= r.j0 && jjv <= r.j1) {
            float area = (r.i1 - r.i0) * (r.j1 - r.j0);
            float cosine = fabsf(dot(d, r.ek) * r.sgn);
            lpv = lpv + t * t / fmaxf(cosine * area, 1e-12f);
          }
        }
      }
      lpv = lpv / (float)nL;
    }
    float cosd = dot(nrm, d);
    float mat_pdf_v = is_iso ? INV_TWO_PI_F : (cosd > 0.0f ? cosd / PI_F : 0.0f);
    float pdf_v = nL > 0 ? 0.5f * lpv + 0.5f * mat_pdf_v : mat_pdf_v;
    float scatter_pdf = is_iso ? INV_TWO_PI_F : fmaxf(cosd, 0.0f) / PI_F;
    bool pdf_ok = pdf_v > 1e-12f;
    float W = pdf_ok ? scatter_pdf / pdf_v : 0.0f;

    g_alb = g_w * W;
    float g_W = dot(g_w, albedo);
    float g_sc = pdf_ok ? g_W / pdf_v : 0.0f;
    float g_pdf = pdf_ok ? -g_W * scatter_pdf / (pdf_v * pdf_v) : 0.0f;
    float g_matpdf = nL > 0 ? 0.5f * g_pdf : g_pdf;
    float g_lpv = nL > 0 ? 0.5f * g_pdf : 0.0f;
    float g_cosd = (!is_iso && cosd > 0.0f) ? (g_sc + g_matpdf) / PI_F : 0.0f;
    V3 g_d = g_nrd + nrm * g_cosd;
    g_nrm = g_nrm + d * g_cosd;
    // the pdf terms first: they add to g_d, which then flows into gen
    if (nL > 0)
      light_pdf_adjoint(tb, P, db, p, d, time, g_lpv / (float)nL, g_p, g_d, d_time, dt);
    V3 g_gen = normalize_bwd(gen, g_d);
    if (light_gen) {
      light_gen_adjoint(tb, P, db, p, time, keys_b, g_gen, g_p, d_time, dt);
    } else if (!is_iso) {
      V3 uo, vo;
      onb_from_w(nrm, uo, vo);
      g_nrm = g_nrm + g_gen * loc.z + onb_bwd(nrm, g_gen * loc.x, g_gen * loc.y);
    }
  }

  // albedo -> the candidate's rows, texture colours, or through the
  // turbulence to p
  if (is_ext) {
    d_ext.alb = d_ext.alb + g_alb;
    d_ext.mparam = d_ext.mparam + g_mparam;
  } else {
    if (use_turb) {
      float g_turb = g_alb.x + g_alb.y + g_alb.z;
      float s = turb_signed > 0.0f ? 1.0f : (turb_signed < 0.0f ? -1.0f : 0.0f);
      g_p = g_p + turb_grad * (s * g_turb * tscale);
    } else if (has_tex && !img_lane) {
      acc3(dt, (use_c1 ? db.tex_c1 : db.tex_c0) + 3 * xi, g_alb);
    }
    if (has_mat) acc(dt, db.mat + w_mat, g_mparam);
  }

  geometry_adjoint<EXT>(tb, P, db, ro, rd, time, inside, b, g_p, g_nrm, d_ro, d_rd, d_time, dt,
                        d_ext);
}

// The cotangent of one sub-step's entry state from that of its exit state.
// g_sum is the cotangent of the sum rows, the same for every sub-step.
template <bool EXT, bool EXT_MAT, bool IMAGE>
__device__ void substep_adjoint(const Tables& tb, const AdParams& P, const ExtCand& ext,
                                const Atlas& atlas, const LaneState& st, const SubRec& rec,
                                V3 g_sum, V3& g_ro, V3& g_rd, float& g_time, V3& g_beta,
                                V3& g_rad, float* dt, ExtCot& d_ext) {
  if (!st.alive) return;  // a dead lane passes its state through
  const Bounce& b = rec.b;
  const V3 zero3 = v3(0.0f, 0.0f, 0.0f);
  if (rec.regen) {
    // the new camera ray, unit throughput and zero radiance are constants
    g_ro = g_rd = g_beta = g_rad = zero3;
    g_time = 0.0f;
  }
  V3 texel;
  if (IMAGE && rec.cont && pending_texel(atlas, b, texel)) g_beta = g_beta * texel;
  V3 G_rad = rec.take ? g_rad + g_sum : g_rad;
  V3 d_ro = zero3, d_rd = zero3, g_p = zero3, g_nrd = zero3;
  if (rec.cont) {
    g_p = g_ro;
    g_nrd = g_rd;
  } else {
    d_ro = g_ro;
    d_rd = g_rd;
  }
  float d_time = g_time;
  V3 d_beta = g_beta, g_w = zero3, g_em = zero3;
  if (rec.cont0) {
    d_beta = g_beta * b.weight;
    g_w = g_beta * st.beta;
  }
  if (!b.hit) {
    if (P.use_sky) {
      d_beta = d_beta + G_rad * sky(st.rd.y);
      V3 g_bg = G_rad * st.beta;
      d_rd.y = d_rd.y + 0.5f * (g_bg.x * (0.5f - 1.0f) + g_bg.y * (0.7f - 1.0f) +
                                g_bg.z * (1.0f - 1.0f));
    }
  } else if (rec.emit) {
    d_beta = d_beta + G_rad * b.emitted;
    g_em = G_rad * st.beta;
  }
  if (b.hit && (rec.cont0 || b.is_light))
    physics_adjoint<EXT, EXT_MAT, IMAGE>(tb, P, ext, st.ro, st.rd, st.time, st.inside,
                                         rec.keys_b, b, g_p, g_nrd, g_w, g_em, d_ro, d_rd,
                                         d_time, dt, d_ext);
  g_ro = d_ro;
  g_rd = d_rd;
  g_time = d_time;
  g_beta = d_beta;
  g_rad = G_rad;
}

template <bool EXT, bool EXT_MAT, bool IMAGE>
__device__ void lane_backward(const Tables& tb, const AdParams& P, const Atlas& atlas,
                              const float* __restrict__ res, const int* __restrict__ i_in,
                              const int* __restrict__ k_in, const int* __restrict__ pix_in,
                              const int* __restrict__ sb_in, const float* __restrict__ ext_in,
                              const float* __restrict__ cot, float* __restrict__ d_f,
                              float* __restrict__ d_ext_out, float* dt, int lane) {
  // the ext modes take one sub-step a launch
  constexpr int KS = EXT ? 1 : MAX_KSUB;
  const int n = P.n;
  const uint32_t pix = (uint32_t)pix_in[lane];
  const int sampbase = sb_in[lane];
  LaneState st[KS];
  SubRec rec[KS];
  LaneState s = load_state(res, n, i_in, k_in, n, lane);
  const ExtCand ext = load_ext<EXT, EXT_MAT>(ext_in, n, lane);
  V3 summ = v3(0.0f, 0.0f, 0.0f);
  float nvalid = 0.0f, rays = 0.0f;
  for (int j = 0; j < P.k_sub && j < KS; ++j) {
    st[j] = s;
    ad_substep<EXT, EXT_MAT, IMAGE>(tb, P, ext, atlas, pix, sampbase, P.t_step * P.k_sub + j, s,
                                    summ, nvalid, rays, &rec[j]);
  }
  V3 g_sum = v3(cot[lane], cot[n + lane], cot[2 * n + lane]);
  V3 g_ro = v3(cot[A_RO * n + lane], cot[(A_RO + 1) * n + lane], cot[(A_RO + 2) * n + lane]);
  V3 g_rd = v3(cot[A_RD * n + lane], cot[(A_RD + 1) * n + lane], cot[(A_RD + 2) * n + lane]);
  float g_time = cot[A_TIME * n + lane];
  V3 g_beta = v3(cot[A_BETA * n + lane], cot[(A_BETA + 1) * n + lane],
                 cot[(A_BETA + 2) * n + lane]);
  V3 g_rad = v3(cot[A_RAD * n + lane], cot[(A_RAD + 1) * n + lane], cot[(A_RAD + 2) * n + lane]);
  ExtCot d_ext{0.0f, 0.0f, v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f)};
  for (int j = min(P.k_sub, KS) - 1; j >= 0; --j)
    substep_adjoint<EXT, EXT_MAT, IMAGE>(tb, P, ext, atlas, st[j], rec[j], g_sum, g_ro, g_rd,
                                         g_time, g_beta, g_rad, dt, d_ext);
  // sum, nvalid and rays enter additively: their cotangent passes through once
  store3(d_f, A_SUM, n, lane, g_sum);
  store3(d_f, A_RO, n, lane, g_ro);
  store3(d_f, A_RD, n, lane, g_rd);
  d_f[A_TIME * n + lane] = g_time;
  store3(d_f, A_BETA, n, lane, g_beta);
  store3(d_f, A_RAD, n, lane, g_rad);
  d_f[A_ALIVE * n + lane] = 0.0f;  // alive feeds comparisons only
  d_f[A_NV * n + lane] = cot[A_NV * n + lane];
  d_f[A_RAYS * n + lane] = cot[A_RAYS * n + lane];
  if (EXT) {
    d_ext_out[E_T * n + lane] = d_ext.t;
    store3(d_ext_out, E_N, n, lane, d_ext.n);
    d_ext_out[E_MAT * n + lane] = 0.0f;
  }
  if (EXT_MAT) {
    d_ext_out[E_MTYPE * n + lane] = 0.0f;
    d_ext_out[E_MPARAM * n + lane] = d_ext.mparam;
    store3(d_ext_out, E_ALB, n, lane, d_ext.alb);
    d_ext_out[E_IMG * n + lane] = 0.0f;
  }
}

template <bool EXT, bool EXT_MAT, bool IMAGE>
__global__ void __launch_bounds__(MRT_AD_THREADS)
ad_step_bwd_kernel(Tables tb, AdParams P, Atlas atlas, const float* __restrict__ res,
                   const int* __restrict__ i_in, const int* __restrict__ k_in,
                   const int* __restrict__ pix_in, const int* __restrict__ sb_in,
                   const float* __restrict__ ext_in, const float* __restrict__ cot,
                   float* __restrict__ d_f, float* __restrict__ d_ext,
                   float* __restrict__ d_tab) {
  __shared__ float s_dtab[MAX_NDIFF];
  const int n_diff = 4 * P.S + 3 * P.Tc + P.M + 6 * P.X;
  for (int i = threadIdx.x; i < n_diff; i += blockDim.x) s_dtab[i] = 0.0f;
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < P.n)
    lane_backward<EXT, EXT_MAT, IMAGE>(tb, P, atlas, res, i_in, k_in, pix_in, sb_in, ext_in, cot,
                                       d_f, d_ext, s_dtab, lane);
  __syncthreads();
  for (int i = threadIdx.x; i < n_diff; i += blockDim.x) {
    float v = s_dtab[i];
    if (v != 0.0f) atomicAdd(d_tab + i, v);
  }
}

bool read_params(const int* ip, AdParams& P) {
  P.n = ip[Q_N];
  P.width = ip[Q_WIDTH];
  P.height = ip[Q_HEIGHT];
  P.sq_off = ip[Q_SQ_OFF];
  P.max_bounces = ip[Q_MAX_BOUNCES];
  P.spp = ip[Q_SPP];
  P.claim_limit = ip[Q_CLAIM_LIMIT];
  P.k_sub = ip[Q_KSUB];
  P.t_step = ip[Q_TSTEP];
  P.S = ip[Q_S];
  P.R = ip[Q_R];
  P.Tc = ip[Q_TC];
  P.Bx = ip[Q_BX];
  P.V = ip[Q_V];
  P.M = ip[Q_M];
  P.X = ip[Q_X];
  P.n_lights = ip[Q_NLIGHTS];
  for (int i = 0; i < MAX_LIGHTS; ++i) {
    P.ltype[i] = ip[Q_LTYPE + i];
    P.lidx[i] = ip[Q_LIDX + i];
  }
  P.use_sky = ip[Q_USE_SKY];
  P.exact_cos = ip[Q_EXACT_COS];
  P.perlin = ip[Q_PERLIN];
  return P.k_sub >= 1 && P.k_sub <= MAX_KSUB && P.n_lights <= MAX_LIGHTS &&
         4 * P.S + 3 * P.Tc + P.M + 6 * P.X <= MAX_NDIFF && P.sq_off >= 1;
}

// The mode of a launch: 0 the fused class, 1 ext, 2 ext-material, 3 ext with
// image textures, 4 ext-material with image textures; -1 for a combination
// the kernels do not take (ext-material or image without ext, or more than
// one sub-step a launch in an ext mode).
int read_mode(const int* xp, const AdParams& P, const uint32_t* texels, Atlas& atlas) {
  atlas = Atlas{texels, xp[X_N_IMG], xp[X_IH], xp[X_IW]};
  const bool ext = xp[X_EXT] != 0, emat = xp[X_EXT_MAT] != 0, image = xp[X_IMAGE] != 0;
  if (!ext) return emat || image ? -1 : 0;
  if (P.k_sub != 1) return -1;
  if (image && (texels == nullptr || atlas.n_img < 1 || atlas.ih < 1 || atlas.iw < 1)) return -1;
  return image ? (emat ? 4 : 3) : (emat ? 2 : 1);
}

constexpr int INVALID_VALUE = 1;  // cudaErrorInvalidValue

template <bool EXT, bool EXT_MAT, bool IMAGE>
int launch_fwd(const Tables& tb, const AdParams& P, const Atlas& atlas, const float* f_in,
               const int* i_in, const int* k_in, const int* pix, const int* sb, const float* ext,
               float* f_out, int* i_out, int* k_out, void* stream) {
  const int threads = MRT_AD_THREADS;
  const int blocks = (P.n + threads - 1) / threads;
  auto kernel = ad_step_fwd_kernel<EXT, EXT_MAT, IMAGE>;
  MRT_LAUNCH(kernel, blocks, threads, 0, stream, tb, P, atlas, f_in, i_in, k_in, pix, sb, ext,
             f_out, i_out, k_out);
  return (int)cudaGetLastError();
}

template <bool EXT, bool EXT_MAT, bool IMAGE>
int launch_bwd(const Tables& tb, const AdParams& P, const Atlas& atlas, const float* res,
               const int* i_in, const int* k_in, const int* pix, const int* sb, const float* ext,
               const float* cot, float* d_f, float* d_ext, float* d_tab, void* stream) {
  const int threads = MRT_AD_THREADS;
  const int blocks = (P.n + threads - 1) / threads;
  auto kernel = ad_step_bwd_kernel<EXT, EXT_MAT, IMAGE>;
  MRT_LAUNCH(kernel, blocks, threads, 0, stream, tb, P, atlas, res, i_in, k_in, pix, sb, ext, cot,
             d_f, d_ext, d_tab);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launch on `stream` and do not synchronise. Pointers are device
// pointers; `ip` is a host array of Q_COUNT ints (AdParamIdx order), `xp` one
// of X_COUNT (AdExtIdx order). `ext` is the (NE, n) candidate (NE_MAT rows in
// ext-material mode) and `texels` the image atlas (n_img x ih x iw texels
// 0x00RRGGBB), each unused (and may be null) in the modes without them. They
// return the launch's cudaError_t (0 on success).

// One scan step forward: f (19, n), ist (3, n), keys (n) -> *_out.
int mrt_ad_step_fwd(const float* sph, const float* rect, const float* tri, const float* box,
                    const float* vol, const float* mat, const float* tex, const float* cam,
                    const float* ptab, const float* f_in, const int* i_in, const int* k_in,
                    const int* pix, const int* sb, const float* ext, const uint32_t* texels,
                    float* f_out, int* i_out, int* k_out, const int* ip, const int* xp,
                    void* stream) {
  Tables tb{sph, rect, tri, box, vol, mat, tex, cam, ptab};
  AdParams P;
  Atlas atlas;
  if (!read_params(ip, P)) return INVALID_VALUE;
  const int mode = read_mode(xp, P, texels, atlas);
  if (mode < 0 || (mode > 0 && ext == nullptr)) return INVALID_VALUE;
  if (P.n <= 0) return 0;
  switch (mode) {
    case 0: return launch_fwd<false, false, false>(tb, P, atlas, f_in, i_in, k_in, pix, sb, ext,
                                                   f_out, i_out, k_out, stream);
    case 1: return launch_fwd<true, false, false>(tb, P, atlas, f_in, i_in, k_in, pix, sb, ext,
                                                  f_out, i_out, k_out, stream);
    case 2: return launch_fwd<true, true, false>(tb, P, atlas, f_in, i_in, k_in, pix, sb, ext,
                                                 f_out, i_out, k_out, stream);
    case 3: return launch_fwd<true, false, true>(tb, P, atlas, f_in, i_in, k_in, pix, sb, ext,
                                                 f_out, i_out, k_out, stream);
    default: return launch_fwd<true, true, true>(tb, P, atlas, f_in, i_in, k_in, pix, sb, ext,
                                                 f_out, i_out, k_out, stream);
  }
}

// The step's backward from its entry state: residual rows res (13, n) = ro rd
// time beta rad alive, ist (3, n), keys (n), the candidate ext, cotangent cot
// (19, n) -> d_f (19, n) and, in an ext mode, d_ext (NE, n) written, d_tab
// (n_diff) ADDED to.
int mrt_ad_step_bwd(const float* sph, const float* rect, const float* tri, const float* box,
                    const float* vol, const float* mat, const float* tex, const float* cam,
                    const float* ptab, const float* res, const int* i_in, const int* k_in,
                    const int* pix, const int* sb, const float* ext, const uint32_t* texels,
                    const float* cot, float* d_f, float* d_ext, float* d_tab, const int* ip,
                    const int* xp, void* stream) {
  Tables tb{sph, rect, tri, box, vol, mat, tex, cam, ptab};
  AdParams P;
  Atlas atlas;
  if (!read_params(ip, P)) return INVALID_VALUE;
  const int mode = read_mode(xp, P, texels, atlas);
  if (mode < 0 || (mode > 0 && (ext == nullptr || d_ext == nullptr))) return INVALID_VALUE;
  if (P.n <= 0) return 0;
  switch (mode) {
    case 0: return launch_bwd<false, false, false>(tb, P, atlas, res, i_in, k_in, pix, sb, ext,
                                                   cot, d_f, d_ext, d_tab, stream);
    case 1: return launch_bwd<true, false, false>(tb, P, atlas, res, i_in, k_in, pix, sb, ext,
                                                  cot, d_f, d_ext, d_tab, stream);
    case 2: return launch_bwd<true, true, false>(tb, P, atlas, res, i_in, k_in, pix, sb, ext,
                                                 cot, d_f, d_ext, d_tab, stream);
    case 3: return launch_bwd<true, false, true>(tb, P, atlas, res, i_in, k_in, pix, sb, ext,
                                                 cot, d_f, d_ext, d_tab, stream);
    default: return launch_bwd<true, true, true>(tb, P, atlas, res, i_in, k_in, pix, sb, ext,
                                                 cot, d_f, d_ext, d_tab, stream);
  }
}

const char* mrt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
