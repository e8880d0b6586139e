// Nearest-hit sweeps for Hopper (sm_90a): for every ray the closest triangle,
// or the closest sphere, of a set. Two dense sweeps over ALL primitives, and
// five sweeps (two for spheres, three for triangles) over Morton-ordered
// clusters with a bounding box each, which share one cluster loop (further
// down: "Clustered sweeps").
//
// The dense sweeps replace the TPU kernels
// `miniraytracer_tpu/ops/flash.py::_kernel` (launched by `flash_tri_hit`) and
// `::_sphere_kernel` (launched by `flash_sphere_hit`). They compute, per (primitive, ray) pair, inner products of a row of
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

// the 17 sphere features of a ray
__device__ __forceinline__ void sphere_features(const float (&ro)[3], const float (&rd)[3],
                                                float time, float (&f)[SPH_F]) {
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
}

// The root of one (ray, sphere) pair from its b and c: the front root if
// > tmin, else the back root, and that only for a ray inside a medium. Every
// sphere sweep of this file goes through here.
__device__ __forceinline__ bool sphere_root(float b, float c, bool inside, float tmin, float& t) {
  const float disc = b * b - c;
  const bool ok = disc > 0.0f;
  const float sq = sqrtf(ok ? disc : 0.0f);
  const float t_front = -b - sq;
  const float t_back = -b + sq;
  const bool front_ok = ok && t_front > tmin;
  const bool back_ok = ok && inside && t_back > tmin;
  t = front_ok ? t_front : t_back;
  return front_ok || back_ok;
}

// the 16 triangle features of a ray: [1, ro, rd, ro_i * rd_j (i major)]
__device__ __forceinline__ void tri_features(const float (&ro)[3], const float (&rd)[3],
                                             float (&f)[TRI_F]) {
  f[0] = 1.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    f[1 + a] = ro[a];
    f[4 + a] = rd[a];
#pragma unroll
    for (int b = 0; b < 3; ++b) f[7 + 3 * a + b] = ro[a] * rd[b];
  }
}

// The hit of one (ray, triangle) pair from its four inner products: the
// backface flip (triangle.cpp:226-235) only for a ray inside a medium, then
// Moller-Trumbore's tests. t = tn/det is 0/0 on an all-zero (inactive or
// padding) row and is masked by sdet >= 1e-5. Every triangle sweep of this
// file goes through here.
__device__ __forceinline__ bool tri_root(float det, float uu, float vv, float tn, bool inside,
                                         float tmin, float& t) {
  const float sign = (inside && det < 0.0f) ? -1.0f : 1.0f;
  const float sdet = det * sign, suu = uu * sign, svv = vv * sign;
  t = tn / det;
  return sdet >= TRI_EPS && suu >= 0.0f && svv >= 0.0f && suu + svv <= sdet && t >= tmin;
}

// One ray against `rows` spheres whose b and c coefficient rows (SPH_F words
// each) start at `cb`, `cc`; they are numbered from `base`. The
// running (best_t, best_i) changes only on a strictly nearer hit, so the
// first of equal hits in row order stays.
__device__ __forceinline__ void sweep_sphere_rows(const float* __restrict__ cb,
                                                  const float* __restrict__ cc, int rows,
                                                  int base, const float (&f)[SPH_F],
                                                  bool inside, float tmin, float& best_t,
                                                  int& best_i) {
  for (int r = 0; r < rows; ++r) {
    float t;
    if (sphere_root(dot_row<SPH_F>(cb + r * SPH_F, f), dot_row<SPH_F>(cc + r * SPH_F, f),
                    inside, tmin, t) && t < best_t) {
      best_t = t;
      best_i = base + r;
    }
  }
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
  tri_features(ro, rd, f);
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
      float t;
      if (tri_root(dot_row<TRI_F>(&tile[0][r * TRI_F], f), dot_row<TRI_F>(&tile[1][r * TRI_F], f),
                   dot_row<TRI_F>(&tile[2][r * TRI_F], f), dot_row<TRI_F>(&tile[3][r * TRI_F], f),
                   inside, tmin, t) &&
          t < best_t) {
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
  sphere_features(ro, rd, time, f);
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
    sweep_sphere_rows(tile[0], tile[1], rows, base, f, inside, tmin, best_t, best_i);
  }
  if (live) {
    t_out[lane] = best_t;
    i_out[lane] = best_i;
  }
}

// ---------------------------------------------------------------------------
// Clustered sweeps
// ---------------------------------------------------------------------------
// Replace five TPU kernels of `miniraytracer_tpu/ops/flash.py`: for spheres
// `::_sph_gated_kernel` (launched by `flash_sphere_hit_gated`, 512..4095
// spheres) and `::_sph_streamed_kernel` (`flash_sphere_hit_streamed`, any
// count); for triangles `::_culled_kernel` (`flash_tri_hit_culled`),
// `::_resident_kernel` (`flash_tri_hit_resident`, 1024 triangles or more while
// the tables fit the TPU core's memory) and `::_streamed_kernel`
// (`flash_tri_hit_streamed`, beyond that). All five find what the dense sweep
// of their primitive finds, over a table that `sph_cull_build` /
// `tri_cull_build` (ops/flash.py) has put into Morton order and cut into
// clusters of `block` rows with an axis-aligned box each: `bounds` is (8, NC)
// = lo xyz, hi xyz, two unused rows; `orig_of` maps a row of the permuted
// table back to the primitive's own number. A cluster is swept only for a ray
// that passes its slab test and could still find something nearer there:
//
//   tfar > max(tnear, tmin)  and  tnear < best_t
//
// A ray starts from its seed distance where one is given (INF otherwise) and
// gets it back, with index 0, where nothing is nearer. The plain PyTorch
// versions are `flash_sphere_hit_gated_plain`, `..._streamed_plain`,
// `flash_tri_hit_culled_plain`, `..._resident_plain` and
// `flash_tri_hit_streamed_plain`.
//
// Design: ONE cluster loop (`clustered_sweep`), generic over the primitive
// (`SpherePrim`, `TriPrim`: features, tables, the pair test). RAY_LANES = 4
// lanes work for one ray, 8 rays a warp, and each WARP walks its visiting
// order on its own, with no barrier of the block. The lanes of a ray test the
// next four clusters of the order against the ray, one each (the slab test);
// when no ray of the warp enters any of the four before its best (a vote), the
// four are skipped at the cost of one slab test a lane. Else they are taken
// one after the other, each ray holding the k-th test (from its k-th lane)
// against its best so far, as the visiting order requires. The c rays that
// want a cluster share the warp's 32 lanes out in teams of 32 / 2^ceil(log2 c)
// lanes: a team takes its ray's features from the ray's first lane
// (shuffles), its lanes split the cluster's rows (member m takes rows m,
// m + team, ...), and a butterfly over the team gives the (nearest t, lowest
// row with it), which the ray's lanes take if strictly nearer than its best.
// The rows are read from the tables in device memory, 16 bytes a load through
// the read-only cache (the triangles scene's four tables are 2.9 MB, a
// cluster 16 KB, far inside the 50 MB L2); nothing is staged in shared
// memory. The pairs are computed as the dense sweeps compute them
// (`sphere_root`, `tri_root`, the sums in column order), so every sweep of a
// primitive agrees to the bit wherever it tests the same pair; a strict `<`
// keeps the first winner in visiting order; a miss reports index 0.
//
// Why four lanes a ray: the work is uneven. Of the rays of a queue step most
// want no cluster at all, and the warps whose rays hit a mesh sweep hundreds
// of (ray, cluster) pairs, so a launch lasts as long as its heaviest warps.
// More lanes a ray spread that work over more warps, and splitting the slab
// tests between a ray's lanes keeps their count at one a (ray, cluster).
// `time_designs.py` times the loop at one to eight lanes a ray against a
// block-wide loop that staged each wanted cluster in shared memory for all
// 128 rays of a block (one block barrier a cluster).
//
// Visiting order. Spheres: table (Morton) order. Triangles, as the TPU's
// `_culled_kernel`: the wrapper sorts the rays by direction octant and origin
// cell (`ray_of` lists the rays in that order, `grp_oct` holds the octant of
// the first ray of each VISIT_GROUP of them), and the warps of a group visit
// the clusters front to back for its octant (`cl_ord`, (8, NC), the reference
// BVH's ordered traversal), so that `tnear < best_t` prunes the far clusters
// once a near hit is found, and the rays of a warp want the same clusters.
//
// What the TPU kernels have and this has not: their gate is per block of
// 256-512 rays (a tile of the matrix unit is all or nothing), so B10/B11
// compact a front-to-back cluster list per block in a pre-pass and break off
// early, B9 and B13 pay a grid step for every (block, cluster) tile, and B11
// and B12 read a transposed copy of the table through a two-slot DMA buffer.
// With a per-ray gate none of that is needed, and the TPU's two memory tiers
// (tables resident in VMEM or streamed from HBM) are one loop here: the five
// entry points differ in their seed, their visiting order and their name.
//
// All comparisons are explicit: a NaN ray (a dead lane) fails every slab
// test, sweeps nothing and comes back (INF or its seed, 0); 1/rd is +-inf on
// an axis-parallel ray and the test still orders. A box of zero thickness on
// one axis (a flat, axis-aligned cluster) is gated out for every ray, as the
// TPU kernels gate it: `tfar > tnear` is false there.
//
// What bounds them: fp32 instructions of the pairs actually tested, plus
// 3 x 9 + 4 a (ray, cluster) slab test; bytes are negligible.

// lanes of a warp; a host emulation runs warps of one lane
#ifndef MRT_WARP
#define MRT_WARP 32
#endif
static_assert(MRT_FLASH_THREADS % MRT_WARP == 0, "whole warps a block");

constexpr unsigned FULL_WARP = 0xffffffffu;
// lanes that work for one ray (a host emulation's warp of one lane: one)
constexpr int RAY_LANES = MRT_WARP >= 4 ? 4 : 1;
constexpr int WARP_RAYS = MRT_WARP / RAY_LANES;
// rays that share one visiting order; the wrapper's `grp_oct` has one entry
// for each VISIT_GROUP rays
constexpr int VISIT_GROUP = 128;
static_assert(VISIT_GROUP % WARP_RAYS == 0, "a warp within one visiting group");

// sum_k row[k] * f[k], in column order, from a row of a table in device
// memory (16-byte aligned: the wrapper checks the tables)
template <int F>
__device__ __forceinline__ float dot_table(const float* __restrict__ row, const float (&f)[F]) {
  const float4* const r4 = reinterpret_cast<const float4*>(row);
  float4 q = __ldg(r4);
  float acc = q.x * f[0];
  acc = acc + q.y * f[1];
  acc = acc + q.z * f[2];
  acc = acc + q.w * f[3];
#pragma unroll
  for (int k = 4; k + 3 < F; k += 4) {
    q = __ldg(r4 + k / 4);
    acc = acc + q.x * f[k];
    acc = acc + q.y * f[k + 1];
    acc = acc + q.z * f[k + 2];
    acc = acc + q.w * f[k + 3];
  }
#pragma unroll
  for (int k = F - F % 4; k < F; ++k) acc = acc + __ldg(row + k) * f[k];
  return acc;
}

// a sphere set: tables (b, c) of SPH_W words a row, SPH_F of them used
struct SpherePrim {
  static constexpr int F = SPH_F;
  __device__ static void features(const float (&ro)[3], const float (&rd)[3], float time,
                                  float (&f)[F]) {
    sphere_features(ro, rd, time, f);
  }
  __device__ static bool pair(const float* const (&tab)[4], int row, const float (&f)[F],
                              bool inside, float tmin, float& t) {
    const size_t o = (size_t)row * SPH_W;
    return sphere_root(dot_table<F>(tab[0] + o, f), dot_table<F>(tab[1] + o, f), inside, tmin,
                       t);
  }
};

// a triangle set: tables (det, uu, vv, tn) of TRI_F words a row
struct TriPrim {
  static constexpr int F = TRI_F;
  __device__ static void features(const float (&ro)[3], const float (&rd)[3], float,
                                  float (&f)[F]) {
    tri_features(ro, rd, f);
  }
  __device__ static bool pair(const float* const (&tab)[4], int row, const float (&f)[F],
                              bool inside, float tmin, float& t) {
    const size_t o = (size_t)row * TRI_F;
    return tri_root(dot_table<F>(tab[0] + o, f), dot_table<F>(tab[1] + o, f),
                    dot_table<F>(tab[2] + o, f), dot_table<F>(tab[3] + o, f), inside, tmin, t);
  }
};

// the coefficient tables of a primitive set, in cluster order
struct Tables {
  const float* t[4];
};

// does the ray cross cluster j's box beyond tmin; `tnear` gets where it
// enters the box (the ray wants the cluster when that is before its best)
__device__ __forceinline__ bool slab_cross(const float* __restrict__ bounds, int nc, int j,
                                           const float (&ro)[3], const float (&ird)[3],
                                           float tmin, float& tnear) {
  float tfar = 0.0f;
  tnear = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (bounds[a * nc + j] - ro[a]) * ird[a];
    const float t1 = (bounds[(3 + a) * nc + j] - ro[a]) * ird[a];
    const bool up = t0 < t1;
    const float lo = up ? t0 : t1, hi = up ? t1 : t0;
    tnear = (a == 0 || lo > tnear) ? lo : tnear;
    tfar = (a == 0 || hi < tfar) ? hi : tfar;
  }
  const float from = tnear > tmin ? tnear : tmin;
  return tfar > from;
}

// the lane of the k-th (from 0) set bit of a non-empty `mask` with more than k
// bits: the largest p with fewer than k + 1 set bits below it
__device__ __forceinline__ int nth_lane(unsigned mask, int k) {
  int p = 0;
#pragma unroll
  for (int w = MRT_WARP / 2; w > 0; w /= 2)
    if (__popc(mask & ((1u << (p + w)) - 1u)) <= k) p += w;
  return p;
}

// One team's sweep of the rows of a cluster for one ray: member m of `team`
// lanes tests rows m, m + team, ... in order; (t_min, row_min) is its nearest
// and the first row with it, (INF, rows) for none.
template <class P>
__device__ __forceinline__ void sweep_rows(const float* const (&tab)[4], int first, int rows,
                                           int member, int team, const float (&f)[P::F],
                                           bool inside, float tmin, float& t_min, int& row_min) {
  for (int row = member; row < rows; row += team) {
    float t;
    if (P::pair(tab, first + row, f, inside, tmin, t) && t < t_min) {
      t_min = t;
      row_min = row;
    }
  }
}

// The cluster loop of every clustered entry point. `time_in` is null for a
// primitive without motion, `seed_in` null for "from INF"; `ray_of` null means
// the rays in their own order and `cl_ord` null the clusters in table order
// (then `grp_oct` is not read). RAY_LANES lanes a ray: launch n * RAY_LANES
// threads.
template <class P>
__device__ __forceinline__ void clustered_sweep(
    const Tables tab, const float* __restrict__ bounds, const int* __restrict__ orig_of,
    const int* __restrict__ cl_ord, const int* __restrict__ ray_of,
    const int* __restrict__ grp_oct, const float* __restrict__ rox,
    const float* __restrict__ roy, const float* __restrict__ roz, const float* __restrict__ rdx,
    const float* __restrict__ rdy, const float* __restrict__ rdz,
    const float* __restrict__ time_in, const float* __restrict__ seed_in,
    const int* __restrict__ inside_in, float* __restrict__ t_out, int* __restrict__ i_out, int n,
    int nc, int block, float tmin) {
  const int lane_id = threadIdx.x % MRT_WARP;
  const int sub = lane_id % RAY_LANES;       // this lane's share of its ray's work
  const int first_lane = lane_id - sub;      // the ray's first lane
  const unsigned before = (1u << first_lane) - 1u;  // the lanes of the rays before it
  const int thread = blockIdx.x * blockDim.x + threadIdx.x;
  const int ray = thread / RAY_LANES;        // its position in the visiting order
  const bool live = ray < n;
  if (__ballot_sync(FULL_WARP, live) == 0) return;  // a warp wholly past the end
  const int pos = live ? ray : n - 1;  // a lane past the end still takes part in its warp's votes
  const int src = ray_of ? ray_of[pos] : pos;
  const float ro[3] = {rox[src], roy[src], roz[src]};
  const float rd[3] = {rdx[src], rdy[src], rdz[src]};
  const float ird[3] = {1.0f / rd[0], 1.0f / rd[1], 1.0f / rd[2]};
  const bool inside = inside_in[src] > 0;
  float f[P::F];
  P::features(ro, rd, time_in ? time_in[src] : 0.0f, f);
  const float* const tabs[4] = {tab.t[0], tab.t[1], tab.t[2], tab.t[3]};
  // the warp's visiting order: that of the group of its first ray
  const int* const order =
      cl_ord ? cl_ord + grp_oct[((thread - lane_id) / RAY_LANES) / VISIT_GROUP] * nc : nullptr;
  float best_t = seed_in ? seed_in[src] : INF;
  int best_i = -1;
  for (int s0 = 0; s0 < nc; s0 += RAY_LANES) {
    // the lanes of a ray test the next RAY_LANES clusters of its order, one each
    float tnear = 0.0f;
    const bool crossed = live && s0 + sub < nc &&
                         slab_cross(bounds, nc, order ? order[s0 + sub] : s0 + sub, ro, ird,
                                    tmin, tnear);
    // none of them entered before a ray's best: none is wanted, also later
    if (__ballot_sync(FULL_WARP, crossed && tnear < best_t) == 0) continue;
    // else one after the other in visiting order, each against the best so far
    for (int k = 0; k < RAY_LANES && s0 + k < nc; ++k) {
      const bool cr = __shfl_sync(FULL_WARP, (int)crossed, first_lane + k) != 0;
      const float tn = __shfl_sync(FULL_WARP, tnear, first_lane + k);
      const bool want = cr && tn < best_t;
      const unsigned wanting = __ballot_sync(FULL_WARP, want);  // RAY_LANES bits a ray
      if (wanting == 0) continue;
      const int j = order ? order[s0 + k] : s0 + k;
      const int first = j * block;
      // teams of `team` lanes, the q-th team for the q-th wanting ray
      const int c = __popc(wanting) / RAY_LANES;
      int team = MRT_WARP;
      while (team * c > MRT_WARP) team /= 2;
      const int q = lane_id / team, member = lane_id % team;
      const int owner = q < c ? nth_lane(wanting, q * RAY_LANES) : lane_id;
      float g[P::F];
#pragma unroll
      for (int w = 0; w < P::F; ++w) g[w] = __shfl_sync(FULL_WARP, f[w], owner);
      const bool g_inside = __shfl_sync(FULL_WARP, (int)inside, owner) != 0;
      float t_min = INF;
      int row_min = block;
      if (q < c) sweep_rows<P>(tabs, first, block, member, team, g, g_inside, tmin, t_min, row_min);
      // the nearest over the team, the lowest row among equals
      for (int off = team / 2; off > 0; off /= 2) {
        const float t_o = __shfl_xor_sync(FULL_WARP, t_min, off);
        const int row_o = __shfl_xor_sync(FULL_WARP, row_min, off);
        if (t_o < t_min || (t_o == t_min && row_o < row_min)) {
          t_min = t_o;
          row_min = row_o;
        }
      }
      // the lanes of each wanting ray take its team's result from the team's first lane
      const int from = (__popc(wanting & before) / RAY_LANES) * team;
      t_min = __shfl_sync(FULL_WARP, t_min, from % MRT_WARP);
      row_min = __shfl_sync(FULL_WARP, row_min, from % MRT_WARP);
      if (want && t_min < best_t) {
        best_t = t_min;
        best_i = first + row_min;
      }
    }
  }
  if (live && sub == 0) {
    t_out[src] = best_t;
    i_out[src] = best_i >= 0 ? orig_of[best_i] : 0;
  }
}

__global__ void __launch_bounds__(MRT_FLASH_THREADS)
flash_sphere_gated_kernel(const float* __restrict__ cb, const float* __restrict__ cc,
                          const float* __restrict__ bounds, const int* __restrict__ orig_of,
                          const float* __restrict__ rox, const float* __restrict__ roy,
                          const float* __restrict__ roz, const float* __restrict__ rdx,
                          const float* __restrict__ rdy, const float* __restrict__ rdz,
                          const float* __restrict__ time_in, const int* __restrict__ inside_in,
                          float* __restrict__ t_out, int* __restrict__ i_out, int n, int nc,
                          int block, float tmin) {
  clustered_sweep<SpherePrim>(Tables{{cb, cc, nullptr, nullptr}}, bounds, orig_of, nullptr,
                              nullptr, nullptr, rox, roy, roz, rdx, rdy, rdz, time_in, nullptr,
                              inside_in, t_out, i_out, n, nc, block, tmin);
}

__global__ void __launch_bounds__(MRT_FLASH_THREADS)
flash_sphere_streamed_kernel(const float* __restrict__ cb, const float* __restrict__ cc,
                             const float* __restrict__ bounds, const int* __restrict__ orig_of,
                             const float* __restrict__ rox, const float* __restrict__ roy,
                             const float* __restrict__ roz, const float* __restrict__ rdx,
                             const float* __restrict__ rdy, const float* __restrict__ rdz,
                             const float* __restrict__ time_in,
                             const float* __restrict__ seed_in,
                             const int* __restrict__ inside_in, float* __restrict__ t_out,
                             int* __restrict__ i_out, int n, int nc, int block, float tmin) {
  clustered_sweep<SpherePrim>(Tables{{cb, cc, nullptr, nullptr}}, bounds, orig_of, nullptr,
                              nullptr, nullptr, rox, roy, roz, rdx, rdy, rdz, time_in, seed_in,
                              inside_in, t_out, i_out, n, nc, block, tmin);
}

// The three triangle entry points, B9 (culled), B10 (resident) and B11
// (streamed): one body, one kernel name each, so that a profile tells which
// of the TPU's routes a launch stands for.
template <int ROUTE>
__global__ void __launch_bounds__(MRT_FLASH_THREADS)
flash_tri_clustered_kernel(const float* __restrict__ c_det, const float* __restrict__ c_uu,
                           const float* __restrict__ c_vv, const float* __restrict__ c_tn,
                           const float* __restrict__ bounds, const int* __restrict__ orig_of,
                           const int* __restrict__ cl_ord, const int* __restrict__ ray_of,
                           const int* __restrict__ grp_oct, const float* __restrict__ rox,
                           const float* __restrict__ roy, const float* __restrict__ roz,
                           const float* __restrict__ rdx, const float* __restrict__ rdy,
                           const float* __restrict__ rdz, const float* __restrict__ seed_in,
                           const int* __restrict__ inside_in, float* __restrict__ t_out,
                           int* __restrict__ i_out, int n, int nc, int block, float tmin) {
  clustered_sweep<TriPrim>(Tables{{c_det, c_uu, c_vv, c_tn}}, bounds, orig_of, cl_ord, ray_of,
                           grp_oct, rox, roy, roz, rdx, rdy, rdz, nullptr, seed_in, inside_in,
                           t_out, i_out, n, nc, block, tmin);
}

// blocks of a clustered launch, RAY_LANES threads a ray; 0 when the thread
// index would not fit an int
int clustered_blocks(int n, int threads) {
  const long long lanes = (long long)n * RAY_LANES;
  return lanes > 0x7fffffffLL - threads ? 0 : (int)((lanes + threads - 1) / threads);
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

// The clustered sphere sweeps: tables (nc * block, 24) f32 in cluster order,
// bounds (8, nc) f32, orig_of (nc * block,) i32; the streamed one also takes a
// seed distance a ray, (n,) f32.
int mrt_flash_sphere_gated(const float* cb, const float* cc, const float* bounds,
                           const int* orig_of, const float* rox, const float* roy,
                           const float* roz, const float* rdx, const float* rdy,
                           const float* rdz, const float* time, const int* inside, float* t_out,
                           int* i_out, int n, int nc, int block, float tmin, void* stream) {
  if (n <= 0) return 0;
  const int threads = MRT_FLASH_THREADS;
  const int blocks = clustered_blocks(n, threads);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  MRT_LAUNCH(flash_sphere_gated_kernel, blocks, threads, 0, stream, cb, cc, bounds, orig_of, rox,
             roy, roz, rdx, rdy, rdz, time, inside, t_out, i_out, n, nc, block, tmin);
  return (int)cudaGetLastError();
}

int mrt_flash_sphere_streamed(const float* cb, const float* cc, const float* bounds,
                              const int* orig_of, const float* rox, const float* roy,
                              const float* roz, const float* rdx, const float* rdy,
                              const float* rdz, const float* time, const float* seed,
                              const int* inside, float* t_out, int* i_out, int n, int nc,
                              int block, float tmin, void* stream) {
  if (n <= 0) return 0;
  const int threads = MRT_FLASH_THREADS;
  const int blocks = clustered_blocks(n, threads);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  MRT_LAUNCH(flash_sphere_streamed_kernel, blocks, threads, 0, stream, cb, cc, bounds, orig_of,
             rox, roy, roz, rdx, rdy, rdz, time, seed, inside, t_out, i_out, n, nc, block, tmin);
  return (int)cudaGetLastError();
}

// The clustered triangle sweeps, `route` 9 (culled), 10 (resident) or 11
// (streamed): tables (nc * block, 16) f32 in cluster order, bounds (8, nc)
// f32, orig_of (nc * block,) i32, cl_ord (8, nc) i32 (the clusters front to
// back for each direction octant), ray_of (n,) i32 (the rays in visiting
// order), grp_oct (ceil(n / 128),) i32 (the octant of each group of 128 of
// them), a seed distance a ray (n,) f32 (3e38 for none).
int mrt_flash_tri_clustered(int route, const float* c_det, const float* c_uu,
                            const float* c_vv, const float* c_tn, const float* bounds,
                            const int* orig_of, const int* cl_ord, const int* ray_of,
                            const int* grp_oct, const float* rox, const float* roy,
                            const float* roz, const float* rdx, const float* rdy,
                            const float* rdz, const float* seed, const int* inside,
                            float* t_out, int* i_out, int n, int nc, int block, float tmin,
                            void* stream) {
  if (n <= 0) return 0;
  const int threads = MRT_FLASH_THREADS;
  const int blocks = clustered_blocks(n, threads);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
#define MRT_TRI_CLUSTERED(R)                                                                     \
  MRT_LAUNCH(flash_tri_clustered_kernel<R>, blocks, threads, 0, stream, c_det, c_uu, c_vv, c_tn, \
             bounds, orig_of, cl_ord, ray_of, grp_oct, rox, roy, roz, rdx, rdy, rdz, seed,       \
             inside, t_out, i_out, n, nc, block, tmin)
  switch (route) {
    case 9: MRT_TRI_CLUSTERED(9); break;
    case 10: MRT_TRI_CLUSTERED(10); break;
    case 11: MRT_TRI_CLUSTERED(11); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MRT_TRI_CLUSTERED
  return (int)cudaGetLastError();
}

const char* mrt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
