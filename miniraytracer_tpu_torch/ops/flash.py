"""Nearest-hit sweeps: for every ray the closest triangle, or the closest
sphere, of a set. Port of `miniraytracer_tpu/ops/flash.py`'s dense tier
(`flash_tri_hit`, `flash_sphere_hit`: ALL primitives for every ray), of its
clustered sphere sweeps (`sph_cull_build`, `flash_sphere_hit_gated`,
`flash_sphere_hit_streamed`: see "Clustered sphere sweeps" below) and of its
clustered triangle sweeps (`tri_cull_build`, `flash_tri_hit_culled`,
`flash_tri_hit_resident`, `flash_tri_hit_streamed`: "Clustered triangle
sweeps").

Moller-Trumbore is bilinear in (ray origin, ray direction), and the sphere
quadratic's b and c are too once the moving centre is written as affine in
the ray time. So each per-pair quantity is an inner product of a row of
per-primitive coefficients with a per-ray feature vector:

    triangles: det, uu, vv, tn = <(T, 16) coefficient rows, [1, ro, rd, ro (x) rd]>
    spheres:   b, c            = <(S, 24) rows (17 used), [1, ro, rd, ro.rd,
                                  |ro|^2, time, time^2, time*ro, time*rd]>

The JAX package computes them as matrix products inside its kernels and keeps
a running (min t, first index) per ray. Here the kernels are
`csrc/flash.cu`: one thread per ray holds the features in registers, a block
stages a tile of coefficient rows in shared memory, and every thread sweeps
the tile in index order with a strict `<`, so the lowest index wins a tie.
The sums are taken term by term in column order. The coefficient tables keep
the JAX layout (24 columns for spheres, 7 of them zero); the row and ray
padding of the TPU tiles is gone.

Beside each kernel is its plain PyTorch version (`*_plain`), with the same
term-by-term sums. The wrappers launch the kernel for CUDA tensors and run
the plain version for CPU tensors. Dead lanes arrive as NaN rays and come
back as misses (t = INF, index 0).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from miniraytracer_tpu_torch.ops.vecmath import V3, vcross, vsqrt
from miniraytracer_tpu_torch.scene import types as T
from miniraytracer_tpu_torch.utils import device

INF = 3.0e38
TRI_EPS = 1e-5  # triangle.cpp:220
NUM_FEATURES = 16  # triangle features
SPH_FEATURES = 24  # sphere table width of the JAX package
SPH_USED = 17  # columns that carry a feature; the rest are zero

# rays of one slice of the plain sweeps: bounds the (prims, rays) temporaries
PLAIN_RAY_CHUNK = 16384

# spheres of one Morton cluster (doubled while there would be more than 512
# clusters, as in the JAX package, so that both packages cut the same clusters)
SPH_CULL_BLOCK = 128

# Launch counts of the CUDA kernels (never the plain versions).
tri_launches = 0
sphere_launches = 0
gated_launches = 0
streamed_launches = 0
culled_launches = 0  # B9
resident_launches = 0  # B10
tri_streamed_launches = 0  # B11


# ---------------------------------------------------------------------------
# Coefficient tables and ray features
# ---------------------------------------------------------------------------


def tri_coefficients(m: V3, u: V3, v: V3, active):
    """Per-triangle coefficient rows, four (T, 16) tables for det/uu/vv/tn:

        raw_det = rd.(v x u)
        raw_uu  = ro.(rd x v) - m.(rd x v)
        raw_vv  = -ro.(rd x u) + m.(rd x u)
        raw_tn  = (ro - m).(u x v)

    Feature order: [1, ro(3), rd(3), ro_i*rd_j (9, i major)]. Inactive rows
    are all zero (det = 0: never valid)."""
    zeros = torch.zeros_like(m.x)

    def rows(const, ro_c, rd_c, ord_c):
        cols = [const, *ro_c, *rd_c]
        cols += [ord_c.get((i, j), zeros) for i in range(3) for j in range(3)]
        return torch.stack(cols, dim=1)

    def eps_outer(w: V3, s=1.0):
        # e_ijk w_k as {(i, j): coefficient}
        return {(0, 1): s * w.z, (0, 2): -s * w.y, (1, 0): -s * w.z,
                (1, 2): s * w.x, (2, 0): s * w.y, (2, 1): -s * w.x}

    z3 = (zeros, zeros, zeros)
    vxu, vxm, uxm, uxv = vcross(v, u), vcross(v, m), vcross(u, m), vcross(u, v)
    c_det = rows(zeros, z3, tuple(vxu), {})
    c_uu = rows(zeros, z3, tuple(-x for x in vxm), eps_outer(v))
    c_vv = rows(zeros, z3, tuple(uxm), eps_outer(u, -1.0))
    c_tn = rows(-(m.x * uxv.x + m.y * uxv.y + m.z * uxv.z), tuple(uxv), z3, {})
    act = active.to(torch.float32)[:, None]
    return c_det * act, c_uu * act, c_vv * act, c_tn * act


def scene_tri_coefficients(scene: T.SceneData):
    cols = lambda t: V3(t[:, 0], t[:, 1], t[:, 2])
    return tri_coefficients(cols(scene.tri_m), cols(scene.tri_u),
                            cols(scene.tri_v), scene.tri_active)


def ray_features(ro: V3, rd: V3) -> torch.Tensor:
    """(16, N) triangle feature matrix."""
    rows = [torch.ones_like(ro.x), *ro, *rd]
    rows += [o * d for o in ro for d in rd]
    return torch.stack(rows)


def sphere_coefficients(scene: T.SceneData):
    """Per-sphere coefficient rows (cb, cc), each (S, 24), for the quadratic's
    b = oc.rd and c = |oc|^2 - r^2 with the moving centre (sphere.h:24-31)
    affine in ray time: cen(time) = P + time*Q. Inactive rows get 1.5e38
    added to c's constant (disc < 0: never hit)."""
    cols = lambda t: V3(t[:, 0], t[:, 1], t[:, 2])
    c0, c1 = cols(scene.sph_c0), cols(scene.sph_c1)
    t0, t1, mov, r = scene.sph_t0, scene.sph_t1, scene.sph_moving, scene.sph_radius
    denom = torch.where(mov > 0, t1 - t0, 1.0)
    alpha = torch.where(mov > 0, 1.0 / denom, 0.0)
    beta = torch.where(mov > 0, -t0 / denom, 0.0)
    dc = c1 - c0
    P = c0 + dc * beta
    Q = dc * alpha
    zeros = torch.zeros_like(r)
    ones = torch.ones_like(r)

    def row(const, ro_c, rd_c, rord, rosq, t_c, t2_c, tro_c, trd_c):
        cols_ = [const, *ro_c, *rd_c, rord, rosq, t_c, t2_c, *tro_c, *trd_c]
        cols_ += [zeros] * (SPH_FEATURES - len(cols_))
        return torch.stack(cols_, dim=1)

    z3 = (zeros, zeros, zeros)
    cb = row(zeros, z3, (-P.x, -P.y, -P.z), ones, zeros, zeros, zeros,
             z3, (-Q.x, -Q.y, -Q.z))
    psq = P.x * P.x + P.y * P.y + P.z * P.z
    pq = P.x * Q.x + P.y * Q.y + P.z * Q.z
    qsq = Q.x * Q.x + Q.y * Q.y + Q.z * Q.z
    cc = row(psq - r * r + torch.where(~scene.sph_active, INF * 0.5, 0.0),
             (-2.0 * P.x, -2.0 * P.y, -2.0 * P.z), z3,
             zeros, ones, 2.0 * pq, qsq,
             (-2.0 * Q.x, -2.0 * Q.y, -2.0 * Q.z), z3)
    return cb, cc


def sphere_ray_features(ro: V3, rd: V3, time) -> torch.Tensor:
    """(24, N) sphere feature matrix (17 rows used, then zeros)."""
    rows = [torch.ones_like(time), *ro, *rd,
            ro.x * rd.x + ro.y * rd.y + ro.z * rd.z,
            ro.x * ro.x + ro.y * ro.y + ro.z * ro.z,
            time, time * time,
            time * ro.x, time * ro.y, time * ro.z,
            time * rd.x, time * rd.y, time * rd.z]
    rows += [torch.zeros_like(time)] * (SPH_FEATURES - len(rows))
    return torch.stack(rows)


def coefficients_from_numpy(tables):
    """Coefficient tables made elsewhere (the JAX package's, as numpy arrays)
    as the float32 CPU tensors the sweeps take."""
    return tuple(torch.as_tensor(np.asarray(t, np.float32).copy()) for t in tables)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _dot_rows(table, f, width):
    """(P, width) . (width, n) -> (P, n), summed term by term in column
    order, as the kernels sum (no library matrix product: its summation
    order is not fixed, and c cancels heavily on a radius-1000 sphere)."""
    acc = table[:, 0:1] * f[0:1]
    for k in range(1, width):
        acc = acc + table[:, k:k + 1] * f[k:k + 1]
    return acc


def _running_min(cand):
    """(min t, first index of it) over the primitive axis; INF rows -> 0."""
    t = torch.amin(cand, dim=0)
    # the lowest index that attains the minimum (torch.min's own index is
    # documented as the first of equal minima for no device)
    first = torch.argmax((cand == t[None, :]).to(torch.uint8), dim=0)
    idx = torch.where(t < INF, first, 0).to(torch.int32)
    return t, idx


def _check_rays(n, **tensors):
    for name, t in tensors.items():
        if t.shape != (n,):
            raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")


def _tri_test(det, uu, vv, tn, inside, tmin):
    """Hit distance of (ray, triangle) pairs from their four inner products,
    INF for none; `inside` broadcasts against them."""
    # backfaces (triangle.cpp:226-235) only for a ray inside a medium
    sign = torch.where((inside > 0) & (det < 0.0), -1.0, 1.0)
    sdet, suu, svv = det * sign, uu * sign, vv * sign
    t = tn / det  # 0/0 on inactive rows: masked by sdet >= TRI_EPS
    valid = ((sdet >= TRI_EPS) & (suu >= 0.0) & (svv >= 0.0)
             & (suu + svv <= sdet) & (t >= tmin))
    return torch.where(valid, t, INF)


def _tri_candidates(coeffs, f, inside, tmin):
    """(T, n) hit distance of every (triangle, ray) pair, INF for none."""
    return _tri_test(*(_dot_rows(c, f, NUM_FEATURES) for c in coeffs), inside[None, :], tmin)


def flash_tri_hit_plain(coeffs, ro: V3, rd: V3, inside, tmin):
    """Plain PyTorch version of `flash_tri_hit`, on any device."""
    n = ro.x.shape[0]
    ts, idxs = [], []
    for s in range(0, n, PLAIN_RAY_CHUNK):
        sl = slice(s, s + PLAIN_RAY_CHUNK)
        f = ray_features(V3(*(c[sl] for c in ro)), V3(*(c[sl] for c in rd)))
        t_c, i_c = _running_min(_tri_candidates(coeffs, f, inside[sl], tmin))
        ts.append(t_c)
        idxs.append(i_c)
    return torch.cat(ts), torch.cat(idxs)


def _sphere_candidates(cb, cc, f, inside, tmin):
    """(S, n) hit distance of every (sphere, ray) pair, INF for none: the
    front root if > tmin, else the back root, and that only when inside > 0."""
    b = _dot_rows(cb, f, SPH_USED)
    c = _dot_rows(cc, f, SPH_USED)
    disc = b * b - c
    ok = disc > 0.0
    sq = vsqrt(torch.where(ok, disc, 0.0))
    t_front = -b - sq
    t_back = -b + sq
    front_ok = ok & (t_front > tmin)
    back_ok = ok & (inside[None, :] > 0) & (t_back > tmin)
    return torch.where(front_ok, t_front, torch.where(back_ok, t_back, INF))


def flash_sphere_hit_plain(coeffs, ro: V3, rd: V3, time, inside, tmin):
    """Plain PyTorch version of `flash_sphere_hit`, on any device."""
    cb, cc = coeffs
    n = time.shape[0]
    ts, idxs = [], []
    for s in range(0, n, PLAIN_RAY_CHUNK):
        sl = slice(s, s + PLAIN_RAY_CHUNK)
        f = sphere_ray_features(V3(*(c[sl] for c in ro)),
                                V3(*(c[sl] for c in rd)), time[sl])
        t_c, i_c = _running_min(_sphere_candidates(cb, cc, f, inside[sl], tmin))
        ts.append(t_c)
        idxs.append(i_c)
    return torch.cat(ts), torch.cat(idxs)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_kernel_args(dev, n, width, tables, lanes_f32, inside):
    rows = tables[0].shape[0]
    for t in tables:
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (rows, width) or not t.is_contiguous()):
            raise ValueError(f"coefficient tables must be contiguous float32 "
                             f"({rows}, {width}) tensors on {dev}")
    for t in lanes_f32:
        if (t.device != dev or t.dtype != torch.float32 or t.shape != (n,)
                or not t.is_contiguous()):
            raise ValueError(f"ray components must be contiguous float32 "
                             f"({n},) tensors on {dev}")
    if (inside.device != dev or inside.dtype != torch.int32
            or inside.shape != (n,) or not inside.is_contiguous()):
        raise ValueError(f"inside must be a contiguous int32 ({n},) tensor on {dev}")
    if n >= 2 ** 31 - 1024 or rows >= 2 ** 24:
        raise ValueError("too many rays or primitives for int32 indexing")
    return rows


def _launch(fn_name, tables, lanes, inside, extra):
    """Launch one sweep of csrc/flash.cu on the current stream."""
    from miniraytracer_tpu_torch.utils import kernels

    dev, n = inside.device, inside.shape[0]
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    i_out = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = kernels.load("flash")
    fn = getattr(lib, fn_name)
    ptrs = [*tables, *lanes, inside, t_out, i_out]
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs)
                   + [ctypes.c_float if isinstance(x, ctypes.c_float) else ctypes.c_int
                      for x in extra] + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in ptrs], *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: {kernels.error_string(lib, rc)}")
    return t_out, i_out


def flash_tri_hit(coeffs, ro: V3, rd: V3, inside, tmin):
    """Closest triangle hit over ALL triangles for each ray.

    coeffs: (c_det, c_uu, c_vv, c_tn), each (T, 16), from `tri_coefficients`.
    ro, rd: V3 of (N,) float32; inside (N,) int32 (backfaces count only when
    > 0); t >= tmin. Returns (t (N,) f32 with INF for a miss, idx (N,) i32):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    n = inside.shape[0]
    _check_rays(n, **{f"ro.{k}": c for k, c in zip("xyz", ro)},
                **{f"rd.{k}": c for k, c in zip("xyz", rd)})
    if device.kind(inside, "nearest-hit sweep") == "cpu":
        return flash_tri_hit_plain(coeffs, ro, rd, inside, tmin)
    global tri_launches
    rows = _check_kernel_args(inside.device, n, NUM_FEATURES, coeffs,
                              [*ro, *rd], inside)
    out = _launch("mrt_flash_tri_hit", coeffs, [*ro, *rd], inside,
                  (n, rows, ctypes.c_float(tmin)))
    tri_launches += 1
    return out


def flash_sphere_hit(coeffs, ro: V3, rd: V3, time, inside, tmin):
    """Closest sphere hit over ALL spheres for each ray: the front root when
    > tmin, the back root only when inside > 0 (sphere.cpp:33-43).

    coeffs: (cb, cc), each (S, 24), from `sphere_coefficients`. Returns
    (t, idx) as `flash_tri_hit`."""
    n = inside.shape[0]
    _check_rays(n, time=time, **{f"ro.{k}": c for k, c in zip("xyz", ro)},
                **{f"rd.{k}": c for k, c in zip("xyz", rd)})
    if device.kind(inside, "nearest-hit sweep") == "cpu":
        return flash_sphere_hit_plain(coeffs, ro, rd, time, inside, tmin)
    global sphere_launches
    rows = _check_kernel_args(inside.device, n, SPH_FEATURES, coeffs,
                              [*ro, *rd, time], inside)
    out = _launch("mrt_flash_sphere_hit", coeffs, [*ro, *rd, time], inside,
                  (n, rows, ctypes.c_float(tmin)))
    sphere_launches += 1
    return out


# ---------------------------------------------------------------------------
# Clustered sphere sweeps
# ---------------------------------------------------------------------------
# For a sphere set too large to test every pair: `sph_cull_build` sorts the
# spheres along a Morton curve and cuts the sorted table into clusters of
# `SPH_CULL_BLOCK` with a bounding box each. A ray sweeps a cluster only when
# it crosses the box beyond tmin and enters it before its current best hit:
#
#     tfar > max(tnear, tmin)  and  tnear < best_t
#
# Clusters are visited in table order and a hit replaces the best only when
# strictly nearer, so of two spheres at the same distance the FIRST IN MORTON
# ORDER wins (the dense sweep gives the lowest original index). The gate is
# per ray; the JAX package's kernels gate a block of 512 rays at once, so a
# ray whose own slab test fails may still be tested there. Slab test and
# quadratic are different float expressions: at a grazing hit on a cluster's
# outermost sphere the clustered sweep can miss what the dense sweep (and the
# JAX package) hits. Everywhere else the pairs are computed as the dense sweep
# computes them, and the results are equal to the bit.
#
# `flash_sphere_hit_gated` (512..4095 spheres in the renderer) and
# `flash_sphere_hit_streamed` (any count; it also takes a seed distance per
# ray and returns it where nothing is nearer) are the JAX package's two entry
# points, which differ there in where the table lives. Here they compute the
# same function and their kernels share one cluster loop (csrc/flash.cu): a
# thread gates its own ray, and the lanes of a warp share out the rows of a
# cluster for each ray of theirs that wants it.


def _spread3(x):
    """Interleave the low 10 bits of x (int64) with two zero bits each."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton_key(centres, act):
    """(P,) int64 Morton key of points `centres` (three (P,) coordinates),
    10 bits an axis over the range of the active ones; inactive points get
    0xFFFFFFFF and sort last."""
    def qaxis(c):
        lo = torch.amin(torch.where(act, c, INF))
        hi = torch.amax(torch.where(act, c, -INF))
        tq = torch.clamp((c - lo) / torch.clamp_min(hi - lo, 1e-30), 0.0, 0.999999)
        return (tq * 1024.0).to(torch.int64)

    qx, qy, qz = (qaxis(c) for c in centres)
    key = (_spread3(qx) << 2) | (_spread3(qy) << 1) | _spread3(qz)
    return torch.where(act, key, 0xFFFFFFFF)


def _pad_rows(x, mult, value):
    rem = (-x.shape[0]) % mult
    if rem == 0:
        return x
    pad = torch.full((rem, *x.shape[1:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def sph_cull_build(scene: T.SceneData, coeffs, block: int | None = None):
    """Morton-order the spheres into clusters of `block` with bounding boxes.

    coeffs: (cb, cc) of `sphere_coefficients`, in scene order. The Morton key
    is taken at the midpoint of a sphere's motion; a box spans both endpoints
    of the motion with half-width |radius| (a negative radius is a hollow
    shell of the same extent). Inactive spheres sort last, keep their
    never-hit coefficients and contribute inverted boxes. Returns
    ((cbp, ccp) tables in cluster order, zero rows up to a multiple of
    `block`; bounds (8, NC) = lo xyz, hi xyz, two zero rows; orig_of (NC *
    block,) int32: the scene index of each table row, 0 for padding)."""
    cb, cc = coeffs
    s_count = scene.sph_radius.shape[0]
    if block is None:
        block = SPH_CULL_BLOCK
        while s_count > 512 * block:
            block *= 2
    act = scene.sph_active.to(torch.bool)
    mov = scene.sph_moving > 0
    r_abs = torch.abs(scene.sph_radius)
    ends = [(scene.sph_c0[:, a], torch.where(mov, scene.sph_c1[:, a], scene.sph_c0[:, a]))
            for a in range(3)]
    perm = torch.argsort(_morton_key([(c0 + c1) * 0.5 for c0, c1 in ends], act), stable=True)

    orig_of = _pad_rows(perm.to(torch.int32), block, 0)
    cbp = _pad_rows(cb[perm], block, 0.0)
    ccp = _pad_rows(cc[perm], block, 0.0)
    nc = cbp.shape[0] // block
    los, his = [], []
    for c0, c1 in ends:
        lo_c = torch.where(act, torch.minimum(c0, c1) - r_abs, INF)
        hi_c = torch.where(act, torch.maximum(c0, c1) + r_abs, -INF)
        los.append(torch.amin(_pad_rows(lo_c[perm], block, INF).reshape(nc, block), dim=1))
        his.append(torch.amax(_pad_rows(hi_c[perm], block, -INF).reshape(nc, block), dim=1))
    zero = torch.zeros_like(los[0])
    bounds = torch.stack(los + his + [zero, zero])
    return (cbp.contiguous(), ccp.contiguous()), bounds.contiguous(), orig_of


def _slab_distances(lo, hi, ro: V3, ird):
    """(tnear, tfar) of each ray to boxes lo, hi ((3, n, k), the boxes of
    ray r in row r, or broadcast to it) in the kernel's order of operations:
    comparisons only, so that a NaN ray fails every test."""
    tnear = tfar = None
    for a in range(3):
        t0 = (lo[a] - ro[a][:, None]) * ird[a][:, None]
        t1 = (hi[a] - ro[a][:, None]) * ird[a][:, None]
        up = t0 < t1
        near, far = torch.where(up, t0, t1), torch.where(up, t1, t0)
        tnear = near if a == 0 else torch.where(near > tnear, near, tnear)
        tfar = far if a == 0 else torch.where(far < tfar, far, tfar)
    return tnear, tfar


def _crosses(tnear, tfar, tmin):
    """The ray crosses the box beyond tmin."""
    return tfar > torch.where(tnear > tmin, tnear, tmin)


def _slab_gate(bounds, j, ro: V3, ird, tmin, best_t):
    """Which rays want cluster j (see above): a NaN ray wants nothing."""
    tnear, tfar = _slab_distances(bounds[0:3, j, None, None], bounds[3:6, j, None, None], ro, ird)
    return (_crosses(tnear, tfar, tmin) & (tnear < best_t[:, None]))[:, 0]


def _clustered_sphere_hit_plain(cull, ro: V3, rd: V3, time, inside, tmin, t_seed,
                                count=None):
    (cbp, ccp), bounds, orig_of = cull
    nc = bounds.shape[1]
    block = cbp.shape[0] // nc
    n = time.shape[0]
    ts, idxs = [], []
    for s in range(0, n, PLAIN_RAY_CHUNK):
        sl = slice(s, s + PLAIN_RAY_CHUNK)
        ro_c, rd_c = V3(*(c[sl] for c in ro)), V3(*(c[sl] for c in rd))
        f = sphere_ray_features(ro_c, rd_c, time[sl])
        ird = [1.0 / c for c in rd_c]
        best_t = (torch.full_like(time[sl], INF) if t_seed is None
                  else t_seed[sl].clone())
        best_row = torch.full_like(inside[sl], -1, dtype=torch.int64)
        for j in range(nc):
            want = torch.nonzero(_slab_gate(bounds, j, ro_c, ird, tmin, best_t))[:, 0]
            if count is not None:
                count["clusters"] = count.get("clusters", 0) + want.numel()
            if want.numel() == 0:
                continue
            rows = slice(j * block, (j + 1) * block)
            t_c, i_c = _running_min(_sphere_candidates(
                cbp[rows], ccp[rows], f[:, want], inside[sl][want], tmin))
            better = t_c < best_t[want]
            won = want[better]
            best_t[won] = t_c[better]
            best_row[won] = i_c[better].to(torch.int64) + j * block
        ts.append(best_t)
        idxs.append(torch.where(best_row >= 0, orig_of[best_row.clamp_min(0)], 0))
    return torch.cat(ts), torch.cat(idxs).to(torch.int32)


def flash_sphere_hit_gated_plain(cull, ro: V3, rd: V3, time, inside, tmin, count=None):
    """Plain PyTorch version of `flash_sphere_hit_gated`, on any device.
    `count`, a dict, gets under "clusters" the number of (ray, cluster) pairs
    that passed the gate: the work the sweep did on these rays."""
    return _clustered_sphere_hit_plain(cull, ro, rd, time, inside, tmin, None, count)


def flash_sphere_hit_streamed_plain(cull, ro: V3, rd: V3, time, inside, tmin,
                                    t_seed=None, count=None):
    """Plain PyTorch version of `flash_sphere_hit_streamed`, on any device;
    `count` as in `flash_sphere_hit_gated_plain`."""
    return _clustered_sphere_hit_plain(cull, ro, rd, time, inside, tmin, t_seed, count)


def _check_cull(cull, dev):
    tables, bounds, orig_of = cull[:3]
    nc = bounds.shape[1]
    if (bounds.device != dev or bounds.dtype != torch.float32 or bounds.shape[0] != 8
            or nc < 1 or not bounds.is_contiguous()):
        raise ValueError(f"bounds must be a contiguous float32 (8, NC) tensor on {dev}")
    rows = tables[0].shape[0]
    if rows % nc or (orig_of.device != dev or orig_of.dtype != torch.int32
                     or orig_of.shape != (rows,) or not orig_of.is_contiguous()):
        raise ValueError(f"orig_of must be a contiguous int32 ({rows},) tensor on "
                         f"{dev}, a whole number of rows a cluster")
    return nc, rows // nc


def flash_sphere_hit_gated(cull, ro: V3, rd: V3, time, inside, tmin):
    """Closest sphere hit over the clusters of `cull` (`sph_cull_build`),
    every ray from t = INF. Returns (t, idx) as `flash_sphere_hit`, idx in the
    scene's numbering: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    n = inside.shape[0]
    _check_rays(n, time=time, **{f"ro.{k}": c for k, c in zip("xyz", ro)},
                **{f"rd.{k}": c for k, c in zip("xyz", rd)})
    if device.kind(inside, "nearest-hit sweep") == "cpu":
        return flash_sphere_hit_gated_plain(cull, ro, rd, time, inside, tmin)
    global gated_launches
    nc, block = _check_cull(cull, inside.device)
    _check_kernel_args(inside.device, n, SPH_FEATURES, cull[0], [*ro, *rd, time], inside)
    out = _launch("mrt_flash_sphere_gated", (*cull[0], cull[1], cull[2]),
                  [*ro, *rd, time], inside, (n, nc, block, ctypes.c_float(tmin)))
    gated_launches += 1
    return out


def flash_sphere_hit_streamed(cull, ro: V3, rd: V3, time, inside, tmin, t_seed=None):
    """Closest sphere hit over the clusters of `cull`, for any sphere count,
    every ray from `t_seed` ((N,) f32; None means INF): t comes back equal to
    the seed, with index 0, where no sphere is nearer. The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    n = inside.shape[0]
    _check_rays(n, time=time, **{f"ro.{k}": c for k, c in zip("xyz", ro)},
                **{f"rd.{k}": c for k, c in zip("xyz", rd)})
    if t_seed is not None:
        _check_rays(n, t_seed=t_seed)
    if device.kind(inside, "nearest-hit sweep") == "cpu":
        return flash_sphere_hit_streamed_plain(cull, ro, rd, time, inside, tmin, t_seed)
    global streamed_launches
    nc, block = _check_cull(cull, inside.device)
    seed = torch.full_like(time, INF) if t_seed is None else t_seed
    _check_kernel_args(inside.device, n, SPH_FEATURES, cull[0], [*ro, *rd, time, seed],
                       inside)
    out = _launch("mrt_flash_sphere_streamed", (*cull[0], cull[1], cull[2]),
                  [*ro, *rd, time, seed], inside, (n, nc, block, ctypes.c_float(tmin)))
    streamed_launches += 1
    return out


# ---------------------------------------------------------------------------
# Clustered triangle sweeps
# ---------------------------------------------------------------------------
# For 1024 triangles or more: `tri_cull_build` sorts the triangles along a
# Morton curve of their centroids and cuts the sorted table into clusters of
# `TRI_CULL_BLOCK` with a bounding box each, and lists for each of the eight
# direction octants the clusters front to back (`cl_ord`). A sweep sorts the
# rays by octant and origin cell (`_ray_sort_key`), gives each group of
# `VISIT_GROUP` sorted rays the octant of its first ray, and visits the
# clusters in that octant's order; a ray sweeps a cluster when it passes the
# slab test of the clustered sphere sweeps above (`_slab_gate`), so that once
# a near hit is found the far clusters are pruned, as the reference's ordered
# BVH traversal prunes them (scene_object.h:224-231).
#
# Of two triangles at the same distance the FIRST VISITED wins, within a
# cluster the first in Morton order (the dense sweep gives the lowest
# original index): winners are compared where t is unique. The gate is per
# ray; the JAX package's kernels gate a block of 256 or 512 rays at once, so
# a ray whose own slab test fails may still be tested there. For a triangle
# set the boxes are exact, so only a hit at a box's float edge can be lost;
# and a cluster of triangles that all lie in one axis-aligned plane has a box
# of zero thickness, which the gate `tfar > max(tnear, tmin)` lets no ray
# into, here as in the JAX package (its dense sweep finds those hits).
#
# Three entry points, the JAX package's: `flash_tri_hit_culled` (B9, with
# `sort_rays`), `flash_tri_hit_resident` (B10) and `flash_tri_hit_streamed`
# (B11). Each takes a seed distance a ray and returns it, with index 0, where
# no triangle is nearer (a caller then prefers the seed's own primitive on a
# tie of t). The JAX package picks B10 or B11 by whether the tables fit its
# core's memory (`resident_ok`); on this card the three compute the same
# function and launch the same cluster loop of csrc/flash.cu, shared with the
# sphere sweeps; their names and launch counts keep the JAX route visible.

# triangles of one Morton cluster (doubled while there would be more than 512
# clusters, as in the JAX package, so that both packages cut the same
# clusters; the cap is the TPU's scalar-memory budget for its per-block
# cluster lists, kept for the comparison and not measured on this card)
TRI_CULL_BLOCK = 64
# sorted rays that share one visiting order: a block of the kernel
VISIT_GROUP = 128
# the JAX package's budget for coefficient tables resident in its core's
# memory (flash.py:692): the route between B10 and B11
RESIDENT_MAX_COEFF_BYTES = 10 * 1024 * 1024
# the key of a ray with a NaN component (a dead lane): after every real key
DEAD_RAY_KEY = 1 << 32


def tri_cull_build(m: V3, u: V3, v: V3, active, coeffs, block: int | None = None):
    """Morton-order the triangles into clusters of `block` with bounding boxes.

    coeffs: the four (T, 16) tables of `tri_coefficients`, in scene order.
    Inactive triangles sort last, keep their zero rows and contribute
    inverted boxes. Returns (cds: the four tables in cluster order, zero rows
    up to a multiple of `block`; bounds (8, NC) = lo xyz, hi xyz, two zero
    rows; orig_of (NC * block,) int32, the scene index of each table row, 0
    for padding; cl_ord (8, NC) int32, for each direction octant the clusters
    by their centre's signed projection, front to back). The JAX package's
    `cstack_t`, a transposed copy for its DMA, has no use here."""
    t_count = m.x.shape[0]
    if block is None:
        block = TRI_CULL_BLOCK
        while t_count > 512 * block:
            block *= 2
    act = active.to(torch.bool)
    centroid = [m[a] + (u[a] + v[a]) / 3.0 for a in range(3)]
    perm = torch.argsort(_morton_key(centroid, act), stable=True)
    orig_of = _pad_rows(perm.to(torch.int32), block, 0)
    cds = tuple(_pad_rows(c[perm], block, 0.0).contiguous() for c in coeffs)
    nc = cds[0].shape[0] // block
    los, his = [], []
    for a in range(3):
        p0 = m[a]
        p1, p2 = p0 + u[a], p0 + v[a]
        lo_c = torch.where(act, torch.minimum(p0, torch.minimum(p1, p2)), INF)
        hi_c = torch.where(act, torch.maximum(p0, torch.maximum(p1, p2)), -INF)
        los.append(torch.amin(_pad_rows(lo_c[perm], block, INF).reshape(nc, block), dim=1))
        his.append(torch.amax(_pad_rows(hi_c[perm], block, -INF).reshape(nc, block), dim=1))
    zero = torch.zeros_like(los[0])
    bounds = torch.stack(los + his + [zero, zero])
    centre = [(los[a] + his[a]) * 0.5 for a in range(3)]
    orders = []
    for o in range(8):
        sx, sy, sz = (-1.0 if o & bit else 1.0 for bit in (4, 2, 1))
        keyf = sx * centre[0] + sy * centre[1] + sz * centre[2]
        orders.append(torch.argsort(torch.where(torch.isfinite(keyf), keyf, INF), stable=True))
    cl_ord = torch.stack(orders).to(torch.int32)
    return cds, bounds.contiguous(), orig_of, cl_ord.contiguous()


def scene_tri_cull(scene: T.SceneData):
    """`tri_cull_build` of a scene's triangle set."""
    cols = lambda t: V3(t[:, 0], t[:, 1], t[:, 2])
    m, u, v = cols(scene.tri_m), cols(scene.tri_u), cols(scene.tri_v)
    return tri_cull_build(m, u, v, scene.tri_active,
                          tri_coefficients(m, u, v, scene.tri_active))


def _octant(rd: V3):
    """Direction octant, 3 bits: x < 0, y < 0, z < 0 (False for a NaN)."""
    return (((rd.x < 0).to(torch.int64) << 2) | ((rd.y < 0).to(torch.int64) << 1)
            | (rd.z < 0).to(torch.int64))


def _ray_sort_key(ro: V3, rd: V3, bounds, dir_key: bool = False, origin_bits: int = 5):
    """(N,) int64 coherence key, the JAX package's: direction octant, then
    the origin's Morton cell (`origin_bits` an axis over the clusters' box);
    with `dir_key`, 6 bits of direction within the octant between the two. A
    ray with a NaN component (a dead lane) gets DEAD_RAY_KEY and sorts last:
    its cells are never computed from the NaN (a NaN cast to an integer
    differs between devices)."""
    lo = torch.amin(bounds[0:3], dim=1)
    hi = torch.amax(bounds[3:6], dim=1)
    dead = torch.zeros_like(ro.x, dtype=torch.bool)
    for c in (*ro, *rd):
        dead = dead | torch.isnan(c)

    def cell(t, scale):
        return (torch.where(dead, 0.0, t) * scale).to(torch.int64)

    def q(c, a):
        t = torch.clamp((c - lo[a]) / torch.clamp_min(hi[a] - lo[a], 1e-30), 0.0, 0.999999)
        return cell(t, float(1 << origin_bits))

    morton = (_spread3(q(ro.x, 0)) << 2) | (_spread3(q(ro.y, 1)) << 1) | _spread3(q(ro.z, 2))
    oct_ = _octant(rd)
    if dir_key:
        qd = lambda c: cell(torch.clamp(torch.abs(c), 0.0, 0.999999), 4.0)
        dirm = ((_spread3(qd(rd.x)) << 2) | (_spread3(qd(rd.y)) << 1) | _spread3(qd(rd.z))) & 0x3F
        key = (oct_ << 21) | (dirm << 15) | (morton & 0x7FFF)
    else:
        key = (oct_ << (3 * origin_bits)) | (morton & ((1 << (3 * origin_bits)) - 1))
    return torch.where(dead, DEAD_RAY_KEY, key)


def _visit_plan(ro: V3, rd: V3, bounds, sort_rays: bool):
    """(ray_of (N,) int32: the rays in visiting order; grp_oct
    (ceil(N / VISIT_GROUP),) int32: the octant of the first ray of each group
    of VISIT_GROUP of them, whose cluster order the group follows)."""
    n = ro.x.shape[0]
    if sort_rays:
        ray_of = torch.argsort(_ray_sort_key(ro, rd, bounds), stable=True)
    else:
        ray_of = torch.arange(n, device=ro.x.device)
    first = ray_of[::VISIT_GROUP]
    grp_oct = _octant(V3(*(c[first] for c in rd)))
    return ray_of.to(torch.int32), grp_oct.to(torch.int32)


# rays of one slice of the plain clustered triangle sweep: it holds a
# (rays, block, 16) gather of the coefficient rows of each ray's cluster
PLAIN_TRI_CHUNK = 4096


def _clustered_tri_hit_plain(cull, ro: V3, rd: V3, inside, tmin, t_seed, sort_rays,
                             count=None):
    """The kernel's cluster loop, vectorised over the rays: each ray's own
    sequence of clusters (its group's visiting order, kept where the box is
    crossed beyond tmin) is walked in step k = 0, 1, ...; at step k a ray
    sweeps its k-th cluster if it still enters it before its best, with the
    sums, tests and ties of the kernel."""
    cds, bounds, orig_of, cl_ord = cull[:4]
    nc = bounds.shape[1]
    block = cds[0].shape[0] // nc
    n = inside.shape[0]
    dev = inside.device
    ray_of, grp_oct = _visit_plan(ro, rd, bounds, sort_rays)
    oct_of = torch.empty((n,), dtype=torch.int64, device=dev)
    oct_of[ray_of.long()] = grp_oct.long().repeat_interleave(VISIT_GROUP)[:n]
    t_out = (torch.full((n,), INF, dtype=torch.float32, device=dev) if t_seed is None
             else t_seed.clone())
    i_out = torch.zeros((n,), dtype=torch.int32, device=dev)
    dead = torch.zeros((n,), dtype=torch.bool, device=dev)
    for c in (*ro, *rd):
        dead = dead | torch.isnan(c)  # a NaN ray gates nothing in
    cols = torch.arange(block, device=dev)
    live = torch.nonzero(~dead)[:, 0]
    for s in range(0, live.numel(), PLAIN_TRI_CHUNK):
        lanes = live[s:s + PLAIN_TRI_CHUNK]
        ro_c, rd_c = V3(*(c[lanes] for c in ro)), V3(*(c[lanes] for c in rd))
        f = ray_features(ro_c, rd_c)
        ird = [1.0 / c for c in rd_c]
        ins = inside[lanes]
        order = cl_ord[oct_of[lanes]].long()  # (n, nc): each ray's visiting order
        tnear, tfar = _slab_distances(bounds[0:3][:, order], bounds[3:6][:, order], ro_c, ird)
        crossed = _crosses(tnear, tfar, tmin)
        n_crossed = crossed.sum(1)
        # the visiting positions of the crossed clusters, in order
        pos = torch.argsort((~crossed).to(torch.int8), dim=1, stable=True)
        best_t = t_out[lanes]
        best_row = torch.full_like(lanes, -1)
        for k in range(int(n_crossed.max()) if lanes.numel() else 0):
            p = pos[:, k:k + 1]
            want = torch.nonzero((k < n_crossed) & (tnear.gather(1, p)[:, 0] < best_t))[:, 0]
            if count is not None:
                count["clusters"] = count.get("clusters", 0) + want.numel()
            if want.numel() == 0:
                continue
            rows = order.gather(1, p)[want] * block + cols  # (w, block)
            fw = f[:, want]
            sums = []
            for table in cds:
                c = table[rows]  # (w, block, 16)
                acc = c[..., 0] * fw[0][:, None]
                for col in range(1, NUM_FEATURES):
                    acc = acc + c[..., col] * fw[col][:, None]
                sums.append(acc)
            cand = _tri_test(*sums, ins[want][:, None], tmin)
            t_c = torch.amin(cand, dim=1)
            first = torch.argmax((cand == t_c[:, None]).to(torch.uint8), dim=1)
            better = t_c < best_t[want]
            won = want[better]
            best_t[won] = t_c[better]
            best_row[won] = rows[better, first[better]]
        t_out[lanes] = best_t
        i_out[lanes] = torch.where(best_row >= 0, orig_of[best_row.clamp_min(0)], 0)
    return t_out, i_out


def flash_tri_hit_culled_plain(cull, ro: V3, rd: V3, inside, tmin, t_seed=None,
                               sort_rays=True, count=None):
    """Plain PyTorch version of `flash_tri_hit_culled`, on any device.
    `count`, a dict, gets under "clusters" the number of (ray, cluster) pairs
    that passed the gate: the work the sweep did on these rays."""
    return _clustered_tri_hit_plain(cull, ro, rd, inside, tmin, t_seed, sort_rays, count)


def flash_tri_hit_resident_plain(cull, ro: V3, rd: V3, inside, tmin, t_seed=None, count=None):
    """Plain PyTorch version of `flash_tri_hit_resident`, on any device;
    `count` as in `flash_tri_hit_culled_plain`."""
    return _clustered_tri_hit_plain(cull, ro, rd, inside, tmin, t_seed, True, count)


def flash_tri_hit_streamed_plain(cull, ro: V3, rd: V3, inside, tmin, t_seed=None, count=None):
    """Plain PyTorch version of `flash_tri_hit_streamed`, on any device;
    `count` as in `flash_tri_hit_culled_plain`."""
    return _clustered_tri_hit_plain(cull, ro, rd, inside, tmin, t_seed, True, count)


def _launch_tri_clustered(route, cull, ro: V3, rd: V3, inside, tmin, t_seed, sort_rays):
    """Check the arguments and launch the cluster loop for `route` (9, 10 or
    11) on the current stream: (t, idx)."""
    from miniraytracer_tpu_torch.utils import kernels

    cds, bounds, orig_of, cl_ord = cull[:4]
    dev, n = inside.device, inside.shape[0]
    nc, block = _check_cull(cull, dev)
    if (cl_ord.device != dev or cl_ord.dtype != torch.int32 or cl_ord.shape != (8, nc)
            or not cl_ord.is_contiguous()):
        raise ValueError(f"cl_ord must be a contiguous int32 (8, {nc}) tensor on {dev}")
    seed = torch.full_like(ro.x, INF) if t_seed is None else t_seed
    _check_kernel_args(dev, n, NUM_FEATURES, cds, [*ro, *rd, seed], inside)
    ray_of, grp_oct = _visit_plan(ro, rd, bounds, sort_rays)
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    i_out = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = kernels.load("flash")
    fn = lib.mrt_flash_tri_clustered
    ptrs = [*cds, bounds, orig_of, cl_ord, ray_of, grp_oct, *ro, *rd, seed, inside, t_out, i_out]
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * len(ptrs)
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(route, *[t.data_ptr() for t in ptrs], n, nc, block, tmin, stream)
    if rc != 0:
        raise RuntimeError(f"mrt_flash_tri_clustered({route}) failed: "
                           f"{kernels.error_string(lib, rc)}")
    return t_out, i_out


def _check_tri_rays(ro: V3, rd: V3, inside, t_seed):
    n = inside.shape[0]
    _check_rays(n, **{f"ro.{k}": c for k, c in zip("xyz", ro)},
                **{f"rd.{k}": c for k, c in zip("xyz", rd)})
    if t_seed is not None:
        _check_rays(n, t_seed=t_seed)


def flash_tri_hit_culled(cull, ro: V3, rd: V3, inside, tmin, t_seed=None, *,
                         sort_rays: bool = True):
    """Closest triangle hit over the clusters of `cull` (`tri_cull_build`),
    every ray from `t_seed` ((N,) f32; None means INF), the rays sorted for
    coherence unless `sort_rays` is False. Returns (t, idx) as
    `flash_tri_hit`, idx in the scene's numbering, and the seed with index 0
    where no triangle is nearer: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check_tri_rays(ro, rd, inside, t_seed)
    if device.kind(inside, "nearest-hit sweep") == "cpu":
        return flash_tri_hit_culled_plain(cull, ro, rd, inside, tmin, t_seed, sort_rays)
    global culled_launches
    out = _launch_tri_clustered(9, cull, ro, rd, inside, tmin, t_seed, sort_rays)
    culled_launches += 1
    return out


def flash_tri_hit_resident(cull, ro: V3, rd: V3, inside, tmin, t_seed=None):
    """`flash_tri_hit_culled` with sorted rays: the JAX package's route while
    `resident_ok(cull)`."""
    _check_tri_rays(ro, rd, inside, t_seed)
    if device.kind(inside, "nearest-hit sweep") == "cpu":
        return flash_tri_hit_resident_plain(cull, ro, rd, inside, tmin, t_seed)
    global resident_launches
    out = _launch_tri_clustered(10, cull, ro, rd, inside, tmin, t_seed, True)
    resident_launches += 1
    return out


def flash_tri_hit_streamed(cull, ro: V3, rd: V3, inside, tmin, t_seed=None):
    """`flash_tri_hit_culled` with sorted rays: the JAX package's route for
    tables beyond `resident_ok`."""
    _check_tri_rays(ro, rd, inside, t_seed)
    if device.kind(inside, "nearest-hit sweep") == "cpu":
        return flash_tri_hit_streamed_plain(cull, ro, rd, inside, tmin, t_seed)
    global tri_streamed_launches
    out = _launch_tri_clustered(11, cull, ro, rd, inside, tmin, t_seed, True)
    tri_streamed_launches += 1
    return out


def resident_ok(cull) -> bool:
    """The JAX package's route between B10 (True) and B11: whether the four
    coefficient tables fit its budget of RESIDENT_MAX_COEFF_BYTES."""
    return 4 * cull[0][0].shape[0] * NUM_FEATURES * 4 <= RESIDENT_MAX_COEFF_BYTES


def tri_hit_culled_auto(cull, ro: V3, rd: V3, inside, tmin, t_seed=None, plain=False):
    """The seeded clustered sweep by the JAX package's route (`resident_ok`):
    `flash_tri_hit_resident` or `flash_tri_hit_streamed`, or their plain
    versions with `plain`."""
    if resident_ok(cull):
        sweep = flash_tri_hit_resident_plain if plain else flash_tri_hit_resident
    else:
        sweep = flash_tri_hit_streamed_plain if plain else flash_tri_hit_streamed
    return sweep(cull, ro, rd, inside, tmin, t_seed)


# ---------------------------------------------------------------------------
# Differentiable sweeps
# ---------------------------------------------------------------------------
# The hit distance t of the WINNING primitive is the sweeps' only continuous
# output; which primitive wins is discrete and carries no cotangent. Each
# sweep below is a torch.autograd.Function whose forward is a sweep above (its
# kernel on CUDA tensors) and whose backward is tensor operations on the
# winner's coefficient row (the JAX package's `_tri_bwd`, `_sph_bwd`,
# `_box_bwd`, which are XLA there too):
#
#   triangles: t = tn / det           dt/dtn = 1/det, dt/ddet = -t/det
#   spheres:   t = -b + s*sqrt(b^2 - c), s the root's sign:
#              dt/db = -1 + s*b/sq,   dt/dc = -s/(2*sq)
#   boxes:     t = (bound - lo_a) / ld_a on the winner face (axis a) in the
#              box's frame, lo_a and ld_a linear in (ro - offset) and rd
#
# The tables' cotangent is the winner rows' sums over lanes (`index_add_`).
# A lane without a hit contributes exactly zero, but its primal inputs may be
# NaN (dead lanes are swept as NaN rays) and its index is the placeholder 0:
# the backward masks the PRIMALS of such lanes first, else 0 x NaN products
# put NaN into row 0's cotangent (the JAX package's measured book2 fault,
# "grads_finite=False"). The clustered sweeps share the dense sweeps'
# backward: it depends only on the winner, not on how it was found, so their
# cluster tables (permuted copies of the coefficients) get no cotangent and
# the gradient flows to the coefficients in scene order.


def _tri_features_vjp(ro: V3, rd: V3, df):
    """Cotangents of ro and rd from that of `ray_features` ((N, 16))."""
    d_ro = [df[:, 1 + i] + sum(df[:, 7 + 3 * i + j] * rd[j] for j in range(3))
            for i in range(3)]
    d_rd = [df[:, 4 + j] + sum(df[:, 7 + 3 * i + j] * ro[i] for i in range(3))
            for j in range(3)]
    return V3(*d_ro), V3(*d_rd)


def _sphere_features_vjp(ro: V3, rd: V3, time, df):
    """Cotangents of ro, rd and time from that of `sphere_ray_features`."""
    d_ro = V3(*(df[:, 1 + k] + df[:, 7] * rd[k] + 2.0 * df[:, 8] * ro[k] + df[:, 11 + k] * time
                for k in range(3)))
    d_rd = V3(*(df[:, 4 + k] + df[:, 7] * ro[k] + df[:, 14 + k] * time for k in range(3)))
    d_time = (df[:, 9] + 2.0 * df[:, 10] * time
              + sum(df[:, 11 + k] * ro[k] + df[:, 14 + k] * rd[k] for k in range(3)))
    return d_ro, d_rd, d_time


def _mask_primals(t, idx, ro: V3, rd: V3, time=None):
    """(hit, ro, rd, time, idx) with the lanes that hit nothing set to finite
    placeholders (see above)."""
    hit = t < INF * 0.5
    ro = V3(*(torch.where(hit, c, 0.0) for c in ro))
    rd = V3(*(torch.where(hit, c, 1.0) for c in rd))
    time = None if time is None else torch.where(hit, time, 0.0)
    return hit, ro, rd, time, torch.where(hit, idx, 0).long()


def _rows_sum(table_rows, f):
    return (table_rows * f.t()).sum(1)


class _TriHitD(torch.autograd.Function):
    """(t, idx) of `sweep(ro, rd)` with the VJP of t w.r.t. the four
    coefficient tables and the rays."""

    @staticmethod
    def forward(ctx, sweep, c_det, c_uu, c_vv, c_tn, rox, roy, roz, rdx, rdy, rdz):
        t, idx = sweep(V3(rox, roy, roz), V3(rdx, rdy, rdz))
        ctx.save_for_backward(c_det, c_tn, rox, roy, roz, rdx, rdy, rdz, t, idx)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, gt, _g_idx):
        c_det, c_tn, rox, roy, roz, rdx, rdy, rdz, t, idx = ctx.saved_tensors
        hit, ro, rd, _, idx = _mask_primals(t, idx, V3(rox, roy, roz), V3(rdx, rdy, rdz))
        f = ray_features(ro, rd)
        rows_det, rows_tn = c_det[idx], c_tn[idx]
        det_w = _rows_sum(rows_det, f)
        safe_det = torch.where(torch.abs(det_w) > TRI_EPS, det_w, 1.0)
        g = torch.where(hit, gt / safe_det, 0.0)
        ts = torch.where(hit, t, 0.0)
        d_ro, d_rd = _tri_features_vjp(ro, rd, (rows_tn - rows_det * ts[:, None]) * g[:, None])
        w_tn = f.t() * g[:, None]
        d_det = d_tn = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[4]:
            d_tn = torch.zeros_like(c_tn).index_add_(0, idx, w_tn)
            d_det = torch.zeros_like(c_det).index_add_(0, idx, -w_tn * ts[:, None])
        return (None, d_det, None, None, d_tn, *d_ro, *d_rd)


class _SphereHitD(torch.autograd.Function):
    """(t, idx) of `sweep(ro, rd, time)` with the VJP of t w.r.t. the two
    coefficient tables and the rays."""

    @staticmethod
    def forward(ctx, sweep, cb, cc, rox, roy, roz, rdx, rdy, rdz, time):
        t, idx = sweep(V3(rox, roy, roz), V3(rdx, rdy, rdz), time)
        ctx.save_for_backward(cb, cc, rox, roy, roz, rdx, rdy, rdz, time, t, idx)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, gt, _g_idx):
        cb, cc, rox, roy, roz, rdx, rdy, rdz, time, t, idx = ctx.saved_tensors
        hit, ro, rd, time, idx = _mask_primals(t, idx, V3(rox, roy, roz),
                                               V3(rdx, rdy, rdz), time)
        f = sphere_ray_features(ro, rd, time)
        rows_b, rows_c = cb[idx], cc[idx]
        b_w, c_w = _rows_sum(rows_b, f), _rows_sum(rows_c, f)
        disc = b_w * b_w - c_w
        sq_ok = disc > 1e-12
        sq = torch.sqrt(torch.where(sq_ok, disc, 1.0))
        s = torch.where(t + b_w > 0, 1.0, -1.0)  # t_front = -b - sq <= -b <= t_back
        g = torch.where(hit, gt, 0.0)
        g_b = g * torch.where(sq_ok, -1.0 + s * b_w / sq, 0.0)
        g_c = g * torch.where(sq_ok, -s / (2.0 * sq), 0.0)
        d_ro, d_rd, d_time = _sphere_features_vjp(
            ro, rd, time, rows_b * g_b[:, None] + rows_c * g_c[:, None])
        d_cb = d_cc = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            d_cb = torch.zeros_like(cb).index_add_(0, idx, f.t() * g_b[:, None])
            d_cc = torch.zeros_like(cc).index_add_(0, idx, f.t() * g_c[:, None])
        return (None, d_cb, d_cc, *d_ro, *d_rd, d_time)


def _detached(coeffs):
    return tuple(c.detach() for c in coeffs)


def tri_hit_d(route, tables, coeffs, ro: V3, rd: V3, inside, tmin, t_seed=None, plain=False):
    """Differentiable closest triangle hit over the sweep of `route`: "tri"
    (the dense sweep B7 over `tables` = the coefficient tables) or
    "tri_cull" (the clustered sweep of `tri_hit_culled_auto` over `tables` =
    `tri_cull_build`'s, seeded with `t_seed`). `coeffs` are the four tables
    of `tri_coefficients` in scene order, which get the gradient; None runs
    the sweep alone, without one. Where the seed is not beaten, t is INF and
    idx 0. The kernels for CUDA tensors, their plain versions for CPU
    tensors or with `plain`."""
    seed = None if t_seed is None else t_seed.detach()

    def sweep(ro_, rd_):
        if route == "tri":
            return (flash_tri_hit_plain if plain else flash_tri_hit)(
                _detached(tables), ro_, rd_, inside, tmin)
        t, idx = tri_hit_culled_auto(tables, ro_, rd_, inside, tmin, seed, plain=plain)
        if seed is None:
            return t, idx
        won = t < seed
        return torch.where(won, t, INF), torch.where(won, idx, 0)

    if coeffs is None:
        return sweep(ro, rd)
    return _TriHitD.apply(sweep, *coeffs, *ro, *rd)


def sphere_hit_d(route, tables, coeffs, ro: V3, rd: V3, time, inside, tmin, plain=False):
    """Differentiable closest sphere hit over the sweep of `route` (a key of
    `hybrid.hybrid_accel`: "sph" dense B8, "sph_gate" B13, "sph_cull" B12)
    over `tables` (the coefficient tables, or `sph_cull_build`'s); `coeffs`
    are `sphere_coefficients` in scene order, which get the gradient (None:
    the sweep alone, without one)."""
    from miniraytracer_tpu_torch.ops import intersect as ix

    fn = globals()[ix._SPHERE_SWEEPS[route] + ("_plain" if plain else "")]
    tables = _detached(tables) if route == "sph" else tables
    sweep = lambda ro_, rd_, time_: fn(tables, ro_, rd_, time_, inside, tmin)
    if coeffs is None:
        return sweep(ro, rd, time)
    return _SphereHitD.apply(sweep, *coeffs, *ro, *rd, time)


def flash_tri_hit_d(coeffs, ro: V3, rd: V3, inside, tmin):
    """Differentiable `flash_tri_hit` (gradients w.r.t. coeffs and rays)."""
    return tri_hit_d("tri", coeffs, coeffs, ro, rd, inside, tmin)


def flash_sphere_hit_d(coeffs, ro: V3, rd: V3, time, inside, tmin):
    """Differentiable `flash_sphere_hit`."""
    return sphere_hit_d("sph", coeffs, coeffs, ro, rd, time, inside, tmin)


def flash_tri_hit_culled_d(cull, coeffs, ro: V3, rd: V3, inside, tmin):
    """Differentiable closest triangle hit through the clustered sweep of
    `tri_hit_culled_auto` (B10, B11 past `resident_ok`): the same results as
    `flash_tri_hit_d`. The JAX package always takes the streamed kernel here,
    for a memory limit of its core that this card does not have."""
    return tri_hit_d("tri_cull", cull, coeffs, ro, rd, inside, tmin)


def flash_sphere_hit_culled_d(cull, coeffs, ro: V3, rd: V3, time, inside, tmin):
    """Differentiable closest sphere hit through the clustered sweeps: the
    gated one below 4096 (padded) spheres, else the streamed one."""
    route = "sph_gate" if cull[0][0].shape[0] < 4096 else "sph_cull"
    return sphere_hit_d(route, cull, coeffs, ro, rd, time, inside, tmin)


def _box_sweep(blo, bhi, bcs, boff, bact, ro: V3, rd: V3, tmin):
    """(t, idx) of the nearest box over all boxes (`intersect.box_ts`)."""
    import types

    from miniraytracer_tpu_torch.ops import intersect as ix

    n, dev = ro.x.shape[0], ro.x.device
    shim = types.SimpleNamespace(box_lo=blo, box_hi=bhi, box_cs=bcs, box_off=boff,
                                 box_active=bact)
    rays = ix.Rays(ro=ro, rd=rd, time=torch.zeros_like(ro.x),
                   inside=torch.zeros((n,), dtype=torch.int32, device=dev))
    tmax0 = torch.full((n,), INF, dtype=torch.float32, device=dev)
    return ix._chunked_min(lambda s, c: ix.box_ts(shim, rays, s, c, tmin, tmax0),
                           blo.shape[0], n, dev)


class _BoxHitD(torch.autograd.Function):
    """(t, idx) of the box sweep with the VJP of t w.r.t. the box tables and
    the rays: only the winner face of each lane is re-derived."""

    @staticmethod
    def forward(ctx, tmin, blo, bhi, bcs, boff, bact, rox, roy, roz, rdx, rdy, rdz):
        ro, rd = V3(rox, roy, roz), V3(rdx, rdy, rdz)
        t, idx = _box_sweep(blo, bhi, bcs, boff, bact, ro, rd, tmin)
        ctx.save_for_backward(blo, bhi, bcs, boff, rox, roy, roz, rdx, rdy, rdz, t, idx)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, gt, _g_idx):
        from miniraytracer_tpu_torch.ops import intersect as ix

        blo, bhi, bcs, boff, rox, roy, roz, rdx, rdy, rdz, t, idx = ctx.saved_tensors
        hit, ro, rd, _, idx = _mask_primals(t, idx, V3(rox, roy, roz), V3(rdx, rdy, rdz))
        ts = torch.where(hit, t, 0.0)
        lo_b, hi_b, sn, cs, of = blo[idx], bhi[idx], bcs[idx, 0], bcs[idx, 1], boff[idx]
        ox, oy, oz = ro.x - of[:, 0], ro.y - of[:, 1], ro.z - of[:, 2]
        lo = (cs * ox - sn * oz, oy, cs * oz + sn * ox)
        ld = (cs * rd.x - sn * rd.z, rd.y, cs * rd.z + sn * rd.x)
        # the winner face: the candidate nearest t (intersect.box_record)
        cands = ix._box_face_ts(lo, ld, tuple(lo_b.t()), tuple(hi_b.t()))
        face = torch.argmin(torch.abs(cands - ts[None, :]), dim=0)
        axis = torch.div(face, 2, rounding_mode="floor")
        ld_a = torch.gather(torch.stack(ld), 0, axis[None, :])[0]
        inv = 1.0 / torch.where(torch.abs(ld_a) > 1e-12, ld_a,
                                torch.where(ld_a >= 0, 1e-12, -1e-12))
        g = torch.where(hit, gt, 0.0)
        d_bound = g * inv
        d_lo = [torch.where(axis == a, -d_bound, 0.0) for a in range(3)]
        d_ld = [torch.where(axis == a, -g * ts * inv, 0.0) for a in range(3)]
        # lo0 = cs*ox - sn*oz, lo1 = oy, lo2 = cs*oz + sn*ox; ld likewise with rd
        d_ro = V3(d_lo[0] * cs + d_lo[2] * sn, d_lo[1], -d_lo[0] * sn + d_lo[2] * cs)
        d_rd = V3(d_ld[0] * cs + d_ld[2] * sn, d_ld[1], -d_ld[0] * sn + d_ld[2] * cs)
        grads = [None] * 4
        if any(ctx.needs_input_grad[1:5]):
            d_sn = -d_lo[0] * oz + d_lo[2] * ox - d_ld[0] * rd.z + d_ld[2] * rd.x
            d_cs = d_lo[0] * ox + d_lo[2] * oz + d_ld[0] * rd.x + d_ld[2] * rd.z
            is_min = (face % 2 == 0).to(torch.float32)
            d_b = torch.stack([torch.where(axis == a, d_bound, 0.0) for a in range(3)], 1)
            rows = torch.cat([d_b * is_min[:, None], d_b * (1.0 - is_min[:, None]),
                              torch.stack([d_sn, d_cs], 1),
                              -torch.stack(list(d_ro), 1)], 1)  # off enters as ro - off
            acc = torch.zeros((blo.shape[0], 11), dtype=rows.dtype,
                              device=rows.device).index_add_(0, idx, rows)
            grads = [acc[:, 0:3], acc[:, 3:6], acc[:, 6:8], acc[:, 8:11]]
        return (None, *grads, None, *d_ro, *d_rd)


def box_hit_d(blo, bhi, bcs, boff, bact, ro: V3, rd: V3, tmin):
    """Differentiable closest box hit (the box sweep of `intersect.box_ts`
    in tensor operations, as in the JAX package): gradients w.r.t. the box
    tables (lo, hi, (sin, cos), offset) and the rays."""
    return _BoxHitD.apply(tmin, blo, bhi, bcs, boff, bact, *ro, *rd)
