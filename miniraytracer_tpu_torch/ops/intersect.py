"""Ray-primitive intersection in tensor operations
(`miniraytracer_tpu/ops/intersect.py`): for each primitive type the candidate
t of every (primitive, ray) pair and the nearest per ray (`sphere_ts`,
`rect_ts`, `tri_ts`, `box_ts`, `_chunked_min`), the volumes' free-path
scatter (`volume_ts`), the hit record of the winner (`sphere_record`,
`rect_record`, `tri_record`, `box_record`), and `scene_hit`, the nearest hit
over all types with its record.

`make_accel` picks, by the JAX package's primitive-count thresholds, which
kernels take over a big sphere or triangle set (the sweeps of `ops/flash.py`)
and the Perlin turbulence (`ops/noise.py`). The JAX package builds that dict
only on its accelerator; the port builds it on every device, and each
wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors (or for `plain=True`).

The JAX package gathers a winner's table row with a one-hot matrix product
(`ops/lookup.py`), because a per-ray gather is slow on the TPU. Here it is
plain tensor indexing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from miniraytracer_tpu_torch.models.camera import Rays  # noqa: F401
from miniraytracer_tpu_torch.ops.vecmath import (V3, sphere_uv, vcross, vdot,
                                                 vnormalize, vsdot, vsqrt, vwhere)
from miniraytracer_tpu_torch.scene import types as T

INF = 3.0e38
NEG = -3.0e38
TMIN = 0.001  # main.cpp:71
TRI_EPS = 1e-5  # triangle.cpp:220
CHUNK = 512  # primitives of one slice of a chunked sweep

# Which nearest-hit kernel a primitive count selects, as in the JAX package,
# so that both packages route the same scenes the same way.
FLASH_MIN_TRIS = 64  # from here a triangle set goes to a kernel
FLASH_MIN_SPHERES = 64  # from here a sphere set goes to a kernel
FLASH_CULL_MIN_TRIS = 1024  # from here the clustered triangle sweeps
FLASH_GATE_MIN_SPHERES = 512  # below this the dense sphere sweep
FLASH_CULL_MIN_SPHERES = 4096  # below this the gated sweep, from here the streamed


class Hit(NamedTuple):
    t: torch.Tensor  # (N,) INF on a miss
    ptype: torch.Tensor  # (N,) i32 PRIM_*
    pidx: torch.Tensor  # (N,) i32
    hit: torch.Tensor  # (N,) bool


class HitRecord(NamedTuple):
    t: torch.Tensor
    p: V3
    n: V3
    u: torch.Tensor  # (N,)
    v: torch.Tensor  # (N,)
    mat: torch.Tensor  # (N,) i32
    hit: torch.Tensor  # (N,) bool


def gather(table, idx):
    """Rows `idx` of `table`: `index_select`, whose gradient sums the lanes
    into the table with `index_add_`. (The gradient of `table[idx]` is an
    accumulating `index_put_` that adds the lanes of one row one after the
    other: many lanes that hit one primitive, the ground sphere, made it
    take seconds a train step.)"""
    return torch.index_select(table, 0, idx)


def _rows(table, idx) -> V3:
    r = gather(table, idx)
    return V3(r[:, 0], r[:, 1], r[:, 2])


def _sphere_centers(scene: T.SceneData, s, time):
    """(C, N) centre components of the spheres of slice `s` at ray times
    `time`: the lerped moving centre (sphere.h:24-31)."""
    c0, c1 = scene.sph_c0[s], scene.sph_c1[s]
    t0, t1, mov = scene.sph_t0[s], scene.sph_t1[s], scene.sph_moving[s]
    denom = torch.where(mov > 0, t1 - t0, 1.0)
    f = torch.where(mov[:, None] > 0, (time[None, :] - t0[:, None]) / denom[:, None], 0.0)
    return V3(*(c0[:, k][:, None] + f * (c1[:, k] - c0[:, k])[:, None] for k in range(3)))


def _sphere_center_static(scene: T.SceneData, si: int, time) -> V3:
    """Centre of sphere row `si` (a Python index) at ray times `time` (N,)."""
    c0 = V3(scene.sph_c0[si, 0], scene.sph_c0[si, 1], scene.sph_c0[si, 2])
    c1 = V3(scene.sph_c1[si, 0], scene.sph_c1[si, 1], scene.sph_c1[si, 2])
    t0, t1, mov = scene.sph_t0[si], scene.sph_t1[si], scene.sph_moving[si]
    denom = torch.where(mov > 0, t1 - t0, 1.0)
    f = torch.where(mov > 0, (time - t0) / denom, 0.0)
    return c0 + (c1 - c0) * f


def sphere_ts(scene: T.SceneData, rays: Rays, start, count, tmin, tmax):
    """(count, N) hit distance of spheres [start, start + count): the front
    root within (tmin, tmax), else the back root, and that only for a ray
    inside a medium (sphere.cpp:13-46); INF for none."""
    s = slice(start, start + count)
    cen = _sphere_centers(scene, s, rays.time)
    ocx = rays.ro.x[None, :] - cen.x
    ocy = rays.ro.y[None, :] - cen.y
    ocz = rays.ro.z[None, :] - cen.z
    b = ocx * rays.rd.x[None, :] + ocy * rays.rd.y[None, :] + ocz * rays.rd.z[None, :]
    r = scene.sph_radius[s]
    c = ocx * ocx + ocy * ocy + ocz * ocz - (r * r)[:, None]
    disc = b * b - c
    sq = vsqrt(torch.where(disc > 0, disc, 1.0))
    t_front = -b - sq
    t_back = -b + sq
    ok = (disc > 0) & scene.sph_active[s][:, None]
    front_ok = ok & (t_front < tmax[None, :]) & (t_front > tmin)
    back_ok = ok & (rays.inside[None, :] > 0) & (t_back < tmax[None, :]) & (t_back > tmin)
    return torch.where(front_ok, t_front, torch.where(back_ok, t_back, INF))


def sphere_record(scene: T.SceneData, rays: Rays, t, idx):
    """Hit record (p, n, u, v, mat) of sphere `idx` at parameter `t`
    (sphere.cpp:22-45). `idx` is an (N,) integer tensor."""
    idx = idx.long()
    c0 = _rows(scene.sph_c0, idx)
    c1 = _rows(scene.sph_c1, idx)
    t0, t1 = scene.sph_t0[idx], scene.sph_t1[idx]
    mov, rad = scene.sph_moving[idx], gather(scene.sph_radius, idx)
    denom = torch.where(mov > 0, t1 - t0, 1.0)
    f = torch.where(mov > 0, (rays.time - t0) / denom, 0.0)
    cen = c0 + (c1 - c0) * f
    p = rays.ro + rays.rd * t
    safe_rad = torch.where(torch.abs(rad) > 1e-20, rad, 1.0)
    # *(1/rad), not /rad: the expression of the fused sweep (ops/bounce.py);
    # a negative radius flips the normal (hollow shell)
    n = vnormalize((p - cen) * (1.0 / safe_rad))
    u, v = sphere_uv(n)
    return p, n, u, v, scene.sph_mat[idx]


def rect_ts(scene: T.SceneData, rays: Rays, start, count, tmin, tmax):
    """(count, N) hit distance of rects [start, start + count): one-sided
    (rect.cpp:26 rejects dot(dir, n) > 0), within [tmin, tmax] and the
    bounds; INF for none. The three axis variants are one formula over the
    unit vectors ei, ej, ek."""
    s = slice(start, start + count)
    ek, ei, ej = (scene.rect_ek[s], scene.rect_ei[s], scene.rect_ej[s])

    def proj(e, v: V3):  # (C, N): per-primitive axis component of a per-ray vector
        return (e[:, 0][:, None] * v.x[None, :] + e[:, 1][:, None] * v.y[None, :]
                + e[:, 2][:, None] * v.z[None, :])

    dk = proj(ek, rays.rd)
    facing = dk * scene.rect_sign[s][:, None] <= 0.0
    dk_safe = torch.where(torch.abs(dk) > 1e-30, dk, 1e-30)
    t = (scene.rect_k[s][:, None] - proj(ek, rays.ro)) / dk_safe
    ii = proj(ei, rays.ro) + t * proj(ei, rays.rd)
    jj = proj(ej, rays.ro) + t * proj(ej, rays.rd)
    inb = ((ii >= scene.rect_i0[s][:, None]) & (ii <= scene.rect_i1[s][:, None])
           & (jj >= scene.rect_j0[s][:, None]) & (jj <= scene.rect_j1[s][:, None]))
    valid = (facing & (t >= tmin) & (t <= tmax[None, :]) & inb
             & scene.rect_active[s][:, None])
    return torch.where(valid, t, INF)


def rect_record(scene: T.SceneData, rays: Rays, t, idx):
    """Hit record (p, n, u, v, mat) of rect `idx` at parameter `t`
    (rect.cpp:26-47): uv over the rect's bounds, the normal sign * ek."""
    idx = idx.long()
    p = rays.ro + rays.rd * t
    ei, ej, ek = (_rows(tab, idx) for tab in (scene.rect_ei, scene.rect_ej, scene.rect_ek))
    i0, i1 = scene.rect_i0[idx], scene.rect_i1[idx]
    j0, j1 = scene.rect_j0[idx], scene.rect_j1[idx]
    u = (vdot(p, ei) - i0) / (i1 - i0)
    v = (vdot(p, ej) - j0) / (j1 - j0)
    return p, ek * scene.rect_sign[idx], u, v, scene.rect_mat[idx]


def tri_ts(scene: T.SceneData, rays: Rays, start, count, tmin, tmax):
    """(count, N) hit distance of triangles [start, start + count):
    Moller-Trumbore with the reference's combined rejection, backfaces only
    for a ray inside a medium (triangle.cpp:221-264); INF for none."""
    s = slice(start, start + count)
    m, u, v = (V3(*(tab[s, k][:, None] for k in range(3)))
               for tab in (scene.tri_m, scene.tri_u, scene.tri_v))
    rdx, rdy, rdz = rays.rd.x[None, :], rays.rd.y[None, :], rays.rd.z[None, :]
    px = rdy * v.z - rdz * v.y
    py = rdz * v.x - rdx * v.z
    pz = rdx * v.y - rdy * v.x
    det = u.x * px + u.y * py + u.z * pz
    sign = torch.where((rays.inside[None, :] > 0) & (det < 0.0), -1.0, 1.0)
    det = det * sign
    tx = rays.ro.x[None, :] - m.x
    ty = rays.ro.y[None, :] - m.y
    tz = rays.ro.z[None, :] - m.z
    uu = (tx * px + ty * py + tz * pz) * sign
    qx = ty * u.z - tz * u.y
    qy = tz * u.x - tx * u.z
    qz = tx * u.y - ty * u.x
    vv = (rdx * qx + rdy * qy + rdz * qz) * sign
    safe_det = torch.where(det > TRI_EPS, det, 1.0)
    t = (v.x * qx + v.y * qy + v.z * qz) / safe_det * sign
    valid = ((det >= TRI_EPS) & (uu >= 0) & (uu <= det) & (vv >= 0) & (uu + vv <= det)
             & (t >= tmin) & (t <= tmax[None, :]) & scene.tri_active[s][:, None])
    return torch.where(valid, t, INF)


def tri_record(scene: T.SceneData, rays: Rays, t, idx):
    """Hit record of triangle `idx` at parameter `t` (triangle.cpp:221-264):
    barycentrics by Moller-Trumbore, the smooth normal interpolated."""
    idx = idx.long()
    m, u, v = (_rows(tab, idx) for tab in (scene.tri_m, scene.tri_u, scene.tri_v))
    pvec = vcross(rays.rd, v)
    det = vdot(u, pvec)
    sign = torch.where((rays.inside > 0) & (det < 0.0), -1.0, 1.0)
    det = det * sign
    tvec = rays.ro - m
    uu = vdot(tvec, pvec) * sign
    qvec = vcross(tvec, u)
    vv = vdot(rays.rd, qvec) * sign
    inv = 1.0 / torch.where(torch.abs(det) > TRI_EPS, det, 1.0)
    uu = uu * inv
    vv = vv * inv
    p = rays.ro + rays.rd * t
    mn, un, vn = (_rows(tab, idx) for tab in (scene.tri_mn, scene.tri_un, scene.tri_vn))
    n = vnormalize(mn * (1.0 - uu - vv) + un * uu + vn * vv)
    return p, n, uu, vv, scene.tri_mat[idx]


def _chunked_min(t_fn, n_prims: int, n_rays: int, device):
    """(min t, index of it) over primitives, `CHUNK` of them at a time:
    `t_fn(start, count)` gives the (count, N) candidate t (INF = miss). The
    first of equal minima wins, within a slice and across slices."""
    best_t = torch.full((n_rays,), INF, dtype=torch.float32, device=device)
    best_i = torch.zeros((n_rays,), dtype=torch.int32, device=device)
    for start in range(0, n_prims, CHUNK):
        tc = t_fn(start, min(CHUNK, n_prims - start))
        i = torch.argmin(tc, dim=0).to(torch.int32)
        tmin_c = torch.amin(tc, dim=0)
        better = tmin_c < best_t
        best_t = torch.where(better, tmin_c, best_t)
        best_i = torch.where(better, i + start, best_i)
    return best_t, best_i


# ---------------------------------------------------------------------------
# Boxes (box.h: 6 outward one-sided rects as ONE primitive; the rotate_y and
# translate wrappers baked in as sin/cos/offset, scene_object.cpp:9-98)
# ---------------------------------------------------------------------------


def _box_local_rays(scene: T.SceneData, rays: Rays, s):
    """World -> local rays for the boxes of slice `s`, as (count, N) grids:
    un-translate, then the inverse rotation about y."""
    sin_t = scene.box_cs[s, 0][:, None]
    cos_t = scene.box_cs[s, 1][:, None]
    ox = rays.ro.x[None, :] - scene.box_off[s, 0][:, None]
    oy = rays.ro.y[None, :] - scene.box_off[s, 1][:, None]
    oz = rays.ro.z[None, :] - scene.box_off[s, 2][:, None]
    lox = cos_t * ox - sin_t * oz
    loz = cos_t * oz + sin_t * ox
    ldx = cos_t * rays.rd.x[None, :] - sin_t * rays.rd.z[None, :]
    ldz = cos_t * rays.rd.z[None, :] + sin_t * rays.rd.x[None, :]
    ldy = rays.rd.y[None, :].expand_as(ldx)
    return (lox, oy, loz), (ldx, ldy, ldz)


def _box_face_ts(lo, ld, bmin, bmax):
    """Candidate t of the 6 one-sided faces, stacked on a new first axis. A
    face counts only from its front (rect.cpp:26 rejects dot(dir, n) > 0); a
    face that is missed or seen from behind gives INF."""
    cands = []
    for a, b, c in ((0, 1, 2), (1, 0, 2), (2, 0, 1)):
        ld_a = ld[a]
        inv = 1.0 / torch.where(torch.abs(ld_a) > 1e-12, ld_a,
                                torch.where(ld_a >= 0, 1e-12, -1e-12))
        for bound, facing in ((bmin[a], ld_a > 0), (bmax[a], ld_a < 0)):
            t = (bound - lo[a]) * inv
            bb = lo[b] + t * ld[b]
            cc = lo[c] + t * ld[c]
            okf = (facing & (bb >= bmin[b]) & (bb <= bmax[b])
                   & (cc >= bmin[c]) & (cc <= bmax[c]))
            cands.append(torch.where(okf, t, INF))
    return torch.stack(cands)


def box_ts(scene: T.SceneData, rays: Rays, start, count, tmin, tmax):
    """(count, N) hit distance of boxes [start, start + count) for each ray:
    the nearest front face within [tmin, tmax], INF for a miss or an inactive
    box. A ray that starts inside a box sees nothing of it."""
    s = slice(start, start + count)
    lo, ld = _box_local_rays(scene, rays, s)
    bmin = tuple(scene.box_lo[s, k][:, None] for k in range(3))
    bmax = tuple(scene.box_hi[s, k][:, None] for k in range(3))
    t = torch.amin(_box_face_ts(lo, ld, bmin, bmax), dim=0)
    valid = (t >= tmin) & (t <= tmax[None, :]) & scene.box_active[s][:, None]
    return torch.where(valid, t, INF)


def box_record(scene: T.SceneData, rays: Rays, t, idx):
    """Hit record (p, n, u, v, mat) of box `idx` at parameter `t`. The face
    is the one of the six whose candidate lies nearest `t` (the first on a
    tie); u and v run over the face's two free axes in the box's own frame
    (box materials carry no image texture, so the mirrored bounds of box.h's
    rect constructors are not reproduced)."""
    idx = idx.long()
    blo, bhi = scene.box_lo[idx], scene.box_hi[idx]
    sn, cs = scene.box_cs[idx, 0], scene.box_cs[idx, 1]
    off = _rows(scene.box_off, idx)
    ox, oy, oz = rays.ro.x - off.x, rays.ro.y - off.y, rays.ro.z - off.z
    lo = (cs * ox - sn * oz, oy, cs * oz + sn * ox)
    ld = (cs * rays.rd.x - sn * rays.rd.z, rays.rd.y,
          cs * rays.rd.z + sn * rays.rd.x)
    bmin = tuple(blo[:, k] for k in range(3))
    bmax = tuple(bhi[:, k] for k in range(3))
    cands = _box_face_ts(lo, ld, bmin, bmax)  # (6, N)
    face = torch.argmin(torch.abs(cands - t[None, :]), dim=0)
    axis = torch.div(face, 2, rounding_mode="floor")
    sgn = torch.where(face % 2 == 0, -1.0, 1.0)  # the min-bound face looks down its axis
    nl = tuple(torch.where(axis == k, sgn, 0.0) for k in range(3))
    # local -> world (the rotation of builder.box)
    n = V3(cs * nl[0] + sn * nl[2], nl[1], cs * nl[2] - sn * nl[0])
    p = rays.ro + rays.rd * t
    pl = tuple(lo[k] + t * ld[k] for k in range(3))
    fu = tuple((pl[k] - bmin[k]) / torch.clamp_min(bmax[k] - bmin[k], 1e-20)
               for k in range(3))
    u = torch.where(axis == 0, fu[1], fu[0])
    v = torch.where(axis == 2, fu[1], fu[2])
    return p, n, u, v, scene.box_mat[idx]


# ---------------------------------------------------------------------------
# Volumes (constant-density media, volumes.cpp:5-36)
# ---------------------------------------------------------------------------


def _volume_entry_exit(scene: T.SceneData, rays: Rays, vi: int):
    """The reference's double probe of volume `vi`'s boundary
    (volumes.cpp:11-12): rec1, the first boundary hit; rec2, the first beyond
    rec1 + 1e-4. Returns (rec1, rec2, both found), NEG where not found.

    The boundary is made of ONE-SIDED primitives, and the quirks that follow
    are kept (the JAX package keeps them): a box boundary (six outward
    one-sided faces) gives a ray from outside its near face and no far face,
    so the reference's smoke boxes never scatter a ray that enters from
    outside, and a ray starting inside sees nothing ahead; a sphere
    boundary's far root is a backface, seen only by a ray inside a medium, so
    sphere volumes scatter only rays inside a dielectric."""
    bp = scene.vol_bparams[vi]
    btype = scene.vol_btype[vi]

    # sphere boundary: the front root, and the back root for a ray inside
    oc = rays.ro - V3(bp[0], bp[1], bp[2])
    rad = bp[3]
    b = vdot(oc, rays.rd)
    c = vsdot(oc) - rad * rad
    disc = b * b - c
    sq = vsqrt(torch.where(disc > 0, disc, 1.0))
    s_ok = disc > 0
    sph_t1 = torch.where(s_ok, -b - sq, INF)
    sph_t2 = torch.where(s_ok & (rays.inside > 0), -b + sq, INF)

    # box boundary: the 6 one-sided faces in the box's own frame
    bmin, bmax = (bp[0], bp[1], bp[2]), (bp[3], bp[4], bp[5])
    sin_t, cos_t = bp[6], bp[7]
    ro = rays.ro - V3(bp[8], bp[9], bp[10])
    lo = (cos_t * ro.x - sin_t * ro.z, ro.y, cos_t * ro.z + sin_t * ro.x)
    ld = (cos_t * rays.rd.x - sin_t * rays.rd.z, rays.rd.y,
          cos_t * rays.rd.z + sin_t * rays.rd.x)
    box_cands = _box_face_ts(lo, ld, bmin, bmax)  # (6, N)

    inf = torch.full_like(sph_t1, INF)
    cands = torch.where(btype == T.VOLB_SPHERE,
                        torch.stack([sph_t1, sph_t2, inf, inf, inf, inf]), box_cands)
    rec1 = torch.amin(cands, dim=0)
    got1 = rec1 < INF
    rec2 = torch.amin(torch.where(cands > rec1[None, :] + 1e-4, cands, INF), dim=0)
    got2 = rec2 < INF
    return torch.where(got1, rec1, NEG), torch.where(got2, rec2, NEG), got1 & got2


def volume_ts(scene: T.SceneData, rays: Rays, tmin, tmax, u_volume):
    """Nearest volume scatter (t, index) for uniforms `u_volume` (N, V)
    (volumes.cpp:5-36), within [entry, min(exit, tmax)]. The volumes come
    last in the reference's object list, in order, so a later volume is
    clamped by an earlier one's scatter too (the running closest hit)."""
    n = rays.time.shape[0]
    best_t = torch.full((n,), INF, dtype=torch.float32, device=rays.time.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=rays.time.device)
    for vi in range(scene.n_volumes):
        enter, exit_, ok = _volume_entry_exit(scene, rays, vi)
        rec1 = torch.clamp_min(enter, tmin)
        rec2 = torch.minimum(exit_, torch.minimum(tmax, best_t))
        valid = ok & (rec1 < rec2) & scene.vol_active[vi]
        uv = torch.clamp(u_volume[:, vi], 1e-38, 1.0)  # log(0) guard
        hit_dist = -(1.0 / scene.vol_density[vi]) * torch.log(uv)
        t = rec1 + hit_dist
        better = valid & (hit_dist < rec2 - rec1) & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, vi, best_i)
    return best_t, best_i


# ---------------------------------------------------------------------------
# Nearest hit over the whole scene
# ---------------------------------------------------------------------------


def make_accel(scene: T.SceneData, differentiable: bool = False) -> dict:
    """The kernels' operands for one trace, built once outside the bounce
    loop, by the JAX package's thresholds (`intersect.make_accel` as it runs
    on its accelerator): "tri", the dense triangle tables (B7), for 64..1023
    triangles; "tri_cull", the Morton clusters of `flash.tri_cull_build` for
    1024 or more (the seeded clustered sweep, B10, or B11 past
    `flash.resident_ok`); "sph", the dense sphere tables (B8), for 64..511
    spheres; "sph_gate" / "sph_cull", the Morton clusters of
    `flash.sph_cull_build` for the gated (B13, 512..4095 spheres) or the
    streamed sweep (B12, more); "perlin", the turbulence tables of
    `noise.noise_tables` (B6), for a scene with Perlin noise that is not
    `fast_perlin`. Empty for a scene that needs none. `differentiable=True`
    raises: `scene_hit` does not route through the sweeps' VJP forms
    (`flash.tri_hit_d`, `sphere_hit_d`, `box_hit_d`) yet, and nothing is swept
    in their place."""
    from miniraytracer_tpu_torch.ops import flash, noise

    if differentiable:
        raise NotImplementedError(
            "make_accel(differentiable=True): the eager scene_hit does not route "
            "through the custom-VJP sweeps yet (ROADMAP.md A11)")
    accel = {}
    if scene.n_tris >= FLASH_CULL_MIN_TRIS:
        accel["tri_cull"] = flash.scene_tri_cull(scene)
    elif scene.n_tris >= FLASH_MIN_TRIS:
        accel["tri"] = flash.scene_tri_coefficients(scene)
    if scene.n_spheres >= FLASH_MIN_SPHERES:
        coeffs = flash.sphere_coefficients(scene)
        if scene.n_spheres < FLASH_GATE_MIN_SPHERES:
            accel["sph"] = coeffs
        elif scene.n_spheres < FLASH_CULL_MIN_SPHERES:
            accel["sph_gate"] = flash.sph_cull_build(scene, coeffs)
        else:
            accel["sph_cull"] = flash.sph_cull_build(scene, coeffs)
    if scene.has_perlin and not scene.fast_perlin:
        accel["perlin"] = noise.noise_tables(scene)
    return accel


# make_accel's (and hybrid_accel's) sphere entry -> the sweep of ops/flash.py over it
_SPHERE_SWEEPS = {"sph": "flash_sphere_hit", "sph_gate": "flash_sphere_hit_gated",
                  "sph_cull": "flash_sphere_hit_streamed"}


def scene_hit(scene: T.SceneData, rays: Rays, u_volume=None, tmin=TMIN, accel=None,
              plain=False) -> HitRecord:
    """Nearest hit over all primitive types, with its record.

    `u_volume` (N, V) are the uniforms of the volumes' free paths (None: no
    volume scatters). `accel` is `make_accel`'s dict: its sphere and
    triangle sets are swept by the kernels (their plain versions for CPU
    tensors or with `plain`), the rest by tensor operations. On a tie the
    sphere wins over the rect, the rect over the triangle, the triangle over
    the box: so the clustered triangle sweep may start from the sphere and
    rect winner and return that seed where no triangle is nearer. A miss
    lane's record is sanitised: normal (1, 0, 0), u = v = 0."""
    from miniraytracer_tpu_torch.ops import flash

    n = rays.time.shape[0]
    dev = rays.time.device
    tmax0 = torch.full((n,), INF, dtype=torch.float32, device=dev)
    accel = accel or {}
    sweep = lambda name: getattr(flash, name + "_plain" if plain else name)
    sph_key = next((k for k in _SPHERE_SWEEPS if k in accel), None)
    if sph_key:
        t_s, i_s = sweep(_SPHERE_SWEEPS[sph_key])(
            accel[sph_key], rays.ro, rays.rd, rays.time, rays.inside, tmin)
    else:
        t_s, i_s = _chunked_min(lambda s, c: sphere_ts(scene, rays, s, c, tmin, tmax0),
                                scene.n_spheres, n, dev)
    t_r, i_r = _chunked_min(lambda s, c: rect_ts(scene, rays, s, c, tmin, tmax0),
                            scene.n_rects, n, dev)
    if "tri" in accel:
        t_t, i_t = sweep("flash_tri_hit")(accel["tri"], rays.ro, rays.rd, rays.inside, tmin)
    elif "tri_cull" in accel:
        # clusters behind the sphere or rect winner are pruned
        t_t, i_t = flash.tri_hit_culled_auto(accel["tri_cull"], rays.ro, rays.rd, rays.inside,
                                             tmin, torch.minimum(t_s, t_r), plain=plain)
    else:
        t_t, i_t = _chunked_min(lambda s, c: tri_ts(scene, rays, s, c, tmin, tmax0),
                                scene.n_tris, n, dev)
    if scene.has_boxes:
        t_b, i_b = _chunked_min(lambda s, c: box_ts(scene, rays, s, c, tmin, tmax0),
                                scene.n_boxes, n, dev)
    else:
        t_b, i_b = tmax0, torch.zeros_like(i_s)

    t_surf = torch.minimum(torch.minimum(torch.minimum(t_s, t_r), t_t), t_b)
    is_s0, is_r0, is_t0 = t_s == t_surf, t_r == t_surf, t_t == t_surf
    ptype = torch.where(is_s0, T.PRIM_SPHERE, torch.where(
        is_r0, T.PRIM_RECT, torch.where(is_t0, T.PRIM_TRI, T.PRIM_BOX))).to(torch.int32)
    pidx = torch.where(is_s0, i_s, torch.where(is_r0, i_r, torch.where(is_t0, i_t, i_b)))

    # volumes scatter inside [entry, min(exit, nearest surface)]
    t_final = t_surf
    if u_volume is not None and scene.n_volumes > 0:
        t_v, i_v = volume_ts(scene, rays, tmin, t_surf, u_volume)
        vol_wins = t_v < t_surf
        t_final = torch.where(vol_wins, t_v, t_surf)
        ptype = torch.where(vol_wins, T.PRIM_VOLUME, ptype).to(torch.int32)
        pidx = torch.where(vol_wins, i_v, pidx)

    hit = t_final < INF
    safe_t = torch.where(hit, t_final, 1.0)
    safe_idx = torch.where(hit, pidx, 0)

    # the record of each type's winner, selected by type
    is_s, is_r = ptype == T.PRIM_SPHERE, ptype == T.PRIM_RECT
    is_t, is_b = ptype == T.PRIM_TRI, ptype == T.PRIM_BOX
    zero = torch.zeros_like(safe_t)
    n_vol = V3(zero + 1.0, zero, zero)  # a volume's normal is arbitrary (volumes.cpp:29)
    nrm, uu, vv = n_vol, zero, zero
    mat = scene.vol_mat[torch.where(ptype == T.PRIM_VOLUME, safe_idx, 0).long()]
    records = [(is_s, sphere_record), (is_r, rect_record), (is_t, tri_record)]
    if scene.has_boxes:
        records.append((is_b, box_record))
    for mine, record in reversed(records):
        _, n_w, u_w, v_w, m_w = record(scene, rays, safe_t, torch.where(mine, safe_idx, 0))
        nrm = vwhere(mine, n_w, nrm)
        uu = torch.where(mine, u_w, uu)
        vv = torch.where(mine, v_w, vv)
        mat = torch.where(mine, m_w, mat)
    return HitRecord(t=t_final, p=rays.ro + rays.rd * safe_t, n=vwhere(hit, nrm, n_vol),
                     u=torch.where(hit, uu, 0.0), v=torch.where(hit, vv, 0.0),
                     mat=mat.to(torch.int32), hit=hit)
