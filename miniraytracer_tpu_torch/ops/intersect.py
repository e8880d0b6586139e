"""Hit records of the winning primitive (`miniraytracer_tpu/ops/intersect.py`):
what the hybrid renderer needs between its nearest-hit kernels and its step
kernel. The sphere and triangle sweeps themselves are the kernels of
`ops/flash.py`; this module rebuilds, for each ray, the record (point, normal,
uv, material) of the sphere, triangle or box that won, and holds the sweep
over a large box set (`box_ts`), which is tensor operations in the JAX
package too.

The JAX package gathers the winner's table row with a one-hot matrix product
(`ops/lookup.py`), because a per-ray gather is slow on the TPU. Here it is
plain tensor indexing.
"""

from __future__ import annotations

import torch

from miniraytracer_tpu_torch.models.camera import Rays  # noqa: F401
from miniraytracer_tpu_torch.ops.vecmath import (V3, sphere_uv, vcross, vdot,
                                                 vnormalize)
from miniraytracer_tpu_torch.scene import types as T

INF = 3.0e38
TMIN = 0.001  # main.cpp:71
TRI_EPS = 1e-5  # triangle.cpp:220
CHUNK = 512  # primitives of one slice of a chunked sweep

# Which nearest-hit kernel a primitive count selects, as in the JAX package,
# so that both packages route the same scenes the same way.
FLASH_CULL_MIN_TRIS = 1024  # from here the clustered triangle sweeps
FLASH_GATE_MIN_SPHERES = 512  # below this the dense sphere sweep
FLASH_CULL_MIN_SPHERES = 4096  # below this the gated sweep, from here the streamed


def _rows(table, idx) -> V3:
    r = table[idx]
    return V3(r[:, 0], r[:, 1], r[:, 2])


def sphere_record(scene: T.SceneData, rays: Rays, t, idx):
    """Hit record (p, n, u, v, mat) of sphere `idx` at parameter `t`
    (sphere.cpp:22-45). `idx` is an (N,) integer tensor."""
    idx = idx.long()
    c0 = _rows(scene.sph_c0, idx)
    c1 = _rows(scene.sph_c1, idx)
    t0, t1 = scene.sph_t0[idx], scene.sph_t1[idx]
    mov, rad = scene.sph_moving[idx], scene.sph_radius[idx]
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
