"""Fused wavefront bounce: the whole trace() body as one kernel.

Port of `miniraytracer_tpu/ops/bounce.py`. The reference's trace() body
(main.cpp:66-118) plus the draw2 merge and lane regeneration
(main.cpp:214-231) runs as one per-lane loop: bounce, merge, regenerate,
until the lane has rendered all its samples. Two implementations sit side
by side:

- the kernel, `csrc/bounce.cu` (hand-written CUDA for sm_90a), launched by
  `render_wavefront_fused_pixels` when the scene's tensors are on a CUDA
  device;
- the plain PyTorch version (`bounce_physics`, `wave_step`,
  `render_wavefront_fused_pixels_plain`), which runs on (N,) tensors and
  loops `wave_step` until no lane is alive. It is what the wrapper runs for
  a scene on the CPU, and what the tests and `chip_smoke.py` hold the
  kernel against.

`bounce_physics` and `wave_step` also take the hybrid renderer's candidate
from outside (`ext`) and its image textures (`ops/hybrid.py`); `advance`,
`finish_step` and `initial_lanes` also serve the renderers whose bounce is
tensor operations (`models/integrator.py`).

Both follow the JAX estimator exactly: the same counter-keyed RNG slots,
the same where-guards and eps margins, the same merge/NaN/clamp policy.
Floats may differ by library transcendentals and reassociation only.

Scene tables are packed into flat f32 vectors (`pack_scene`, the JAX
layout). The Perlin tables stay six 256-entry rows (px py pz gx gy gz): the
JAX package's lane-replicated (96, 128) layout exists only for the TPU's
lane gather.
"""

from __future__ import annotations

import ctypes
import math
import time as _time
from typing import NamedTuple, Optional

import torch

from miniraytracer_tpu_torch.models import camera as cam_mod
from miniraytracer_tpu_torch.ops import noise, rng
from miniraytracer_tpu_torch.ops.vecmath import (V3, sphere_uv, vcross, vdiv, vdot, vluminance,
                                                 vnormalize, vonb_from_w, vonb_l2w,
                                                 vreflect, vrefract, vsdot, vsqrt, vwhere)
from miniraytracer_tpu_torch.scene import types as T

INF = 3.0e38
NEG = -3.0e38
TMIN = 0.001
TRI_EPS = 1e-5
PI = 3.14159265358979323846

# RNG slots (materials.py) / camera fold tag (camera.py)
SLOT_VOL, SLOT_MIX, SLOT_LPICK, SLOT_LA, SLOT_LB = 0, 8, 9, 10, 11
SLOT_MA, SLOT_MB, SLOT_FUZZ, SLOT_FRESNEL = 12, 13, 14, 17
CAM_FOLD = cam_mod.CAM_FOLD

# Fused-class caps, the same as the JAX package's so that both packages route
# the same scenes the same way.
MAX_PRIMS = 64
MAX_MATS = 24
MAX_TEXS = 24
MAX_VOLS = 4
MAX_LIGHTS = 4

# Number of kernel launches made by `render_wavefront_fused_pixels`. Counts
# only launches of the CUDA kernel (never the plain version), so a caller can
# show that a render went through the kernel.
launches = 0


def can_fuse(scene: T.SceneData) -> bool:
    """Fused-bounce eligibility (the Cornell/smoke/spheres class)."""
    return (
        scene.n_spheres <= MAX_PRIMS
        and scene.n_rects <= MAX_PRIMS
        and scene.n_tris <= MAX_PRIMS
        and scene.n_volumes <= MAX_VOLS
        and scene.mat_type.shape[0] <= MAX_MATS
        and scene.tex_type.shape[0] <= MAX_TEXS
        and not scene.has_image
        and not scene.fast_perlin
        and len(scene.lights) <= MAX_LIGHTS
    )


def pack_scene(scene: T.SceneData):
    """Scene tables -> (meta dict, [sph, rect, tri, box, vol, mat, tex, cam,
    ptab]). Each table but ptab is a flat f32 vector in the JAX layout
    (sph 12*S, rect 17*R, tri 20*T, box 13*B, vol 16*V, mat 3*M, tex 9*X,
    cam 21); integer codes ride as f32. ptab is (6, 256) f32. All tables
    are on the scene's device."""
    meta = dict(
        S=scene.n_spheres, R=scene.n_rects, Tc=scene.n_tris,
        Bx=scene.n_boxes if scene.has_boxes else 0,
        V=scene.n_volumes,
        M=int(scene.mat_type.shape[0]),
        X=int(scene.tex_type.shape[0]),
        lights=tuple(scene.lights), use_sky=bool(scene.use_sky),
        exact_cosine=bool(scene.exact_cosine),
        perlin=bool(scene.has_perlin),
        image=bool(scene.has_image),
        img_hw=(tuple(int(d) for d in scene.images.shape[1:3])
                if scene.has_image else (0, 0)),
    )
    dev = scene.device
    f32 = lambda a: a.to(torch.float32).reshape(-1)
    pad = torch.zeros((1,), dtype=torch.float32, device=dev)

    def cat(n, parts):
        return torch.cat([f32(a) for a in parts]) if n else pad

    sph = cat(meta["S"], [
        scene.sph_c0, scene.sph_c1, scene.sph_t0, scene.sph_t1,
        scene.sph_moving, scene.sph_radius, scene.sph_mat, scene.sph_active])
    rect = cat(meta["R"], [
        scene.rect_ei, scene.rect_ej, scene.rect_ek, scene.rect_k,
        scene.rect_i0, scene.rect_i1, scene.rect_j0, scene.rect_j1,
        scene.rect_sign, scene.rect_mat, scene.rect_active])
    tri = cat(meta["Tc"], [
        scene.tri_m, scene.tri_u, scene.tri_v, scene.tri_mn, scene.tri_un,
        scene.tri_vn, scene.tri_mat, scene.tri_active])
    box = cat(meta["Bx"], [
        scene.box_lo, scene.box_hi, scene.box_cs, scene.box_off,
        scene.box_mat, scene.box_active])
    vol = cat(meta["V"], [
        scene.vol_bparams, scene.vol_btype, scene.vol_density, scene.vol_mat,
        scene.vol_active])
    mat = cat(1, [scene.mat_type, scene.mat_param, scene.mat_tex])
    tex = cat(1, [scene.tex_type, scene.tex_c0, scene.tex_c1,
                  scene.tex_scale, scene.tex_img])
    if meta["perlin"]:
        ptab = noise.noise_tables(scene)
    else:
        ptab = torch.zeros((6, 256), dtype=torch.float32, device=dev)
    return meta, [sph, rect, tri, box, vol, mat, tex, camera_table(scene.camera), ptab]


def camera_table(cam) -> torch.Tensor:
    """The camera as the packed (21,) f32 table of `camera_ray`."""
    return torch.cat([a.to(torch.float32).reshape(-1) for a in (
        cam.origin, cam.llcorner, cam.horz, cam.vert, cam.u, cam.v,
        cam.lens_radius, cam.time0, cam.time1)])


# ---------------------------------------------------------------------------
# Plain PyTorch version: everything operates on (N,) lane tensors. Scalar
# table entries are 0-d tensors indexed at Python offsets and broadcast.
# ---------------------------------------------------------------------------


def _sample_in_ball(r1, r2, r3) -> V3:
    """Uniform point in the unit ball; cbrt as exp(log(r)/3), as the fused
    JAX kernel computes it (not rng.sample_in_ball's cbrt)."""
    d = rng.sample_on_sphere(r1, r2)
    r3s = torch.clamp_min(r3, 1e-30)
    return d * torch.exp(torch.log(r3s) * (1.0 / 3.0))


def fresnel_schlick(cosine, ref_index):
    """Schlick's reflectance (material.h:106-110)."""
    r0 = (1.0 - ref_index) / (1.0 + ref_index)
    r0 = r0 * r0
    c = 1.0 - cosine
    c2 = c * c
    # (1-c)**5 as XLA's integer_pow expands it: c * (c^2)^2
    return r0 + (1.0 - r0) * (c * (c2 * c2))


def atlas_texels(images) -> torch.Tensor:
    """The image atlas ((I, IH, IW) u32, texels 0x00RRGGBB) as a flat int32
    vector of the same bits (they are below 2^24), which torch can index on
    every device."""
    return images.view(torch.int32).reshape(-1)


def texel_rgb(texel) -> V3:
    """0x00RRGGBB texels (any integer dtype) -> colour components in [0, 1]."""
    texel = texel.to(torch.int64)
    inv255 = 1.0 / 255.0
    return V3(((texel >> 16) & 0xFF).to(torch.float32) * inv255,
              ((texel >> 8) & 0xFF).to(torch.float32) * inv255,
              (texel & 0xFF).to(torch.float32) * inv255)


class BounceOut(NamedTuple):
    """Physics outputs for one bounce, all (N,) lane tensors."""

    hit: torch.Tensor
    safe_t: torch.Tensor
    p: V3
    nrm: V3
    emitted: V3
    is_light: torch.Tensor
    is_specular: torch.Tensor
    weight: V3
    new_rd: V3
    new_inside: torch.Tensor
    # only with meta["image"]: the winner's flat index into the image atlas
    # (f32, -1 = no image albedo pending); such lanes are shaded with albedo 1
    # and the caller multiplies the texel into the throughput
    img_id: Optional[torch.Tensor] = None


def _sphere_center(sph, S, si, time):
    c0 = V3(sph[3 * si], sph[3 * si + 1], sph[3 * si + 2])
    o1 = 3 * S
    c1 = V3(sph[o1 + 3 * si], sph[o1 + 3 * si + 1], sph[o1 + 3 * si + 2])
    o = 6 * S
    t0s, t1s, mov = sph[o + si], sph[o + S + si], sph[o + 2 * S + si]
    denom = torch.where(mov > 0, t1s - t0s, 1.0)
    fmv = torch.where(mov > 0, (time - t0s) / denom, 0.0)
    return c0, c1, fmv


def _rect_row(rect, R, ri):
    ei = V3(rect[3 * ri], rect[3 * ri + 1], rect[3 * ri + 2])
    o = 3 * R
    ej = V3(rect[o + 3 * ri], rect[o + 3 * ri + 1], rect[o + 3 * ri + 2])
    o = 6 * R
    ek = V3(rect[o + 3 * ri], rect[o + 3 * ri + 1], rect[o + 3 * ri + 2])
    o = 9 * R
    return (ei, ej, ek, rect[o + ri], rect[o + R + ri], rect[o + 2 * R + ri],
            rect[o + 3 * R + ri], rect[o + 4 * R + ri], rect[o + 5 * R + ri])


def _slab_inv(da):
    return 1.0 / torch.where(torch.abs(da) > 1e-12, da,
                             torch.where(da >= 0, 1e-12, -1e-12))


_BOX_AXES = ((0, 1, 2), (1, 0, 2), (2, 0, 1))


def bounce_physics(meta, tabs, ptab, ro: V3, rd: V3, time, inside, keys_b,
                   ext=None):
    """One bounce of the reference trace() body (main.cpp:66-118): scene_hit
    as a running-winner record over all primitive types, then shade
    (material dispatch, 50/50 MIS light sampling, Perlin).

    `tabs` = (sph, rect, tri, box, vol, mat, tex) flat tables from
    `pack_scene`, `ptab` its (6, 256) Perlin tables. `inside` is int32,
    `keys_b` the per-bounce key (u32 values in int64).

    `ext` (hybrid renderer): a surface candidate found outside, by the dense
    nearest-hit kernels: rows (t, nx, ny, nz, mat_f) with t == INF where
    there is none. It seeds the running winner, and a primitive of the
    tables replaces it only strictly (<). With meta["ext_mat"] six more rows
    (mtype, mparam, albedo r g b, texel index) carry the candidate's
    material, evaluated outside from the scene's full tables."""
    S, R, Tc, V, Bx = meta["S"], meta["R"], meta["Tc"], meta["V"], meta["Bx"]
    M, X = meta["M"], meta["X"]
    lights = meta["lights"]
    nL = max(len(lights), 1)
    sph, rect, tri, box, vol, mat, tex = tabs

    zero = torch.zeros_like(time)
    ext_mat_rows = None
    if ext is None:
        best_t = torch.full_like(time, INF)
        w_n = V3(zero + 1.0, zero, zero)
        w_mat = torch.zeros_like(inside)
    else:
        if meta.get("ext_mat"):
            (ext_t, ext_nx, ext_ny, ext_nz, ext_mat,
             em_type, em_param, em_ar, em_ag, em_ab, em_img) = ext
            ext_mat_rows = (em_type, em_param, V3(em_ar, em_ag, em_ab), em_img)
        else:
            ext_t, ext_nx, ext_ny, ext_nz, ext_mat = ext
        best_t = ext_t
        w_n = V3(ext_nx, ext_ny, ext_nz)
        w_mat = ext_mat.to(torch.int32)

    # --- spheres (sphere.cpp:13-46) --- tie rule: sphere first, so '<'
    for si in range(S):
        c0, c1, fmv = _sphere_center(sph, S, si, time)
        o = 6 * S
        rad = sph[o + 3 * S + si]
        matid, act = sph[o + 4 * S + si], sph[o + 5 * S + si]
        cen = V3(c0.x + fmv * (c1.x - c0.x), c0.y + fmv * (c1.y - c0.y),
                 c0.z + fmv * (c1.z - c0.z))
        oc = ro - cen
        b = vdot(oc, rd)
        c = vdot(oc, oc) - rad * rad
        disc = b * b - c
        sqd = vsqrt(torch.where(disc > 0, disc, 1.0))
        t_front = -b - sqd
        t_back = -b + sqd
        ok = (disc > 0) & (act > 0)
        front_ok = ok & (t_front > TMIN) & (t_front < best_t)
        back_ok = ok & (inside > 0) & (t_back > TMIN) & (t_back < best_t)
        tc = torch.where(front_ok, t_front, torch.where(back_ok, t_back, INF))
        better = front_ok | back_ok
        p_hit = ro + rd * torch.where(better, tc, 1.0)
        safe_rad = torch.where(torch.abs(rad) > 1e-20, rad, 1.0)
        n_c = vnormalize((p_hit - cen) * (1.0 / safe_rad))
        best_t = torch.where(better, tc, best_t)
        w_n = vwhere(better, n_c, w_n)
        w_mat = torch.where(better, matid.to(torch.int32), w_mat)

    # --- rects (rect.cpp, one-sided) ---
    for ri in range(R):
        ei, ej, ek, kk, i0, i1, j0, j1, sgn = _rect_row(rect, R, ri)
        matid, act = rect[15 * R + ri], rect[16 * R + ri]
        dk = vdot(ek, rd)
        facing = dk * sgn <= 0.0
        dk_safe = torch.where(torch.abs(dk) > 1e-30, dk, 1e-30)
        t = (kk - vdot(ek, ro)) / dk_safe
        iiv = vdot(ei, ro) + t * vdot(ei, rd)
        jjv = vdot(ej, ro) + t * vdot(ej, rd)
        valid = (
            facing & (t >= TMIN) & (t < best_t) & (act > 0)
            & (iiv >= i0) & (iiv <= i1) & (jjv >= j0) & (jjv <= j1)
        )
        best_t = torch.where(valid, t, best_t)
        w_n = vwhere(valid, V3(zero + ek.x * sgn, zero + ek.y * sgn,
                               zero + ek.z * sgn), w_n)
        w_mat = torch.where(valid, matid.to(torch.int32), w_mat)

    # --- triangles (triangle.cpp:221-264) ---
    for ti in range(Tc):
        rows = [V3(tri[o * Tc + 3 * ti], tri[o * Tc + 3 * ti + 1],
                   tri[o * Tc + 3 * ti + 2]) for o in (0, 3, 6, 9, 12, 15)]
        mT, uT, vT, mn, un, vn = rows
        matid, act = tri[18 * Tc + ti], tri[19 * Tc + ti]
        pv = vcross(rd, vT)
        det = vdot(uT, pv)
        sgn = torch.where((inside > 0) & (det < 0.0), -1.0, 1.0)
        dets = det * sgn
        tv = ro - mT
        uu = vdot(tv, pv) * sgn
        qv = vcross(tv, uT)
        vv = vdot(rd, qv) * sgn
        safe_det = torch.where(dets > TRI_EPS, dets, 1.0)
        t = vdot(vT, qv) / safe_det * sgn
        valid = (
            (dets >= TRI_EPS) & (uu >= 0) & (uu <= dets)
            & (vv >= 0) & (uu + vv <= dets)
            & (t >= TMIN) & (t < best_t) & (act > 0)
        )
        inv = 1.0 / safe_det
        uun = uu * inv
        vvn = vv * inv
        n_c = vnormalize(mn * (1.0 - uun - vvn) + un * uun + vn * vvn)
        best_t = torch.where(valid, t, best_t)
        w_n = vwhere(valid, n_c, w_n)
        w_mat = torch.where(valid, matid.to(torch.int32), w_mat)

    # --- boxes (box.h: 6 outward one-sided rects as ONE prim; rotate_y +
    # translate baked as sin/cos/offset; rays inside see nothing) ---
    for bi in range(Bx):
        blo = (box[3 * bi], box[3 * bi + 1], box[3 * bi + 2])
        o = 3 * Bx
        bhi = (box[o + 3 * bi], box[o + 3 * bi + 1], box[o + 3 * bi + 2])
        o = 6 * Bx
        sinb, cosb = box[o + 2 * bi], box[o + 2 * bi + 1]
        o = 8 * Bx
        offb = V3(box[o + 3 * bi], box[o + 3 * bi + 1], box[o + 3 * bi + 2])
        matid, act = box[11 * Bx + bi], box[12 * Bx + bi]
        rol = ro - offb
        bl = (cosb * rol.x - sinb * rol.z, rol.y, cosb * rol.z + sinb * rol.x)
        bd = (cosb * rd.x - sinb * rd.z, rd.y, cosb * rd.z + sinb * rd.x)
        tb = torch.full_like(time, INF)
        nax = torch.zeros_like(time)  # winner axis id
        nsg = torch.zeros_like(time)  # winner face sign
        for a, b_, c_ in _BOX_AXES:
            da = bd[a]
            invd = _slab_inv(da)
            for bound, face_ok, sg in ((blo[a], da > 0, -1.0),
                                       (bhi[a], da < 0, 1.0)):
                tf = (bound - bl[a]) * invd
                pb = bl[b_] + tf * bd[b_]
                pc = bl[c_] + tf * bd[c_]
                okf = (face_ok & (tf >= TMIN) & (tf < tb)
                       & (pb >= blo[b_]) & (pb <= bhi[b_])
                       & (pc >= blo[c_]) & (pc <= bhi[c_]))
                tb = torch.where(okf, tf, tb)
                nax = torch.where(okf, float(a), nax)
                nsg = torch.where(okf, sg, nsg)
        valid = (tb < best_t) & (act > 0)
        nlx = torch.where(nax == 0.0, nsg, 0.0)
        nly = torch.where(nax == 1.0, nsg, 0.0)
        nlz = torch.where(nax == 2.0, nsg, 0.0)
        n_c = V3(cosb * nlx + sinb * nlz, nly, cosb * nlz - sinb * nlx)
        best_t = torch.where(valid, tb, best_t)
        w_n = vwhere(valid, n_c, w_n)
        w_mat = torch.where(valid, matid.to(torch.int32), w_mat)

    # --- volumes (volumes.cpp:5-36, one-sided quirks preserved) ---
    for vi in range(V):
        bp = [vol[12 * vi + k] for k in range(12)]
        btype, dens = vol[12 * V + vi], vol[13 * V + vi]
        vmat, vact = vol[14 * V + vi], vol[15 * V + vi]
        # sphere boundary
        oc = ro - V3(bp[0], bp[1], bp[2])
        b = vdot(oc, rd)
        c = vdot(oc, oc) - bp[3] * bp[3]
        disc = b * b - c
        sqd = vsqrt(torch.where(disc > 0, disc, 1.0))
        s_ok = disc > 0
        sph_t1 = torch.where(s_ok, -b - sqd, INF)
        sph_t2 = torch.where(s_ok & (inside > 0), -b + sqd, INF)
        # box boundary: 6 one-sided faces in the local frame
        bmin, bmax = bp[0:3], bp[3:6]
        sin_t, cos_t = bp[6], bp[7]
        rol = ro - V3(bp[8], bp[9], bp[10])
        bl = (cos_t * rol.x - sin_t * rol.z, rol.y,
              cos_t * rol.z + sin_t * rol.x)
        bd = (cos_t * rd.x - sin_t * rd.z, rd.y, cos_t * rd.z + sin_t * rd.x)
        box_cands = []
        for a, b_, c_ in _BOX_AXES:
            da = bd[a]
            invd = _slab_inv(da)
            for bound, face_ok in ((bmin[a], da > 0), (bmax[a], da < 0)):
                tf = (bound - bl[a]) * invd
                pb = bl[b_] + tf * bd[b_]
                pc = bl[c_] + tf * bd[c_]
                okf = (face_ok & (pb >= bmin[b_]) & (pb <= bmax[b_])
                       & (pc >= bmin[c_]) & (pc <= bmax[c_]))
                box_cands.append(torch.where(okf, tf, INF))
        is_sph_b = btype == float(T.VOLB_SPHERE)
        all_cands = [
            torch.where(is_sph_b, sph_t1, box_cands[0]),
            torch.where(is_sph_b, sph_t2, box_cands[1]),
        ] + [torch.where(is_sph_b, INF, bc) for bc in box_cands[2:]]
        rec1 = all_cands[0]
        for ccd in all_cands[1:]:
            rec1 = torch.minimum(rec1, ccd)
        got1 = rec1 < INF
        rec2 = torch.full_like(rec1, INF)
        for ccd in all_cands:
            rec2 = torch.minimum(rec2, torch.where(ccd > rec1 + 1e-4, ccd, INF))
        got2 = rec2 < INF
        rec1c = torch.clamp_min(torch.where(got1, rec1, NEG), TMIN)
        rec2c = torch.minimum(torch.where(got2, rec2, NEG), best_t)
        valid = got1 & got2 & (rec1c < rec2c) & (vact > 0)
        inside_dist = rec2c - rec1c
        uv = torch.clamp(rng.uniform(keys_b, SLOT_VOL + vi), 1e-38, 1.0)
        hit_dist = -(1.0 / dens) * torch.log(uv)
        tvol = rec1c + hit_dist
        better = valid & (hit_dist < inside_dist) & (tvol < best_t)
        best_t = torch.where(better, tvol, best_t)
        w_n = vwhere(better, V3(zero + 1.0, zero, zero), w_n)
        w_mat = torch.where(better, vmat.to(torch.int32), w_mat)

    hit = best_t < INF
    safe_t = torch.where(hit, best_t, 1.0)
    p = ro + rd * safe_t
    # miss-lane record sanitation (scene_hit does the same)
    nrm = vwhere(hit, w_n, V3(zero + 1.0, zero, zero))
    if ext_mat_rows is not None:
        # the candidate seeded best_t and the tables' primitives replace it
        # only strictly, so bit equality names a winner from outside
        is_ext = hit & (best_t == ext_t)

    # ---------------- shade (materials.shade, exact slots) -------------
    mtype, mparam, tex_id = zero, zero, zero
    for mi in range(M):
        selm = w_mat == mi
        mtype = torch.where(selm, mat[mi], mtype)
        mparam = torch.where(selm, mat[M + mi], mparam)
        tex_id = torch.where(selm, mat[2 * M + mi], tex_id)

    c0 = V3(zero, zero, zero)
    c1 = V3(zero, zero, zero)
    ttype, tscale = zero, zero
    for xi in range(X):
        selx = tex_id == xi
        ttype = torch.where(selx, tex[xi], ttype)
        c0 = vwhere(selx, V3(zero + tex[X + 3 * xi], zero + tex[X + 3 * xi + 1],
                             zero + tex[X + 3 * xi + 2]), c0)
        c1 = vwhere(selx, V3(zero + tex[4 * X + 3 * xi],
                             zero + tex[4 * X + 3 * xi + 1],
                             zero + tex[4 * X + 3 * xi + 2]), c1)
        tscale = torch.where(selx, tex[7 * X + xi], tscale)
    sines = (torch.sin(tscale * p.x) * torch.sin(tscale * p.y)
             * torch.sin(tscale * p.z))
    albedo = vwhere((ttype == float(T.TEX_CHECKER)) & (sines < 0), c1, c0)
    if meta["perlin"]:
        turb = noise.flash_turbulence_plain(ptab, V3(p.x * tscale, p.y * tscale, p.z * tscale))
        albedo = vwhere(ttype == float(T.TEX_PERLIN), V3(turb, turb, turb),
                        albedo)
    img_id = None
    if meta["image"]:
        # image texture (texture.cpp:207-225): the uv of the winner normal
        # (for a sphere the reference's (p-c)/radius, sphere.cpp:6-11), the
        # nearest texel, clamped and v-flipped. The lane is shaded with
        # albedo 1 and reports the texel's flat index in the atlas. Only
        # materials that consume albedo do: a glass or light lane whose
        # texture id merely defaults to an image gets no texel.
        iid = zero
        for xi in range(X):
            iid = torch.where(tex_id == xi, tex[8 * X + xi], iid)
        uses_albedo = ((mtype != float(T.MAT_DIELECTRIC))
                       & (mtype != float(T.MAT_DIFFUSE_LIGHT)))
        is_img = (ttype == float(T.TEX_IMAGE)) & uses_albedo
        if ext_mat_rows is not None:
            is_img = is_img & ~is_ext
        u, v = sphere_uv(nrm)
        hs = torch.where(is_img, c1.x, 1.0)
        ws = torch.where(is_img, c1.y, 1.0)
        ti = torch.minimum(torch.clamp_min((u * ws).to(torch.int32), 0),
                           ws.to(torch.int32) - 1)
        tj = torch.minimum(torch.clamp_min(((1.0 - v) * hs).to(torch.int32), 0),
                           hs.to(torch.int32) - 1)
        ih, iw = meta["img_hw"]
        flat = (iid.to(torch.int32) * (ih * iw) + tj * iw + ti).to(torch.float32)
        img_id = torch.where(is_img, flat, -1.0)
        albedo = vwhere(is_img, V3(zero + 1.0, zero + 1.0, zero + 1.0), albedo)

    if ext_mat_rows is not None:
        # the material of a winner from outside: type, parameter and final
        # albedo; everything downstream runs on them unchanged
        em_type, em_param, em_albedo, em_img = ext_mat_rows
        mtype = torch.where(is_ext, em_type, mtype)
        mparam = torch.where(is_ext, em_param, mparam)
        albedo = vwhere(is_ext, em_albedo, albedo)
        if img_id is not None:
            img_id = torch.where(is_ext, em_img, img_id)

    is_light = mtype == float(T.MAT_DIFFUSE_LIGHT)
    zero3 = V3(zero, zero, zero)
    emitted = vwhere(is_light & (vdot(nrm, rd) < 0.0), albedo * mparam, zero3)

    is_iso = mtype == float(T.MAT_ISOTROPIC)
    u_ma = rng.uniform(keys_b, SLOT_MA)
    u_mb = rng.uniform(keys_b, SLOT_MB)
    cos_sampler = (rng.sample_cosine_direction_exact if meta["exact_cosine"]
                   else rng.sample_cosine_direction)
    cos_dir = vonb_l2w(*vonb_from_w(nrm), cos_sampler(u_ma, u_mb))
    iso_dir = rng.sample_on_sphere(u_ma, u_mb)
    mat_gen = vwhere(is_iso, iso_dir, cos_dir)

    def mat_pdf(d):
        cosd = vdot(nrm, d)
        return torch.where(is_iso, 1.0 / (2.0 * PI),
                           torch.where(cosd > 0, cosd / PI, 0.0))

    if lights:
        u_mix = rng.uniform(keys_b, SLOT_MIX)
        u_pick = rng.uniform(keys_b, SLOT_LPICK)
        u_a = rng.uniform(keys_b, SLOT_LA)
        u_b = rng.uniform(keys_b, SLOT_LB)
        pick = torch.clamp((u_pick * nL).to(torch.int32), 0, nL - 1)
        lgen = zero3
        for li, (ltype, lidx) in enumerate(lights):
            if ltype == T.PRIM_SPHERE:
                c0l, c1l, fmv = _sphere_center(sph, S, lidx, time)
                radl = sph[9 * S + lidx]
                cenl = c0l + (c1l - c0l) * fmv
                to_c = cenl - p
                dgen = vonb_l2w(*vonb_from_w(vnormalize(to_c)),
                                rng.sample_towards_sphere(radl, vsdot(to_c), u_a, u_b))
            else:
                ei, ej, ekl, kk, i0, i1, j0, j1, _ = _rect_row(rect, R, lidx)
                iil = i0 + u_a * (i1 - i0)
                jjl = j0 + u_b * (j1 - j0)
                dgen = (ei * iil + ej * jjl + ekl * kk) - p
            lgen = vwhere(pick == li, dgen, lgen)
        d = vnormalize(vwhere(u_mix < 0.5, lgen, mat_gen))
        # light pdf value: average over lights
        lpv = zero
        for (ltype, lidx) in lights:
            if ltype == T.PRIM_SPHERE:
                c0l, c1l, fmv = _sphere_center(sph, S, lidx, time)
                radl = sph[9 * S + lidx]
                cenl = c0l + (c1l - c0l) * fmv
                oc = p - cenl
                b = vdot(oc, d)
                c = vdot(oc, oc) - radl * radl
                disc = b * b - c
                sqd = vsqrt(torch.where(disc > 0, disc, 1.0))
                hitl = (disc > 0) & (-b - sqd > TMIN)
                to_c = cenl - p
                dist_sq = vdot(to_c, to_c)
                cm_arg = torch.clamp(
                    1.0 - radl * radl / torch.clamp_min(dist_sq, 1e-30), 0.0, 1.0)
                cm_ok = cm_arg > 1e-12
                cos_max = torch.where(
                    cm_ok, vsqrt(torch.where(cm_ok, cm_arg, 1.0)), 0.0)
                sa = 2.0 * PI * (1.0 - cos_max)
                lpv = lpv + torch.where(
                    hitl & (sa > 0), 1.0 / torch.clamp_min(sa, 1e-12), 0.0)
            else:
                ei, ej, ekl, kk, i0, i1, j0, j1, sgn = _rect_row(rect, R, lidx)
                dk = vdot(ekl, d)
                facing = dk * sgn <= 0.0
                dk_safe = torch.where(torch.abs(dk) > 1e-30, dk, 1e-30)
                t = (kk - vdot(ekl, p)) / dk_safe
                iiv = vdot(ei, p) + t * vdot(ei, d)
                jjv = vdot(ej, p) + t * vdot(ej, d)
                hitl = (facing & (t >= TMIN)
                        & (iiv >= i0) & (iiv <= i1) & (jjv >= j0) & (jjv <= j1))
                ts = torch.where(hitl, t, 1.0)
                area = (i1 - i0) * (j1 - j0)
                cosine = torch.abs(vdot(d, ekl) * sgn)
                val = ts * ts / torch.clamp_min(cosine * area, 1e-12)
                lpv = lpv + torch.where(hitl, val, 0.0)
        lpv = lpv / nL
        pdf_v = 0.5 * lpv + 0.5 * mat_pdf(d)
    else:
        d = vnormalize(mat_gen)
        pdf_v = mat_pdf(d)

    scatter_pdf = torch.where(
        is_iso, 1.0 / (2.0 * PI), torch.clamp_min(vdot(nrm, d), 0.0) / PI)
    pdf_ok = pdf_v > 1e-12
    safe_pdf = torch.where(pdf_ok, pdf_v, 1.0)
    diffuse_w = albedo * torch.where(pdf_ok, scatter_pdf / safe_pdf, 0.0)

    # metal
    is_metal = mtype == float(T.MAT_METAL)
    refl = vreflect(rd, nrm)
    fuzz = _sample_in_ball(
        rng.uniform(keys_b, SLOT_FUZZ), rng.uniform(keys_b, SLOT_FUZZ + 1),
        rng.uniform(keys_b, SLOT_FUZZ + 2))
    metal_dir = vnormalize(refl + fuzz * (1.0 - mparam))

    # dielectric
    is_diel = mtype == float(T.MAT_DIELECTRIC)
    ref_idx = torch.where(is_diel, mparam, 1.5)
    cosI = -vdot(rd, nrm)
    entering = cosI >= 0
    facing_n = vwhere(entering, nrm, -nrm)
    ni_over_nt = torch.where(entering, 1.0 / ref_idx, ref_idx)
    refracted, can_refract = vrefract(rd, facing_n, ni_over_nt)
    cs_arg = torch.clamp(1.0 - ni_over_nt * ni_over_nt * (1.0 - cosI * cosI),
                         0.0, 1.0)
    cs_ok = cs_arg > 1e-12
    cos_schlick = torch.where(
        entering, cosI,
        torch.where(cs_ok, vsqrt(torch.where(cs_ok, cs_arg, 1.0)), 0.0))
    reflect_prob = torch.where(can_refract, fresnel_schlick(cos_schlick, ref_idx), 1.0)
    do_reflect = rng.uniform(keys_b, SLOT_FRESNEL) < reflect_prob
    diel_dir = vwhere(do_reflect, vnormalize(refl), vnormalize(refracted))
    inside_after = torch.where(entering, inside + 1,
                               torch.clamp_min(inside - 1, 0))
    diel_inside = torch.where(do_reflect, inside, inside_after)

    is_specular = is_metal | is_diel
    new_rd = vwhere(is_metal, metal_dir, vwhere(is_diel, diel_dir, d))
    new_inside = torch.where(is_diel, diel_inside, torch.zeros_like(inside))
    ones3 = V3(zero + 1.0, zero + 1.0, zero + 1.0)
    weight = vwhere(is_diel, ones3, vwhere(is_specular, albedo, diffuse_w))
    return BounceOut(
        hit=hit, safe_t=safe_t, p=p, nrm=nrm, emitted=emitted,
        is_light=is_light, is_specular=is_specular,
        weight=weight, new_rd=new_rd, new_inside=new_inside, img_id=img_id,
    )


def background_color(use_sky: bool, rd: V3) -> V3:
    """Sky gradient or black (main.cpp:110-116)."""
    if use_sky:
        tsky = 0.5 * (rd.y + 1.0)
        return V3((1.0 - tsky) + tsky * 0.5, (1.0 - tsky) + tsky * 0.7,
                  (1.0 - tsky) + tsky * 1.0)
    zero = torch.zeros_like(rd.y)
    return V3(zero, zero, zero)


def camera_ray(cam, ss, tt, new_keys):
    """Thin-lens + shutter camera ray from film coords (camera.h:38-45):
    `models.camera.get_rays`'s formula and op order over the packed camera
    table (origin 0-2, llcorner 3-5, horz 6-8, vert 9-11, u 12-14, v 15-17,
    lens radius 18, time0 19, time1 20)."""
    kc = rng.fold(new_keys, CAM_FOLD)
    u1 = rng.uniform(kc, 0)
    u2 = rng.uniform(kc, 1)
    u3 = rng.uniform(kc, 2)
    radd = vsqrt(u1)
    phid = 2.0 * PI * u2
    lens_r = cam[18]
    dx = radd * torch.cos(phid) * lens_r
    dy = radd * torch.sin(phid) * lens_r
    offset = V3(cam[12], cam[13], cam[14]) * dx + V3(cam[15], cam[16], cam[17]) * dy
    new_time = cam[19] + (cam[20] - cam[19]) * u3
    new_ro = V3(cam[0], cam[1], cam[2]) + offset
    new_dir = vnormalize(V3(
        cam[3] + cam[6] * ss + cam[9] * tt - cam[0] - offset.x,
        cam[4] + cam[7] * ss + cam[10] * tt - cam[1] - offset.y,
        cam[5] + cam[8] * ss + cam[11] * tt - cam[2] - offset.z,
    ))
    return new_ro, new_dir, new_time


class LaneState(NamedTuple):
    """Per-lane render state of the plain version (all (N,) tensors)."""

    accum: V3  # running average * count
    ro: V3
    rd: V3
    time: torch.Tensor
    beta: V3  # path throughput
    radiance: V3
    alive: torch.Tensor  # bool
    count: torch.Tensor  # i32 samples merged
    inside: torch.Tensor  # i32 dielectric nesting
    depth: torch.Tensor  # i32 bounce index
    keys: torch.Tensor  # u32 (int64) per-(pixel, sample) key
    rays: torch.Tensor  # i32 rays traced by the lane


def film_coords(pix, samp, width, height, sq):
    """Stratified film coordinates (main.cpp:316-332) of absolute sample
    `samp` of pixel `pix` (index x + y*width, y from the bottom). The
    divisors are tensors, as in `vecmath.sphere_uv`: the kernels divide."""
    ci = torch.clamp(samp, 0, sq * sq - 1)
    off_x = vdiv(torch.div(ci, sq, rounding_mode="floor").to(torch.float32) + 0.5, sq)
    off_y = vdiv((ci % sq).to(torch.float32) + 0.5, sq)
    xpix = (pix % width).to(torch.float32)
    ypix = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    return vdiv(xpix + off_x, width), vdiv(ypix + off_y, height)


def advance(alive, hit, scattered, add_emitted, emitted: V3, weight: V3, background: V3,
            beta: V3, radiance: V3):
    """The radiance and throughput advance after a bounce (main.cpp:66-118):
    a miss adds the background, a hit its emission unless `add_emitted` is
    false, a scattering hit multiplies the throughput by `weight`, and a path
    whose throughput is zero ends. Lanes that are not `alive` keep their
    throughput and radiance. Returns (cont, beta', radiance')."""
    zero = torch.zeros_like(beta.x)
    zero3 = V3(zero, zero, zero)
    radiance = radiance + vwhere(alive & ~hit, beta * background, zero3)
    radiance = radiance + vwhere(alive & hit & add_emitted, beta * emitted, zero3)
    cont = alive & hit & scattered
    beta = vwhere(cont, beta * weight, beta)
    cont = cont & ((beta.x > 0.0) | (beta.y > 0.0) | (beta.z > 0.0))
    return cont, beta, radiance


def shade_advance(meta, tabs, ptab, ro: V3, rd: V3, time, inside, keys_b, depth_ok,
                  alive, beta: V3, radiance: V3, ext=None, texels=None):
    """One bounce and the advance that follows it (trace body
    main.cpp:66-118): sky or emission into the radiance, the scatter weight
    into the throughput, and for a lane that goes on the image texel of its
    hit. Returns (bounce outputs, cont, beta', radiance'); `cont` says which
    lanes go on, from `b.p` along `b.new_rd`. Lanes that are not `alive`
    keep their throughput and radiance.

    `ext` is the outside candidate (see `bounce_physics`). With
    meta["image"], `texels` is the image atlas as a flat integer vector
    (`atlas_texels`)."""
    b = bounce_physics(meta, tabs, ptab, ro, rd, time, inside, keys_b, ext=ext)
    scattered = depth_ok & ~b.is_light
    cont, beta, radiance = advance(
        alive, b.hit, scattered, ~(scattered & b.is_specular), b.emitted, b.weight,
        background_color(meta["use_sky"], rd), beta, radiance)
    if b.img_id is not None:
        beta = pending_texel(b.img_id, cont, beta, texels)
    return b, cont, beta, radiance


def pending_texel(img_id, cont, beta: V3, texels) -> V3:
    """`beta` with the image texel of each hit (`BounceOut.img_id` >= 0)
    multiplied in, on the lanes that go on (`cont`): only they carry a
    pending image albedo (a lane that ends at the depth cap returns its
    emission only)."""
    pend = cont & (img_id >= 0.0)
    idx = torch.where(pend, img_id, 0.0).long().clamp(0, texels.numel() - 1)
    return vwhere(pend, beta * texel_rgb(texels[idx]), beta)


def wave_step(meta, tabs, ptab, cam, width, height, sq, max_bounces, max_lum,
              sample_lo, n_samples, pix, s: LaneState, ext=None,
              texels=None) -> LaneState:
    """ONE wavefront step: bounce + draw2 merge + lane regeneration (trace
    body main.cpp:66-118 + the incremental-average merge main.cpp:214-229).
    Dead lanes change only their depth.

    `ext` and `texels` as in `shade_advance`."""
    b, cont, beta, radiance = shade_advance(
        meta, tabs, ptab, s.ro, s.rd, s.time, s.inside, rng.fold(s.keys, s.depth),
        s.depth < max_bounces, s.alive, s.beta, s.radiance, ext=ext, texels=texels)
    return finish_step(cam, width, height, sq, max_lum, sample_lo, n_samples, pix, s,
                       cont, b.p, b.new_rd, b.new_inside, beta, radiance)


def finish_step(cam, width, height, sq, max_lum, sample_lo, n_samples, pix, s: LaneState,
                cont, p: V3, new_rd: V3, new_inside, beta: V3, radiance: V3) -> LaneState:
    """The rest of a wave step after the bounce and its advance: a lane whose
    path ends folds its sample into its pixel's running average (the draw2
    merge with its NaN reuse and luminance clamp, main.cpp:214-229) and,
    while its pixel has samples left, starts the next one with a camera ray
    from `cam` (`camera_table`); a lane that goes on moves to `p` along
    `new_rd`. Dead lanes change only their depth."""
    zero = torch.zeros_like(beta.x)
    zero3 = V3(zero, zero, zero)
    finished = s.alive & ~cont
    count = s.count
    cnt_f = count.to(torch.float32)
    has_prev = count > 0
    inv_prev = 1.0 / torch.clamp_min(cnt_f, 1.0)
    prev_avg = vwhere(has_prev, s.accum * inv_prev, zero3)
    finite = (torch.isfinite(radiance.x) & torch.isfinite(radiance.y)
              & torch.isfinite(radiance.z))
    color = vwhere(finite, radiance, prev_avg)
    new_avg = vwhere(has_prev,
                     prev_avg + (color - prev_avg) * (1.0 / (cnt_f + 1.0)),
                     color)
    lum = vluminance(new_avg)
    lscale = torch.where(lum > max_lum, max_lum / torch.clamp_min(lum, 1e-12), 1.0)
    new_avg = new_avg * lscale
    accum = vwhere(finished, new_avg * (cnt_f + 1.0), s.accum)
    count = torch.where(finished, count + 1, count)

    regen = finished & (count < n_samples)
    samp = sample_lo + count
    new_keys = rng.ray_key(pix, samp)
    ss, tt = film_coords(pix, samp, width, height, sq)
    new_ro, new_dir, new_time = camera_ray(cam, ss, tt, new_keys)
    ones3 = V3(zero + 1.0, zero + 1.0, zero + 1.0)
    return LaneState(
        accum=accum,
        ro=vwhere(regen, new_ro, vwhere(cont, p, s.ro)),
        rd=vwhere(regen, new_dir, vwhere(cont, new_rd, s.rd)),
        time=torch.where(regen, new_time, s.time),
        beta=vwhere(regen, ones3, beta),
        radiance=vwhere(regen, zero3, radiance),
        alive=cont | regen,
        count=count,
        inside=torch.where(regen, 0, torch.where(cont, new_inside, s.inside)),
        depth=torch.where(regen, 0, s.depth + 1),
        keys=torch.where(regen, new_keys, s.keys),
        rays=s.rays + s.alive.to(torch.int32),
    )


def initial_lanes(scene, pix, sample_lo, n_samples, *, width, height, spp_sq) -> LaneState:
    """One lane for each pixel of `pix` ((N,) int64) at the camera ray of its
    sample `sample_lo`; every lane alive when there is a sample to render."""
    n = pix.shape[0]
    samp0 = torch.full((n,), sample_lo, dtype=torch.int64, device=pix.device)
    keys0 = rng.ray_key(pix, samp0)
    ss, tt = film_coords(pix, samp0, width, height, spp_sq)
    rays0 = cam_mod.get_rays(scene.camera, ss, tt, keys0)
    zero = torch.zeros((n,), dtype=torch.float32, device=pix.device)
    izero = torch.zeros((n,), dtype=torch.int32, device=pix.device)
    return LaneState(
        accum=V3(zero, zero, zero), ro=rays0.ro, rd=rays0.rd,
        time=rays0.time, beta=V3(zero + 1.0, zero + 1.0, zero + 1.0),
        radiance=V3(zero, zero, zero),
        alive=torch.full((n,), n_samples > 0, device=pix.device),
        count=izero, inside=rays0.inside, depth=izero, keys=keys0,
        rays=izero)


def check_render_args(scene, pix, width, height, spp_sq, max_bounces):
    """The checks of every renderer's pixel entry point: `pix` a 1-D int32
    tensor on the scene's device, positive sizes."""
    if pix.dtype != torch.int32 or pix.dim() != 1:
        raise ValueError(f"pix must be a 1-D int32 tensor, got {pix.dtype} "
                         f"of shape {tuple(pix.shape)}")
    if pix.device != scene.device:
        raise ValueError(f"pix is on {pix.device}, the scene on {scene.device}")
    if min(width, height, spp_sq) < 1 or max_bounces < 0:
        raise ValueError("width, height and spp_sq must be >= 1 and "
                         "max_bounces >= 0")


def _render_args(scene, pix, width, height, spp_sq, max_bounces):
    check_render_args(scene, pix, width, height, spp_sq, max_bounces)
    if not can_fuse(scene):
        raise ValueError(f"scene {scene.name!r} is outside the fused class "
                         "(see can_fuse)")


def render_wavefront_fused_pixels_plain(scene, pix, sample_lo, n_samples,
                                        max_lum, *, width, height,
                                        max_bounces, spp_sq):
    """Plain PyTorch version of the fused render, on any device.

    Renders samples [sample_lo, sample_lo + n_samples) of each pixel in
    `pix` ((N,) int32, index x + y*width). Returns (accum (N,3) f32 =
    running average * count, count (N,) i32, rays (N,) i32)."""
    _render_args(scene, pix, width, height, spp_sq, max_bounces)
    meta, tables = pack_scene(scene)
    tabs, cam, ptab = tables[:7], tables[7], tables[8]
    pix64 = pix.to(torch.int64)
    s = initial_lanes(scene, pix64, sample_lo, n_samples, width=width, height=height,
                      spp_sq=spp_sq)
    while bool(s.alive.any()):
        s = wave_step(meta, tabs, ptab, cam, width, height, spp_sq,
                      max_bounces, max_lum, sample_lo, n_samples, pix64, s)
    return s.accum.arr, s.count, s.rays


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------

# integer parameter block of mrt_fused_render (csrc/bounce.cu: ParamIdx)
_N_IPARAMS = 26


def kernel_params(meta, n, sample_lo, n_samples, *, width, height,
                  max_bounces, spp_sq):
    """The integer parameter block of mrt_fused_render (csrc/bounce.cu,
    ParamIdx order)."""
    lights = list(meta["lights"])
    if len(lights) > MAX_LIGHTS:
        raise ValueError(f"at most {MAX_LIGHTS} lights")
    if n >= 2 ** 31 - 128 or width * height >= 2 ** 31:
        raise ValueError("too many lanes for int32 indexing")
    pad = [0] * (MAX_LIGHTS - len(lights))
    ip = [n, width, height, spp_sq, max_bounces, sample_lo, n_samples,
          meta["S"], meta["R"], meta["Tc"], meta["Bx"], meta["V"], meta["M"],
          meta["X"], len(lights), *[lt for lt, _ in lights], *pad,
          *[li for _, li in lights], *pad, int(meta["use_sky"]),
          int(meta["exact_cosine"]), int(meta["perlin"])]
    assert len(ip) == _N_IPARAMS
    return ip


def _launch_kernel(meta, tables, pix, sample_lo, n_samples, max_lum, **kw):
    """Launch csrc/bounce.cu on the current stream; outputs as in
    render_wavefront_fused_pixels_plain."""
    from miniraytracer_tpu_torch.utils import kernels

    global launches
    dev = pix.device
    for t in list(tables) + [pix]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("kernel tables and pix must be contiguous "
                             f"tensors on {dev}")
    if any(t.dtype != torch.float32 for t in tables):
        raise ValueError("kernel tables must be float32")
    if tables[8].shape != (6, 256) or tables[7].shape != (21,):
        raise ValueError("bad Perlin or camera table shape")
    n = pix.shape[0]
    ip = kernel_params(meta, n, sample_lo, n_samples, **kw)
    accum = torch.empty((n, 3), dtype=torch.float32, device=dev)
    count = torch.empty((n,), dtype=torch.int32, device=dev)
    rays = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = kernels.load("bounce")
    fn = lib.mrt_fused_render
    fn.argtypes = ([ctypes.c_void_p] * 13
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in tables], pix.data_ptr(),
                accum.data_ptr(), count.data_ptr(), rays.data_ptr(),
                (ctypes.c_int * _N_IPARAMS)(*ip), ctypes.c_float(max_lum),
                stream)
    if rc != 0:
        raise RuntimeError(f"mrt_fused_render failed: {kernels.error_string(lib, rc)}")
    launches += 1
    return accum, count, rays


def render_wavefront_fused_pixels(scene, pix, sample_lo, n_samples, max_lum,
                                  *, width, height, max_bounces, spp_sq):
    """The fused render of samples [sample_lo, sample_lo + n_samples) of each
    pixel in `pix`, on the scene's device: the CUDA kernel for a CUDA scene,
    the plain version for a CPU scene. Returns (accum (N,3), count (N,)
    i32, rays (N,) i32)."""
    _render_args(scene, pix, width, height, spp_sq, max_bounces)
    kw = dict(width=width, height=height, max_bounces=max_bounces,
              spp_sq=spp_sq)
    if scene.device.type == "cpu":
        return render_wavefront_fused_pixels_plain(
            scene, pix, sample_lo, n_samples, max_lum, **kw)
    if scene.device.type != "cuda":
        raise ValueError(f"no fused renderer for device {scene.device}")
    meta, tables = pack_scene(scene)
    return _launch_kernel(meta, tables, pix, sample_lo, n_samples, max_lum,
                          **kw)


def render_wavefront_fused(scene, width, height, spp, max_bounces=32,
                           max_lum=1000.0):
    """Full-frame fused render on the scene's device. Returns (frame (H,W,3)
    f32 tensor, stats); stats["rays"] is the exact int ray count."""
    sq = int(math.isqrt(spp))
    ns = sq * sq
    t0 = _time.perf_counter()
    pix = torch.arange(width * height, dtype=torch.int32, device=scene.device)
    accum, count, rays = render_wavefront_fused_pixels(
        scene, pix, 0, ns, max_lum, width=width, height=height,
        max_bounces=max_bounces, spp_sq=sq)
    frame = accum / torch.clamp_min(count.to(torch.float32), 1.0)[:, None]
    total = int(rays.sum(dtype=torch.int64))  # waits for the device
    elapsed = _time.perf_counter() - t0
    return frame.reshape(height, width, 3), {
        "seconds": elapsed,
        "rays": total,
        "mrays_per_s": total / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": ns,
        "renderer": "fused",
    }
