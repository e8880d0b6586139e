"""Plain PyTorch path tracer of the fused scene class: the yardstick of `correct`.

A frozen copy of the estimator that the port and the JAX package both follow
(the reference renderer's trace() body, main.cpp:66-118): the counter-keyed
PCG hash RNG, the stratified film offsets, the thin-lens camera, the hit sweep
over spheres, rects, boxes and constant-density volumes, and the shading of
lambertian, metal, dielectric, diffuse-light and isotropic materials with 50/50
light sampling. Every random draw is a pure function of (pixel, sample,
bounce, slot), so this tracer draws the numbers the program draws for the
same path, and a served pixel can be held against the reference pixel by
pixel.

It imports nothing of the program. It takes the scene's description (the
`SceneData` fields a benchmark configuration builds) and packs its own tables.
Unlike the program it traces one lane a SAMPLE and compacts the live lanes
after every bounce, so its cost follows the rays traced.

Every float is of the dtype the caller names: float32 is the reference, a
lower one (bfloat16) the control that must fail the comparison.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = 3.0e38
NEG = -3.0e38
TMIN = 0.001
PI = 3.14159265358979323846

MAT_METAL, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC = 1, 2, 3, 4
TEX_CHECKER = 1
PRIM_SPHERE = 0
VOLB_SPHERE = 0

SLOT_VOL, SLOT_MIX, SLOT_LPICK, SLOT_LA, SLOT_LB = 0, 8, 9, 10, 11
SLOT_MA, SLOT_MB, SLOT_FUZZ, SLOT_FRESNEL = 12, 13, 14, 17
CAM_FOLD = 0x0C0FFEE

# ---------------------------------------------------------------------------
# RNG: u32 words held in int64
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
M1, M2, M3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D


def _mul32(a, c: int):
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pcg_hash(x):
    state = (_mul32(x & _MASK, 747796405) + 2891336453) & _MASK
    word = _mul32(((state >> ((state >> 28) + 4)) ^ state), 277803737)
    return (word >> 22) ^ word


def fold(key, data):
    return pcg_hash(_mul32(key & _MASK, M1) + _mul32(data & _MASK, M2) + M3)


def ray_key(pix, samp):
    h = pcg_hash(_mul32(pix & _MASK, M1) + 0x1234567)
    return pcg_hash(h + _mul32(samp & _MASK, M2))


def uniform(key, slot: int, dt):
    """[0, 1) by the mantissa trick: float32 bits, then the tracer's dtype."""
    b = pcg_hash(key + ((slot * M3) & _MASK))
    f = ((b & 0x007FFFFF) | 0x3F800000).to(torch.int32)
    return (f.view(torch.float32) - 1.0).to(dt)


# ---------------------------------------------------------------------------
# 3-vectors as three (N,) tensors
# ---------------------------------------------------------------------------


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def take(self, idx):
        return V3(self.x[idx], self.y[idx], self.z[idx])


def vsqrt(x):
    """Correctly rounded square root (IEEE sqrtf, as the kernels take it)."""
    return torch.sqrt(x.double()).to(x.dtype)


def vdiv(x, d):
    """x / d as an elementwise IEEE division, not a product by 1/d."""
    return x / torch.full_like(x, float(d))


def vdot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def vcross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x)


def vnormalize(a: V3) -> V3:
    n2 = vdot(a, a)
    ok = n2 > 1e-20
    return a * torch.where(ok, 1.0 / vsqrt(torch.where(ok, n2, 1.0)), 0.0)


def vwhere(mask, a: V3, b: V3) -> V3:
    return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
              torch.where(mask, a.z, b.z))


def vluminance(c: V3):
    return 0.212655 * c.x + 0.715158 * c.y + 0.072187 * c.z


def onb(n: V3):
    big_x = torch.abs(n.x) > 0.9
    zero = torch.zeros_like(n.x)
    a = V3(torch.where(big_x, 0.0, 1.0 + zero), torch.where(big_x, 1.0, zero), zero)
    v = vnormalize(vcross(n, a))
    return vcross(n, v), v, n


def l2w(u: V3, v: V3, w: V3, local: V3) -> V3:
    return u * local.x + v * local.y + w * local.z


def sample_on_sphere(r1, r2) -> V3:
    x = r1 * 2.0 - 1.0
    phi = r2 * 2.0 * PI
    s = vsqrt(torch.clamp_min(1.0 - x * x, 0.0))
    return V3(x, torch.cos(phi) * s, torch.sin(phi) * s)


def sample_cosine(r1, r2, exact: bool) -> V3:
    """The reference's cosine lobe (pcg.cpp:87-98) with its factor 2 on x and
    y, or the textbook one where the scene asks for it."""
    z = vsqrt(torch.clamp_min(1.0 - r2, 0.0))
    phi = 2.0 * PI * r1
    sq = vsqrt(r2) if exact else 2.0 * vsqrt(r2)
    return V3(torch.cos(phi) * sq, torch.sin(phi) * sq, z)


# ---------------------------------------------------------------------------
# Scene tables
# ---------------------------------------------------------------------------

_TABLES = {
    "sph": ("sph_c0", "sph_c1", "sph_t0", "sph_t1", "sph_moving", "sph_radius", "sph_mat",
            "sph_active"),
    "rect": ("rect_ei", "rect_ej", "rect_ek", "rect_k", "rect_i0", "rect_i1", "rect_j0",
             "rect_j1", "rect_sign", "rect_mat", "rect_active"),
    "box": ("box_lo", "box_hi", "box_cs", "box_off", "box_mat", "box_active"),
    "vol": ("vol_bparams", "vol_btype", "vol_density", "vol_mat", "vol_active"),
    "mat": ("mat_type", "mat_param", "mat_tex"),
    "tex": ("tex_type", "tex_c0", "tex_c1", "tex_scale", "tex_img"),
}
CAMERA = ("origin", "llcorner", "horz", "vert", "u", "v", "lens_radius", "time0", "time1")


class Scene(NamedTuple):
    """Flat tables of one scene in one dtype on one device."""

    counts: dict
    tabs: dict
    live: dict  # per table, the rows that are active (an inactive row never wins a hit)
    cam: torch.Tensor
    lights: tuple
    use_sky: bool
    exact_cosine: bool


def pack(scene, dt=torch.float32, device=None, leaves=None) -> Scene:
    """The tables of a `SceneData`-like object (its fields by name), each a
    flat vector of dtype `dt`. `leaves` maps field names to tensors that
    replace the scene's (the parameters a gradient is taken of)."""
    if scene.has_perlin or scene.has_image or bool(scene.tri_active.any()):
        raise ValueError("the reference tracer covers scenes without Perlin noise, image "
                         "textures and triangles (an inactive pad triangle is none)")
    leaves = leaves or {}
    device = device or scene.sph_c0.device
    field = lambda k: leaves[k] if k in leaves else getattr(scene, k)
    counts = dict(S=scene.sph_radius.shape[0], R=scene.rect_k.shape[0],
                  Bx=scene.box_lo.shape[0] if scene.has_boxes else 0,
                  V=scene.vol_density.shape[0], M=scene.mat_type.shape[0],
                  X=scene.tex_type.shape[0])
    n_of = dict(sph="S", rect="R", box="Bx", vol="V", mat=None, tex=None)
    tabs = {}
    for name, keys in _TABLES.items():
        if n_of[name] and not counts[n_of[name]]:
            tabs[name] = torch.zeros((1,), dtype=dt, device=device)
            continue
        tabs[name] = torch.cat([field(k).to(device=device, dtype=dt).reshape(-1)
                                for k in keys])
    cam = torch.cat([getattr(scene.camera, k).to(device=device, dtype=dt).reshape(-1)
                     for k in CAMERA])
    live = {k: [i for i, a in enumerate(getattr(scene, f"{k}_active").tolist()) if a]
            for k in ("sph", "rect", "box", "vol")}
    return Scene(counts, tabs, live, cam, tuple(scene.lights), bool(scene.use_sky),
                 bool(scene.exact_cosine))


def active_counts(scene) -> dict:
    """Active primitives of each kind (pad rows are inactive)."""
    n = lambda k: int(getattr(scene, k).sum())
    return dict(S=n("sph_active"), R=n("rect_active"), Tc=n("tri_active"),
                Bx=n("box_active") if scene.has_boxes else 0, V=n("vol_active"))


def table_bytes(sc: Scene) -> int:
    """Bytes of the flat float32 tables the fused kernels read (pack_scene's
    nine: sph, rect, tri, box, vol, mat, tex, cam, and the 6x256 Perlin rows)."""
    words = sum(t.numel() for t in sc.tabs.values()) + 1 + sc.cam.numel() + 6 * 256
    return 4 * words


# ---------------------------------------------------------------------------
# One bounce
# ---------------------------------------------------------------------------


class Bounce(NamedTuple):
    hit: torch.Tensor
    p: V3
    emitted: V3
    is_light: torch.Tensor
    is_specular: torch.Tensor
    weight: V3
    new_rd: V3
    new_inside: torch.Tensor


def _sphere_center(sph, S, si, time):
    c0 = V3(sph[3 * si], sph[3 * si + 1], sph[3 * si + 2])
    o = 3 * S
    c1 = V3(sph[o + 3 * si], sph[o + 3 * si + 1], sph[o + 3 * si + 2])
    o = 6 * S
    t0s, t1s, mov = sph[o + si], sph[o + S + si], sph[o + 2 * S + si]
    fmv = torch.where(mov > 0, (time - t0s) / torch.where(mov > 0, t1s - t0s, 1.0), 0.0)
    return c0, c1, fmv


def _rect_row(rect, R, ri):
    ei = V3(rect[3 * ri], rect[3 * ri + 1], rect[3 * ri + 2])
    ej = V3(rect[3 * R + 3 * ri], rect[3 * R + 3 * ri + 1], rect[3 * R + 3 * ri + 2])
    ek = V3(rect[6 * R + 3 * ri], rect[6 * R + 3 * ri + 1], rect[6 * R + 3 * ri + 2])
    o = 9 * R
    return (ei, ej, ek, rect[o + ri], rect[o + R + ri], rect[o + 2 * R + ri],
            rect[o + 3 * R + ri], rect[o + 4 * R + ri], rect[o + 5 * R + ri])


def _slab_inv(da):
    tiny = torch.where(da >= 0, 1e-12, -1e-12).to(da.dtype)
    return 1.0 / torch.where(torch.abs(da) > 1e-12, da, tiny)


_AXES = ((0, 1, 2), (1, 0, 2), (2, 0, 1))


def _rotated(ro: V3, rd: V3, sinb, cosb, off: V3):
    rol = ro - off
    return ((cosb * rol.x - sinb * rol.z, rol.y, cosb * rol.z + sinb * rol.x),
            (cosb * rd.x - sinb * rd.z, rd.y, cosb * rd.z + sinb * rd.x))


def bounce(sc: Scene, ro: V3, rd: V3, time, inside, keys_b) -> Bounce:
    """The nearest hit over the scene (a running winner: spheres, rects,
    boxes, volumes, each replacing it only when strictly nearer) and the
    shading of the winner's material."""
    c = sc.counts
    S, R, Bx, V, M, X = c["S"], c["R"], c["Bx"], c["V"], c["M"], c["X"]
    sph, rect, box, vol, mat, tex = (sc.tabs[k] for k in ("sph", "rect", "box", "vol", "mat",
                                                           "tex"))
    dt = time.dtype
    zero = torch.zeros_like(time)
    best_t = torch.full_like(time, INF)
    w_n = V3(zero + 1.0, zero, zero)
    w_mat = torch.zeros_like(inside)

    for si in sc.live["sph"]:
        c0, c1, fmv = _sphere_center(sph, S, si, time)
        rad = sph[9 * S + si]
        matid, act = sph[10 * S + si], sph[11 * S + si]
        cen = V3(c0.x + fmv * (c1.x - c0.x), c0.y + fmv * (c1.y - c0.y),
                 c0.z + fmv * (c1.z - c0.z))
        oc = ro - cen
        b = vdot(oc, rd)
        disc = b * b - (vdot(oc, oc) - rad * rad)
        sqd = vsqrt(torch.where(disc > 0, disc, 1.0))
        t_front, t_back = -b - sqd, -b + sqd
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

    for ri in sc.live["rect"]:
        ei, ej, ek, kk, i0, i1, j0, j1, sgn = _rect_row(rect, R, ri)
        matid, act = rect[15 * R + ri], rect[16 * R + ri]
        dk = vdot(ek, rd)
        facing = dk * sgn <= 0.0
        t = (kk - vdot(ek, ro)) / torch.where(torch.abs(dk) > 1e-30, dk, 1e-30)
        iiv = vdot(ei, ro) + t * vdot(ei, rd)
        jjv = vdot(ej, ro) + t * vdot(ej, rd)
        valid = (facing & (t >= TMIN) & (t < best_t) & (act > 0)
                 & (iiv >= i0) & (iiv <= i1) & (jjv >= j0) & (jjv <= j1))
        best_t = torch.where(valid, t, best_t)
        w_n = vwhere(valid, V3(zero + ek.x * sgn, zero + ek.y * sgn, zero + ek.z * sgn), w_n)
        w_mat = torch.where(valid, matid.to(torch.int32), w_mat)

    for bi in sc.live["box"][:Bx]:
        blo = (box[3 * bi], box[3 * bi + 1], box[3 * bi + 2])
        bhi = (box[3 * Bx + 3 * bi], box[3 * Bx + 3 * bi + 1], box[3 * Bx + 3 * bi + 2])
        sinb, cosb = box[6 * Bx + 2 * bi], box[6 * Bx + 2 * bi + 1]
        offb = V3(box[8 * Bx + 3 * bi], box[8 * Bx + 3 * bi + 1], box[8 * Bx + 3 * bi + 2])
        matid, act = box[11 * Bx + bi], box[12 * Bx + bi]
        bl, bd = _rotated(ro, rd, sinb, cosb, offb)
        tb = torch.full_like(time, INF)
        nax, nsg = torch.zeros_like(time), torch.zeros_like(time)
        for a, b_, c_ in _AXES:
            invd = _slab_inv(bd[a])
            for bound, face_ok, sg in ((blo[a], bd[a] > 0, -1.0), (bhi[a], bd[a] < 0, 1.0)):
                tf = (bound - bl[a]) * invd
                pb = bl[b_] + tf * bd[b_]
                pc = bl[c_] + tf * bd[c_]
                okf = (face_ok & (tf >= TMIN) & (tf < tb) & (pb >= blo[b_]) & (pb <= bhi[b_])
                       & (pc >= blo[c_]) & (pc <= bhi[c_]))
                tb = torch.where(okf, tf, tb)
                nax = torch.where(okf, float(a), nax)
                nsg = torch.where(okf, sg, nsg)
        valid = (tb < best_t) & (act > 0)
        nlx = torch.where(nax == 0.0, nsg, 0.0)
        nly = torch.where(nax == 1.0, nsg, 0.0)
        nlz = torch.where(nax == 2.0, nsg, 0.0)
        best_t = torch.where(valid, tb, best_t)
        w_n = vwhere(valid, V3(cosb * nlx + sinb * nlz, nly, cosb * nlz - sinb * nlx), w_n)
        w_mat = torch.where(valid, matid.to(torch.int32), w_mat)

    for vi in sc.live["vol"]:
        bp = [vol[12 * vi + k] for k in range(12)]
        btype, dens = vol[12 * V + vi], vol[13 * V + vi]
        vmat, vact = vol[14 * V + vi], vol[15 * V + vi]
        oc = ro - V3(bp[0], bp[1], bp[2])
        b = vdot(oc, rd)
        disc = b * b - (vdot(oc, oc) - bp[3] * bp[3])
        sqd = vsqrt(torch.where(disc > 0, disc, 1.0))
        s_ok = disc > 0
        sph_t1 = torch.where(s_ok, -b - sqd, INF)
        sph_t2 = torch.where(s_ok & (inside > 0), -b + sqd, INF)
        bmin, bmax = bp[0:3], bp[3:6]
        bl, bd = _rotated(ro, rd, bp[6], bp[7], V3(bp[8], bp[9], bp[10]))
        faces = []
        for a, b_, c_ in _AXES:
            invd = _slab_inv(bd[a])
            for bound, face_ok in ((bmin[a], bd[a] > 0), (bmax[a], bd[a] < 0)):
                tf = (bound - bl[a]) * invd
                pb = bl[b_] + tf * bd[b_]
                pc = bl[c_] + tf * bd[c_]
                okf = (face_ok & (pb >= bmin[b_]) & (pb <= bmax[b_])
                       & (pc >= bmin[c_]) & (pc <= bmax[c_]))
                faces.append(torch.where(okf, tf, INF))
        is_sph = btype == float(VOLB_SPHERE)
        cands = ([torch.where(is_sph, sph_t1, faces[0]), torch.where(is_sph, sph_t2, faces[1])]
                 + [torch.where(is_sph, INF, f) for f in faces[2:]])
        rec1 = cands[0]
        for cd in cands[1:]:
            rec1 = torch.minimum(rec1, cd)
        got1 = rec1 < INF
        rec2 = torch.full_like(rec1, INF)
        for cd in cands:
            rec2 = torch.minimum(rec2, torch.where(cd > rec1 + 1e-4, cd, INF))
        got2 = rec2 < INF
        rec1c = torch.clamp_min(torch.where(got1, rec1, NEG), TMIN)
        rec2c = torch.minimum(torch.where(got2, rec2, NEG), best_t)
        valid = got1 & got2 & (rec1c < rec2c) & (vact > 0)
        uv = torch.clamp(uniform(keys_b, SLOT_VOL + vi, dt), 1e-38, 1.0)
        hit_dist = -(1.0 / dens) * torch.log(uv)
        tvol = rec1c + hit_dist
        better = valid & (hit_dist < rec2c - rec1c) & (tvol < best_t)
        best_t = torch.where(better, tvol, best_t)
        w_n = vwhere(better, V3(zero + 1.0, zero, zero), w_n)
        w_mat = torch.where(better, vmat.to(torch.int32), w_mat)

    hit = best_t < INF
    p = ro + rd * torch.where(hit, best_t, 1.0)
    nrm = vwhere(hit, w_n, V3(zero + 1.0, zero, zero))

    mtype, mparam, tex_id = zero, zero, zero
    for mi in range(M):
        selm = w_mat == mi
        mtype = torch.where(selm, mat[mi], mtype)
        mparam = torch.where(selm, mat[M + mi], mparam)
        tex_id = torch.where(selm, mat[2 * M + mi], tex_id)
    c0 = c1 = V3(zero, zero, zero)
    ttype, tscale = zero, zero
    for xi in range(X):
        selx = tex_id == xi
        ttype = torch.where(selx, tex[xi], ttype)
        c0 = vwhere(selx, V3(zero + tex[X + 3 * xi], zero + tex[X + 3 * xi + 1],
                             zero + tex[X + 3 * xi + 2]), c0)
        c1 = vwhere(selx, V3(zero + tex[4 * X + 3 * xi], zero + tex[4 * X + 3 * xi + 1],
                             zero + tex[4 * X + 3 * xi + 2]), c1)
        tscale = torch.where(selx, tex[7 * X + xi], tscale)
    sines = torch.sin(tscale * p.x) * torch.sin(tscale * p.y) * torch.sin(tscale * p.z)
    albedo = vwhere((ttype == float(TEX_CHECKER)) & (sines < 0), c1, c0)

    is_light = mtype == float(MAT_DIFFUSE_LIGHT)
    zero3 = V3(zero, zero, zero)
    emitted = vwhere(is_light & (vdot(nrm, rd) < 0.0), albedo * mparam, zero3)

    is_iso = mtype == float(MAT_ISOTROPIC)
    u_ma, u_mb = uniform(keys_b, SLOT_MA, dt), uniform(keys_b, SLOT_MB, dt)
    cos_dir = l2w(*onb(nrm), sample_cosine(u_ma, u_mb, sc.exact_cosine))
    mat_gen = vwhere(is_iso, sample_on_sphere(u_ma, u_mb), cos_dir)

    def mat_pdf(d):
        cosd = vdot(nrm, d)
        return torch.where(is_iso, 1.0 / (2.0 * PI), torch.where(cosd > 0, cosd / PI, 0.0))

    lights = sc.lights
    if lights:
        nL = len(lights)
        u_mix = uniform(keys_b, SLOT_MIX, dt)
        u_pick = uniform(keys_b, SLOT_LPICK, dt)
        u_a, u_b = uniform(keys_b, SLOT_LA, dt), uniform(keys_b, SLOT_LB, dt)
        pick = torch.clamp((u_pick * nL).to(torch.int32), 0, nL - 1)
        lgen = zero3
        for li, (ltype, lidx) in enumerate(lights):
            if ltype == PRIM_SPHERE:
                raise ValueError("the reference tracer samples rect lights only")
            ei, ej, ekl, kk, i0, i1, j0, j1, _ = _rect_row(rect, R, lidx)
            dgen = (ei * (i0 + u_a * (i1 - i0)) + ej * (j0 + u_b * (j1 - j0)) + ekl * kk) - p
            lgen = vwhere(pick == li, dgen, lgen)
        d = vnormalize(vwhere(u_mix < 0.5, lgen, mat_gen))
        lpv = zero
        for ltype, lidx in lights:
            ei, ej, ekl, kk, i0, i1, j0, j1, sgn = _rect_row(rect, R, lidx)
            dk = vdot(ekl, d)
            facing = dk * sgn <= 0.0
            t = (kk - vdot(ekl, p)) / torch.where(torch.abs(dk) > 1e-30, dk, 1e-30)
            iiv = vdot(ei, p) + t * vdot(ei, d)
            jjv = vdot(ej, p) + t * vdot(ej, d)
            hitl = (facing & (t >= TMIN) & (iiv >= i0) & (iiv <= i1) & (jjv >= j0)
                    & (jjv <= j1))
            ts = torch.where(hitl, t, 1.0)
            cosine = torch.abs(vdot(d, ekl) * sgn)
            val = ts * ts / torch.clamp_min(cosine * ((i1 - i0) * (j1 - j0)), 1e-12)
            lpv = lpv + torch.where(hitl, val, 0.0)
        pdf_v = 0.5 * (lpv / nL) + 0.5 * mat_pdf(d)
    else:
        d = vnormalize(mat_gen)
        pdf_v = mat_pdf(d)

    scatter_pdf = torch.where(is_iso, 1.0 / (2.0 * PI), torch.clamp_min(vdot(nrm, d), 0.0) / PI)
    pdf_ok = pdf_v > 1e-12
    diffuse_w = albedo * torch.where(pdf_ok, scatter_pdf / torch.where(pdf_ok, pdf_v, 1.0), 0.0)

    is_metal = mtype == float(MAT_METAL)
    refl = rd - nrm * (2.0 * vdot(rd, nrm))
    fball = sample_on_sphere(uniform(keys_b, SLOT_FUZZ, dt), uniform(keys_b, SLOT_FUZZ + 1, dt))
    r3 = torch.clamp_min(uniform(keys_b, SLOT_FUZZ + 2, dt), 1e-30)
    fuzz = fball * torch.exp(torch.log(r3) * (1.0 / 3.0))
    metal_dir = vnormalize(refl + fuzz * (1.0 - mparam))

    is_diel = mtype == float(MAT_DIELECTRIC)
    ref_idx = torch.where(is_diel, mparam, 1.5)
    cos_i = -vdot(rd, nrm)
    entering = cos_i >= 0
    facing_n = vwhere(entering, nrm, -nrm)
    eta = torch.where(entering, 1.0 / ref_idx, ref_idx)
    ncos = vdot(rd, facing_n)
    sin_t2 = (eta * eta) * (1.0 - ncos * ncos)
    can_refract = sin_t2 <= 1.0
    safe = sin_t2 < 1.0 - 1e-9
    cos_t = torch.where(safe, vsqrt(torch.where(safe, 1.0 - sin_t2, 1.0)), 0.0)
    refracted = rd * eta + facing_n * (eta * (-ncos) - cos_t)
    cs_arg = torch.clamp(1.0 - eta * eta * (1.0 - cos_i * cos_i), 0.0, 1.0)
    cs_ok = cs_arg > 1e-12
    cos_schlick = torch.where(entering, cos_i,
                              torch.where(cs_ok, vsqrt(torch.where(cs_ok, cs_arg, 1.0)), 0.0))
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    cc = 1.0 - cos_schlick
    cc2 = cc * cc
    schlick = r0 + (1.0 - r0) * (cc * (cc2 * cc2))
    reflect_prob = torch.where(can_refract, schlick, 1.0)
    do_reflect = uniform(keys_b, SLOT_FRESNEL, dt) < reflect_prob
    diel_dir = vwhere(do_reflect, vnormalize(refl), vnormalize(refracted))
    inside_after = torch.where(entering, inside + 1, torch.clamp_min(inside - 1, 0))

    is_specular = is_metal | is_diel
    ones3 = V3(zero + 1.0, zero + 1.0, zero + 1.0)
    return Bounce(
        hit=hit, p=p, emitted=emitted, is_light=is_light, is_specular=is_specular,
        weight=vwhere(is_diel, ones3, vwhere(is_specular, albedo, diffuse_w)),
        new_rd=vwhere(is_metal, metal_dir, vwhere(is_diel, diel_dir, d)),
        new_inside=torch.where(is_diel, torch.where(do_reflect, inside, inside_after),
                               torch.zeros_like(inside)))


# ---------------------------------------------------------------------------
# Camera rays and whole paths
# ---------------------------------------------------------------------------


def camera_rays(sc: Scene, pix, samp, width: int, height: int, sq: int):
    """The camera ray of absolute sample `samp` of pixel `pix` (index x +
    y*width), at the stratified offset `samp % sq^2` of an sq x sq grid.
    Returns (ro, rd, time, root keys)."""
    dt, cam = sc.cam.dtype, sc.cam
    keys = ray_key(pix, samp)
    ci = samp % (sq * sq)
    off_x = vdiv(torch.div(ci, sq, rounding_mode="floor").to(dt) + 0.5, sq)
    off_y = vdiv((ci % sq).to(dt) + 0.5, sq)
    ss = vdiv((pix % width).to(dt) + off_x, width)
    tt = vdiv(torch.div(pix, width, rounding_mode="floor").to(dt) + off_y, height)
    kc = fold(keys, CAM_FOLD)
    u1, u2, u3 = uniform(kc, 0, dt), uniform(kc, 1, dt), uniform(kc, 2, dt)
    radd, phid = vsqrt(u1), 2.0 * PI * u2
    dx = radd * torch.cos(phid) * cam[18]
    dy = radd * torch.sin(phid) * cam[18]
    offset = V3(cam[12] * dx, cam[13] * dx, cam[14] * dx) + V3(cam[15] * dy, cam[16] * dy,
                                                               cam[17] * dy)
    ro = V3(cam[0] + offset.x, cam[1] + offset.y, cam[2] + offset.z)
    rd = vnormalize(V3(cam[3] + cam[6] * ss + cam[9] * tt - cam[0] - offset.x,
                       cam[4] + cam[7] * ss + cam[10] * tt - cam[1] - offset.y,
                       cam[5] + cam[8] * ss + cam[11] * tt - cam[2] - offset.z))
    return ro, rd, cam[19] + (cam[20] - cam[19]) * u3, keys


class Lanes(NamedTuple):
    """The entry state of the live lanes at one depth: the sample each lane
    traces (`idx`), its ray, throughput and radiance so far ((n, 3) each),
    its time, dielectric nesting and path key."""

    idx: torch.Tensor
    ro: torch.Tensor
    rd: torch.Tensor
    beta: torch.Tensor
    rad: torch.Tensor
    time: torch.Tensor
    inside: torch.Tensor
    keys: torch.Tensor

    def part(self, a: int, b: int) -> "Lanes":
        return Lanes(*(t[a:b] for t in self))


def _v3(t) -> V3:
    return V3(*t.unbind(1))


def _t(v: V3):
    return torch.stack([v.x, v.y, v.z], dim=1)


def advance(sc: Scene, lanes: Lanes, depth: int, max_bounces: int, ro=None, rd=None,
            beta=None, rad=None):
    """One bounce of every lane and the advance after it (main.cpp:66-118):
    the sky or emission into the radiance, the scatter weight into the
    throughput. Returns (cont, p, new_rd, new_inside, beta', rad'); `cont`
    says which lanes go on. `ro`, `rd`, `beta`, `rad` replace the lanes' own
    (tensors that carry a gradient)."""
    ro = _v3(lanes.ro if ro is None else ro)
    rd = _v3(lanes.rd if rd is None else rd)
    beta = _v3(lanes.beta if beta is None else beta)
    rad = _v3(lanes.rad if rad is None else rad)
    b = bounce(sc, ro, rd, lanes.time, lanes.inside, fold(lanes.keys, depth))
    scattered = ~b.is_light if depth < max_bounces else torch.zeros_like(b.is_light)
    zero = torch.zeros_like(lanes.time)
    zero3 = V3(zero, zero, zero)
    bg = zero3
    if sc.use_sky:
        tsky = 0.5 * (rd.y + 1.0)
        bg = V3((1.0 - tsky) + tsky * 0.5, (1.0 - tsky) + tsky * 0.7, (1.0 - tsky) + tsky * 1.0)
    rad = rad + vwhere(~b.hit, beta * bg, zero3)
    rad = rad + vwhere(b.hit & ~(scattered & b.is_specular), beta * b.emitted, zero3)
    cont = b.hit & scattered
    beta = vwhere(cont, beta * b.weight, beta)
    cont = cont & ((beta.x > 0.0) | (beta.y > 0.0) | (beta.z > 0.0))
    return cont, b.p, b.new_rd, b.new_inside, beta, rad


def _chunks(n: int, chunk: int):
    return [(a, min(n, a + chunk)) for a in range(0, n, chunk)]


def paths(sc: Scene, pix, samp, *, width: int, height: int, sq: int, max_bounces: int,
          chunk: int = 1 << 23, keep: bool = False):
    """Whole paths of the samples (pix, samp) ((N,) int64 each), one lane a
    sample, depth by depth over every live lane, `chunk` lanes at a time. A
    lane leaves when its path ends. Returns (radiance (N, 3), rays (N,) int32:
    the bounces each path took, and with `keep` each depth's `Lanes`)."""
    n, dev, dt = pix.shape[0], pix.device, sc.cam.dtype
    parts = []
    for a, b in _chunks(n, chunk):
        ro, rd, time, keys = camera_rays(sc, pix[a:b], samp[a:b], width, height, sq)
        parts.append((ro, rd, time, keys))
    ro = torch.cat([_t(p[0]) for p in parts])
    one = torch.ones_like(ro)
    lanes = Lanes(torch.arange(n, device=dev), ro, torch.cat([_t(p[1]) for p in parts]), one,
                  torch.zeros_like(ro), torch.cat([p[2] for p in parts]),
                  torch.zeros((n,), dtype=torch.int32, device=dev),
                  torch.cat([p[3] for p in parts]))
    del parts, ro, one
    out_rad = torch.zeros((n, 3), dtype=dt, device=dev)
    out_rays = torch.zeros((n,), dtype=torch.int32, device=dev)
    levels, depth = [], 0
    while lanes.idx.numel():
        nxt = []
        for a, b in _chunks(lanes.idx.numel(), chunk):
            part = lanes.part(a, b)
            cont, p, new_rd, new_inside, beta, rad = advance(sc, part, depth, max_bounces)
            rad = _t(rad)
            end = ~cont
            out_rad[part.idx[end]] = rad[end]
            out_rays[part.idx] = depth + 1
            nxt.append(Lanes(part.idx[cont], _t(p)[cont], _t(new_rd)[cont], _t(beta)[cont],
                             rad[cont], part.time[cont], new_inside[cont], part.keys[cont]))
        if keep:
            levels.append(lanes)
        lanes = Lanes(*(torch.cat(f) for f in zip(*nxt)))
        depth += 1
    return out_rad, out_rays, levels


def path_grads(sc_of, levels, cot, *, max_bounces: int, chunk: int = 1 << 22):
    """The gradient of sum(cot[i] . radiance[i]) over the samples `i` with
    respect to the leaves, by the adjoint of the paths kept by `paths(...,
    keep=True)`: depth by depth from the deepest, each depth's bounce traced
    again from its saved entry state under autograd, `chunk` lanes at a time,
    given the cotangent of the state the next depth entered with (the scan's
    adjoint, with the lanes compacted). `sc_of()` packs the tables from
    fresh leaves that require a gradient and returns (scene, leaves).
    Returns {leaf name: gradient}."""
    grads, g_next = {}, None
    for depth in reversed(range(len(levels))):
        lanes = levels[depth]
        g_in = torch.zeros((lanes.idx.numel(), 12), dtype=lanes.ro.dtype, device=lanes.ro.device)
        at = 0  # the first lane of the next depth that this chunk's lanes continue as
        for a, b in _chunks(lanes.idx.numel(), chunk):
            part = lanes.part(a, b)
            with torch.enable_grad():
                sc, leaves = sc_of()
                state = [t.clone().requires_grad_(True) for t in (part.ro, part.rd, part.beta,
                                                                  part.rad)]
                cont, p, new_rd, _, beta, rad = advance(sc, part, depth, max_bounces, *state)
                rad = _t(rad)
                end = ~cont
                outs, gouts = [rad[end]], [cot[part.idx[end]]]
                k = int(cont.sum())
                if k:
                    g = g_next[at:at + k]
                    outs += [_t(p)[cont], _t(new_rd)[cont], _t(beta)[cont], rad[cont]]
                    gouts += [g[:, 0:3], g[:, 3:6], g[:, 6:9], g[:, 9:12]]
                    at += k
                names = list(leaves)
                got = torch.autograd.grad(outs, state + [leaves[n] for n in names], gouts,
                                          allow_unused=True)
            for j, gs in enumerate(got[:4]):
                if gs is not None:
                    g_in[a:b, 3 * j:3 * j + 3] = gs
            for name, gl in zip(names, got[4:]):
                if gl is not None:
                    grads[name] = grads[name] + gl if name in grads else gl
        g_next = g_in
    return grads


def trace(sc: Scene, pix, samp, *, width: int, height: int, sq: int, max_bounces: int):
    """(radiance (N, 3), rays (N,)) of whole paths: `paths` without the
    saved depths."""
    rad, rays, _ = paths(sc, pix, samp, width=width, height=height, sq=sq,
                         max_bounces=max_bounces)
    return rad, rays
