"""Host-side scene compiler: Python construction API -> SoA SceneData tables.

Mirrors `miniraytracer_tpu/scene/builder.py` for the primitives the fused
class and the hybrid renderer use (spheres, rects, triangles, boxes, volumes,
const/checker/Perlin/image textures). Everything is built
in NumPy on the host, exactly as the JAX package builds it, and becomes
CPU tensors at the end; `SceneData.to(device)` moves it.
"""

from __future__ import annotations

import math

import numpy as np

from miniraytracer_tpu_torch.ops.rng import Pcg32
from miniraytracer_tpu_torch.scene import types as T
from miniraytracer_tpu_torch.scene.types import Camera, SceneData
from miniraytracer_tpu_torch.scene.types import _as_tensor as _t

_F = np.float32


def make_camera(pos, lookat, up, vfov, aspect, aperture, focus_dist, t0, t1) -> Camera:
    """camera.h:16-36 constructor."""
    pos = np.asarray(pos, _F)
    lookat = np.asarray(lookat, _F)
    up = np.asarray(up, _F)
    theta = math.radians(vfov)
    height = 2.0 * math.tan(theta / 2)
    width = aspect * height
    w = pos - lookat
    w = w / np.linalg.norm(w)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    horz = _F(focus_dist * width) * u
    vert = _F(focus_dist * height) * v
    llcorner = pos - 0.5 * horz - 0.5 * vert - _F(focus_dist) * w
    j = lambda a: _t(np.asarray(a, _F))
    return Camera(
        origin=j(pos), u=j(u), v=j(v), w=j(w), llcorner=j(llcorner),
        horz=j(horz), vert=j(vert), lens_radius=j(aperture / 2.0),
        time0=j(t0), time1=j(t1),
    )


def _roty_fwd(deg):
    """Object -> world rotation of rotate_y (scene_object.cpp:85-92):
    x' = c*x + s*z, z' = c*z - s*x."""
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], _F)


class SceneBuilder:
    def __init__(self):
        self.spheres = []  # (c0, c1, t0, t1, radius, moving, mat)
        self.rects = []  # (ei, ej, ek, i0, i1, j0, j1, k, sign, mat)
        self.tris = []  # (m, u, v, mn, un, vn, mat)
        self.sphere_bulk = []  # vectorized blocks: 7 column arrays each
        self.tri_bulk = []  # vectorized blocks: 7 column arrays each
        self.boxes = []  # (lo, hi, (sin, cos), off, mat)
        self.volumes = []  # (btype, bparams[12], density, mat)
        self.materials = []  # (type, tex, param)
        self.textures = []  # (type, c0, c1, scale, img)
        self.images = []  # (H,W,3) float32 arrays in [0,1]
        self.lights = []  # (ptype, idx)
        self.camera = None
        self.use_sky = True
        self.name = "scene"

    # --- textures ---
    def tex_const(self, color):
        self.textures.append((T.TEX_CONST, np.asarray(color, _F), np.zeros(3, _F), 0.0, 0))
        return len(self.textures) - 1

    def tex_checker(self, c_even, c_odd, scale):
        """Sine checker in world space (texture.cpp:7-14)."""
        self.textures.append((T.TEX_CHECKER, np.asarray(c_even, _F), np.asarray(c_odd, _F), float(scale), 0))
        return len(self.textures) - 1

    def tex_perlin(self, scale):
        self.textures.append((T.TEX_PERLIN, np.ones(3, _F), np.zeros(3, _F), float(scale), 0))
        return len(self.textures) - 1

    def tex_image(self, img):
        """Image texture; `img` is (H,W,3) uint8 or float in [0,1]."""
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(_F) / 255.0
        self.images.append(img.astype(_F))
        self.textures.append((T.TEX_IMAGE, np.ones(3, _F), np.zeros(3, _F), 0.0, len(self.images) - 1))
        return len(self.textures) - 1

    # --- materials ---
    def _mat(self, mtype, tex, param):
        self.materials.append((mtype, int(tex), float(param)))
        return len(self.materials) - 1

    def lambertian(self, tex):
        return self._mat(T.MAT_LAMBERTIAN, tex, 0.0)

    def metal(self, tex, gloss):
        return self._mat(T.MAT_METAL, tex, min(float(gloss), 1.0))

    def dielectric(self, ref_index):
        return self._mat(T.MAT_DIELECTRIC, 0, float(ref_index))

    def diffuse_light(self, tex, scale=1.0):
        return self._mat(T.MAT_DIFFUSE_LIGHT, tex, float(scale))

    def isotropic(self, tex):
        return self._mat(T.MAT_ISOTROPIC, tex, 0.0)

    # --- primitives ---
    def sphere(self, center, radius, mat, center1=None, t0=0.0, t1=0.0):
        c0 = np.asarray(center, _F)
        moving = center1 is not None and (t1 - t0) > np.finfo(_F).eps
        c1 = np.asarray(center1, _F) if center1 is not None else c0
        self.spheres.append((c0, c1, _F(t0), _F(t1), _F(radius), _F(1.0 if moving else 0.0), int(mat)))
        return (T.PRIM_SPHERE, len(self.spheres) - 1)

    def spheres_bulk(self, centers, radii, mats, centers1=None, t0=0.0, t1=0.0):
        """Many spheres at once: centers (n,3), radii (n,), mats one handle
        or (n,). The way to build scenes of thousands of spheres (the
        reference's random_scene scaling table, scene.cpp:109-113). Bulk
        spheres come after all per-call spheres at build() and cannot be
        light handles."""
        c0 = np.asarray(centers, _F).reshape(-1, 3)
        n = c0.shape[0]
        r = np.broadcast_to(np.asarray(radii, _F), (n,)).copy()
        moving = centers1 is not None and (t1 - t0) > np.finfo(_F).eps
        c1 = np.asarray(centers1, _F).reshape(-1, 3) if centers1 is not None else c0
        m = np.broadcast_to(np.asarray(mats, np.int32), (n,)).copy()
        self.sphere_bulk.append((c0, c1, np.full(n, t0, _F), np.full(n, t1, _F), r,
                                 np.full(n, 1.0 if moving else 0.0, _F), m))

    def _rect(self, iax, jax_, kax, i0, i1, j0, j1, k, mat):
        sign = 1.0
        if i0 > i1:
            sign, i0, i1 = -sign, i1, i0
        if j0 > j1:
            sign, j0, j1 = -sign, j1, j0
        e = np.eye(3, dtype=_F)
        self.rects.append((e[iax], e[jax_], e[kax], _F(i0), _F(i1), _F(j0), _F(j1), _F(k), _F(sign), int(mat)))
        return (T.PRIM_RECT, len(self.rects) - 1)

    def xy_rect(self, x0, x1, y0, y1, z, mat):
        return self._rect(0, 1, 2, x0, x1, y0, y1, z, mat)

    def xz_rect(self, x0, x1, z0, z1, y, mat):
        return self._rect(0, 2, 1, x0, x1, z0, z1, y, mat)

    def yz_rect(self, y0, y1, z0, z1, x, mat):
        return self._rect(1, 2, 0, y0, y1, z0, z1, x, mat)

    def triangle(self, a, b, c, mat, an=None, bn=None, cn=None):
        """Edge-form storage (triangle.cpp ctor): m=a, u=b-a, v=c-a; flat
        geometric normal when vertex normals are absent."""
        a, b, c = (np.asarray(x, _F) for x in (a, b, c))
        u, v = b - a, c - a
        if an is None:
            n = np.cross(u, v)
            ln = np.linalg.norm(n)
            n = n / ln if ln > 0 else n
            an = bn = cn = n
        self.tris.append((a, u, v, np.asarray(an, _F), np.asarray(bn, _F), np.asarray(cn, _F), int(mat)))
        return (T.PRIM_TRI, len(self.tris) - 1)

    def triangles_bulk(self, a, b, c, mats, an=None, bn=None, cn=None):
        """Many triangles at once: vertices a, b, c (n,3), mats one handle or
        (n,), optional vertex normals (n,3) each (else the flat geometric
        normal). The way to build meshes of thousands of triangles. Bulk
        triangles come after all per-call triangles at build() and cannot be
        light handles."""
        a, b, c = (np.asarray(x, _F).reshape(-1, 3) for x in (a, b, c))
        n = a.shape[0]
        u, v = b - a, c - a
        if an is None:
            nrm = np.cross(u, v)
            ln = np.linalg.norm(nrm, axis=1, keepdims=True)
            nrm = np.where(ln > 0, nrm / np.maximum(ln, 1e-30), nrm)
            an = bn = cn = nrm
        an, bn, cn = (np.asarray(x, _F).reshape(-1, 3) for x in (an, bn, cn))
        m = np.broadcast_to(np.asarray(mats, np.int32), (n,)).copy()
        self.tri_bulk.append((a, u, v, an, bn, cn, m))

    def box(self, bmin, bmax, mat, rot_y_deg=0.0, offset=(0, 0, 0)):
        """Box as ONE primitive (box.h: 6 outward one-sided rects) with the
        rotate_y + translate wrappers baked as (sin, cos, offset)."""
        r = math.radians(rot_y_deg)
        self.boxes.append((np.asarray(bmin, _F), np.asarray(bmax, _F),
                           np.array([math.sin(r), math.cos(r)], _F),
                           np.asarray(offset, _F), mat))
        return (T.PRIM_BOX, len(self.boxes) - 1)

    def box_tris(self, bmin, bmax, mat, rot_y_deg=0.0, offset=(0, 0, 0)):
        """The same box as 12 outward-wound triangles (the JAX package keeps
        this form as the box primitive's equivalence oracle; a triangle
        admits a ray inside a medium through its back face, where the rect
        decomposition never does)."""
        bmin, bmax = np.asarray(bmin, _F), np.asarray(bmax, _F)
        (x0, y0, z0), (x1, y1, z1) = bmin, bmax
        R = _roty_fwd(rot_y_deg)
        off = np.asarray(offset, _F)
        corner = {(i, j, k): R @ np.asarray([x1 if i else x0, y1 if j else y0, z1 if k else z0],
                                            _F) + off
                  for i in (0, 1) for j in (0, 1) for k in (0, 1)}
        # faces as quads (a, b, c, d), cross(b - a, d - a) outward
        quads = [
            ((0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)),  # +z
            ((1, 0, 0), (0, 0, 0), (0, 1, 0), (1, 1, 0)),  # -z
            ((0, 1, 1), (1, 1, 1), (1, 1, 0), (0, 1, 0)),  # +y
            ((0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)),  # -y
            ((1, 0, 1), (1, 0, 0), (1, 1, 0), (1, 1, 1)),  # +x
            ((0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)),  # -x
        ]
        for qa, qb, qc, qd in quads:
            self.triangle(corner[qa], corner[qb], corner[qc], mat)
            self.triangle(corner[qa], corner[qc], corner[qd], mat)
        return (T.PRIM_TRI, len(self.tris) - 1)

    def volume_sphere(self, center, radius, density, albedo_tex):
        mat = self.isotropic(albedo_tex)
        p = np.zeros(12, _F)
        p[0:3] = np.asarray(center, _F)
        p[3] = radius
        self.volumes.append((T.VOLB_SPHERE, p, _F(density), mat))
        return (T.PRIM_VOLUME, len(self.volumes) - 1)

    def volume_box(self, bmin, bmax, density, albedo_tex, rot_y_deg=0.0, offset=(0, 0, 0)):
        mat = self.isotropic(albedo_tex)
        r = math.radians(rot_y_deg)
        p = np.zeros(12, _F)
        p[0:3] = np.asarray(bmin, _F)
        p[3:6] = np.asarray(bmax, _F)
        p[6] = math.sin(r)
        p[7] = math.cos(r)
        p[8:11] = np.asarray(offset, _F)
        self.volumes.append((T.VOLB_BOX, p, _F(density), mat))
        return (T.PRIM_VOLUME, len(self.volumes) - 1)

    def add_light(self, handle):
        """Register a primitive for importance sampling (the reference's
        'biased_objects' list, scene.h:19-25)."""
        self.lights.append(handle)

    def set_camera(self, *args, **kw):
        self.camera = make_camera(*args, **kw)

    # --- build ---
    def build(self) -> SceneData:
        if self.camera is None:
            raise ValueError("set_camera() before build()")
        if not self.materials:
            self._mat(T.MAT_LAMBERTIAN, self.tex_const([0.5, 0.5, 0.5]), 0.0)
        if not self.textures:
            self.tex_const([0.5, 0.5, 0.5])

        def pack(rows, shapes_dtypes, pad_row):
            """Stack list-of-tuples into column arrays, padding to >=1 row;
            returns columns + active mask."""
            n = len(rows)
            use = rows if rows else [pad_row]
            cols = list(zip(*use))
            arrs = []
            for col, (shape, dt) in zip(cols, shapes_dtypes):
                arrs.append(np.stack([np.asarray(x, dt).reshape(shape) for x in col]))
            active = np.zeros(max(n, 1), bool)
            active[:n] = True
            return arrs, active

        def merge_bulk(cols, active, any_per_call, blocks):
            """Per-call rows, then the bulk blocks in order (the pad row of
            an empty per-call list dropped); every row active."""
            if not blocks:
                return cols, active
            cols = [c if any_per_call else c[:0] for c in cols]
            merged = [np.concatenate([c] + [np.asarray(blk[k], c.dtype) for blk in blocks])
                      for k, c in enumerate(cols)]
            return merged, np.ones(merged[0].shape[0], bool)

        v3 = ((3,), _F)
        s_ = ((), _F)
        i_ = ((), np.int32)

        (sc0, sc1, st0, st1, srad, smov, smat), sact = pack(
            self.spheres, [v3, v3, s_, s_, s_, s_, i_],
            (np.zeros(3), np.zeros(3), 0, 0, 0, 0, 0),
        )
        (rei, rej, rek, ri0, ri1, rj0, rj1, rk, rsg, rmat), ract = pack(
            self.rects, [v3, v3, v3, s_, s_, s_, s_, s_, s_, i_],
            (np.eye(3)[0], np.eye(3)[1], np.eye(3)[2], 0, -1, 0, -1, 0, 1, 0),
        )
        (sc0, sc1, st0, st1, srad, smov, smat), sact = merge_bulk(
            (sc0, sc1, st0, st1, srad, smov, smat), sact, bool(self.spheres), self.sphere_bulk)
        (tm, tu, tv, tmn, tun, tvn, tmat), tact = pack(
            self.tris, [v3, v3, v3, v3, v3, v3, i_],
            (np.zeros(3), np.zeros(3), np.zeros(3), np.zeros(3), np.zeros(3), np.zeros(3), 0),
        )
        (tm, tu, tv, tmn, tun, tvn, tmat), tact = merge_bulk(
            (tm, tu, tv, tmn, tun, tvn, tmat), tact, bool(self.tris), self.tri_bulk)
        (blo, bhi, bcs, boff, bmat), bact = pack(
            self.boxes, [v3, v3, ((2,), _F), v3, i_],
            (np.zeros(3), np.full(3, -1.0), np.array([0.0, 1.0]),
             np.zeros(3), 0),
        )
        (vbt, vbp, vden, vmat), vact = pack(
            self.volumes, [i_, ((12,), _F), s_, i_],
            (0, np.zeros(12), 1.0, 0),
        )
        (mt, mtex, mpar), _ = pack(self.materials, [i_, i_, s_], (0, 0, 0))
        (xt, xc0, xc1, xsc, ximg), _ = pack(self.textures, [i_, v3, v3, s_, i_], (0, np.zeros(3), np.zeros(3), 0, 0))

        # image atlas: one (IH, IW) plane per image, padded to the largest,
        # texels packed 0x00RRGGBB; each image's true (h, w) rides in the
        # otherwise unused tex_c1 row of its texture
        if self.images:
            hh = max(im.shape[0] for im in self.images)
            ww = max(im.shape[1] for im in self.images)
            ims = np.zeros((len(self.images), hh, ww), np.uint32)
            for i, im in enumerate(self.images):
                q = np.clip(np.rint(im * 255.0), 0, 255).astype(np.uint32)
                ims[i, : im.shape[0], : im.shape[1]] = (
                    (q[..., 0] << 16) | (q[..., 1] << 8) | q[..., 2])
        else:
            ims = np.zeros((1, 1, 1), np.uint32)
        for xi, t in enumerate(self.textures):
            if t[0] == T.TEX_IMAGE:
                h, w = self.images[t[4]].shape[:2]
                xc1[xi] = np.array([h, w, 0], _F)

        pv, px, py, pz = perlin_tables()

        return SceneData(
            sph_c0=_t(sc0), sph_c1=_t(sc1), sph_t0=_t(st0), sph_t1=_t(st1),
            sph_radius=_t(srad), sph_moving=_t(smov), sph_mat=_t(smat),
            sph_active=_t(sact),
            rect_ei=_t(rei), rect_ej=_t(rej), rect_ek=_t(rek),
            rect_i0=_t(ri0), rect_i1=_t(ri1), rect_j0=_t(rj0),
            rect_j1=_t(rj1), rect_k=_t(rk), rect_sign=_t(rsg),
            rect_mat=_t(rmat), rect_active=_t(ract),
            tri_m=_t(tm), tri_u=_t(tu), tri_v=_t(tv), tri_mn=_t(tmn),
            tri_un=_t(tun), tri_vn=_t(tvn), tri_mat=_t(tmat),
            tri_active=_t(tact),
            box_lo=_t(blo), box_hi=_t(bhi), box_cs=_t(bcs), box_off=_t(boff),
            box_mat=_t(bmat), box_active=_t(bact),
            vol_btype=_t(vbt), vol_bparams=_t(vbp), vol_density=_t(vden),
            vol_mat=_t(vmat), vol_active=_t(vact),
            mat_type=_t(mt), mat_tex=_t(mtex), mat_param=_t(mpar),
            tex_type=_t(xt), tex_c0=_t(xc0), tex_c1=_t(xc1),
            tex_scale=_t(xsc), tex_img=_t(ximg),
            images=_t(ims),
            perlin_vec=_t(pv), perlin_px=_t(px), perlin_py=_t(py),
            perlin_pz=_t(pz),
            camera=self.camera,
            use_sky=self.use_sky,
            lights=tuple((int(t), int(i)) for t, i in self.lights),
            name=self.name,
            has_perlin=any(t[0] == T.TEX_PERLIN for t in self.textures),
            has_image=any(t[0] == T.TEX_IMAGE for t in self.textures),
            has_boxes=bool(self.boxes),
        )


def perlin_tables():
    """Replicate the reference's pre-main Perlin init (texture.cpp:167-203):
    256 gradient vectors from the raw static G_rng stream (pcg.cpp:40), then
    three Fisher-Yates permutations drawn from the same stream, in order.
    Returns numpy arrays (vec (256,3) f32, px, py, pz (256,) i32)."""
    g = Pcg32(11350390909718046443, 6305599193148252115, raw=True)
    ranvec = np.array([g.in_ball() for _ in range(256)], _F)
    perms = []
    for _ in range(3):
        p = np.arange(256)
        for i in range(255, 0, -1):
            target = int(g.randf() * (i + 1))
            p[i], p[target] = p[target], p[i]
        perms.append(p.astype(np.int32))
    return ranvec, perms[0], perms[1], perms[2]
