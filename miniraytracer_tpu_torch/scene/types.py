"""Scene data model of the port: structure-of-arrays tables as dataclasses of
tensors, with the field names, type codes and static metadata of
`miniraytracer_tpu/scene/types.py`.

A scene lives on one device; `.to(device)` returns a copy on another. The
renderer runs where the scene's tensors are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# material type codes (material.h class hierarchy -> integer tags)
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4

# texture type codes (texture.h)
TEX_CONST = 0
TEX_CHECKER = 1
TEX_PERLIN = 2
TEX_IMAGE = 3

# primitive type codes for hit records / light references
PRIM_SPHERE = 0
PRIM_RECT = 1
PRIM_TRI = 2
PRIM_VOLUME = 3
PRIM_BOX = 4

# volume boundary type codes
VOLB_SPHERE = 0
VOLB_BOX = 1  # rotate_y + translate baked (scene_object.cpp:9-98)


def _tensor_fields(obj):
    return [f.name for f in dataclasses.fields(obj)
            if not f.metadata.get("static")]


def _meta(**kw):
    return dataclasses.field(metadata=dict(static=True), **kw)


@dataclasses.dataclass
class Camera:
    """Thin-lens, motion-blur camera (camera.h:6-46), precomputed basis."""

    origin: torch.Tensor  # (3,)
    u: torch.Tensor  # (3,)
    v: torch.Tensor  # (3,)
    w: torch.Tensor  # (3,)
    llcorner: torch.Tensor  # (3,)
    horz: torch.Tensor  # (3,)
    vert: torch.Tensor  # (3,)
    lens_radius: torch.Tensor  # ()
    time0: torch.Tensor  # ()
    time1: torch.Tensor  # ()

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in _tensor_fields(self)})


@dataclasses.dataclass
class SceneData:
    # --- spheres (sphere.h) ---
    sph_c0: torch.Tensor  # (S,3) center at time0
    sph_c1: torch.Tensor  # (S,3) center at time1
    sph_t0: torch.Tensor  # (S,)
    sph_t1: torch.Tensor  # (S,)
    sph_radius: torch.Tensor  # (S,) negative = hollow shell (sphere.cpp:50)
    sph_moving: torch.Tensor  # (S,) f32 0/1
    sph_mat: torch.Tensor  # (S,) i32
    sph_active: torch.Tensor  # (S,) bool

    # --- axis-aligned one-sided rects (rect.h) ---
    rect_ei: torch.Tensor  # (R,3) first free-axis unit vector
    rect_ej: torch.Tensor  # (R,3) second free-axis unit vector
    rect_ek: torch.Tensor  # (R,3) fixed-axis unit vector
    rect_i0: torch.Tensor  # (R,)
    rect_i1: torch.Tensor  # (R,)
    rect_j0: torch.Tensor  # (R,)
    rect_j1: torch.Tensor  # (R,)
    rect_k: torch.Tensor  # (R,) plane offset along ek
    rect_sign: torch.Tensor  # (R,) normal = sign * ek (rect.cpp:6-22)
    rect_mat: torch.Tensor  # (R,) i32
    rect_active: torch.Tensor  # (R,) bool

    # --- triangles, edge form (triangle.h:13-42) ---
    tri_m: torch.Tensor  # (T,3) vertex a
    tri_u: torch.Tensor  # (T,3) b - a
    tri_v: torch.Tensor  # (T,3) c - a
    tri_mn: torch.Tensor  # (T,3) normal at a
    tri_un: torch.Tensor  # (T,3) normal at b
    tri_vn: torch.Tensor  # (T,3) normal at c
    tri_mat: torch.Tensor  # (T,) i32
    tri_active: torch.Tensor  # (T,) bool

    # --- boxes (box.h: 6 outward one-sided rects as ONE primitive, the
    # rotate_y + translate wrappers baked) ---
    box_lo: torch.Tensor  # (B,3) local-frame min corner
    box_hi: torch.Tensor  # (B,3) local-frame max corner
    box_cs: torch.Tensor  # (B,2) (sin, cos) of the baked rotate_y
    box_off: torch.Tensor  # (B,3) baked translate
    box_mat: torch.Tensor  # (B,) i32
    box_active: torch.Tensor  # (B,) bool

    # --- constant-density volumes (volumes.h) ---
    vol_btype: torch.Tensor  # (V,) i32 VOLB_*
    vol_bparams: torch.Tensor  # (V,12) sphere: c(3),r | box: bmin(3),bmax(3),sin,cos,offset(3)
    vol_density: torch.Tensor  # (V,)
    vol_mat: torch.Tensor  # (V,) i32 (isotropic phase material)
    vol_active: torch.Tensor  # (V,) bool

    # --- materials (material.h) ---
    mat_type: torch.Tensor  # (M,) i32 MAT_*
    mat_tex: torch.Tensor  # (M,) i32 albedo/emissive texture id
    mat_param: torch.Tensor  # (M,) gloss | ref_index | emit scale

    # --- textures (texture.h) ---
    tex_type: torch.Tensor  # (X,) i32 TEX_*
    tex_c0: torch.Tensor  # (X,3) const color / checker even
    tex_c1: torch.Tensor  # (X,3) checker odd
    tex_scale: torch.Tensor  # (X,) checker/perlin scale
    tex_img: torch.Tensor  # (X,) i32 image id

    # --- image atlas, packed 0x00RRGGBB per texel ---
    images: torch.Tensor  # (I,IH,IW) u32

    # --- Perlin tables (texture.cpp:107-203) ---
    perlin_vec: torch.Tensor  # (256,3)
    perlin_px: torch.Tensor  # (256,) i32
    perlin_py: torch.Tensor  # (256,) i32
    perlin_pz: torch.Tensor  # (256,) i32

    camera: Camera

    # --- static metadata (same meaning as in the JAX package) ---
    use_sky: bool = _meta(default=True)
    lights: tuple = _meta(default=())
    name: str = _meta(default="scene")
    has_perlin: bool = _meta(default=False)
    has_image: bool = _meta(default=False)
    has_boxes: bool = _meta(default=False)
    exact_cosine: bool = _meta(default=False)
    fast_perlin: bool = _meta(default=False)

    @property
    def device(self) -> torch.device:
        return self.sph_radius.device

    def to(self, device) -> "SceneData":
        """Copy of the scene with every table on `device`."""
        moved = {k: getattr(self, k).to(device)
                 for k in _tensor_fields(self) if k != "camera"}
        return dataclasses.replace(self, camera=self.camera.to(device),
                                   **moved)

    @property
    def n_spheres(self):
        return self.sph_radius.shape[0]

    @property
    def n_rects(self):
        return self.rect_k.shape[0]

    @property
    def n_tris(self):
        return self.tri_m.shape[0]

    @property
    def n_volumes(self):
        return self.vol_density.shape[0]

    @property
    def n_boxes(self):
        return self.box_mat.shape[0]


def _as_tensor(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).copy())


def from_numpy(fields: dict) -> SceneData:
    """SceneData from a dict of the JAX scene's leaves as numpy arrays.

    `fields` maps every SceneData field name to its value: numpy arrays for
    the tables, a dict of numpy arrays for "camera", and plain Python values
    for the static metadata. This is how a scene built by the JAX package
    is carried into the port.
    """
    cam = fields["camera"]
    camera = Camera(**{k: _as_tensor(cam[k])
                       for k in (f.name for f in dataclasses.fields(Camera))})
    kw = {}
    for f in dataclasses.fields(SceneData):
        if f.name == "camera":
            continue
        v = fields[f.name]
        if f.metadata.get("static"):
            kw[f.name] = (tuple(tuple(int(x) for x in e) for e in v)
                          if f.name == "lights" else v)
        else:
            kw[f.name] = _as_tensor(v)
    return SceneData(camera=camera, **kw)
