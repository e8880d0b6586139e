"""Texture sampling: constant / sine-checker / Perlin turbulence / image
(`miniraytracer_tpu/models/textures.py`), batched over per-ray texture ids
and selected by type code.

- checker: sin(s*x)*sin(s*y)*sin(s*z) < 0 -> odd else even (texture.cpp:7-14)
- perlin:  7-octave turbulence of hermite-smoothed gradient noise
  (texture.cpp:68-165), the function the kernels use (`ops/bounce._turbulence`)
- image:   nearest-neighbour, clamped, v-flipped (texture.cpp:207-225)

The hybrid renderer evaluates the material of a winner found outside its step
kernel with these.
"""

from __future__ import annotations

import torch

from miniraytracer_tpu_torch.ops import bounce as B
from miniraytracer_tpu_torch.ops.vecmath import V3, vwhere
from miniraytracer_tpu_torch.scene import types as T


def image_sample(scene: T.SceneData, img_id, h, w, u, v) -> V3:
    """Nearest-neighbour, clamped, v-flipped texel of image `img_id` at (u, v)
    (texture.cpp:207-225). `h`, `w` are the image's true size as float
    tensors (`SceneBuilder.build` keeps them in the texture's c1 row)."""
    hi = h.to(torch.int32)
    wi = w.to(torch.int32)
    i = torch.minimum(torch.clamp_min((u * w).to(torch.int32), 0), wi - 1)
    j = torch.minimum(torch.clamp_min(((1.0 - v) * h).to(torch.int32), 0), hi - 1)
    ih, iw = (int(d) for d in scene.images.shape[1:3])
    flat = img_id.to(torch.int64) * (ih * iw) + j.to(torch.int64) * iw + i.to(torch.int64)
    # lanes of other texture kinds carry h = w = 0 and are selected away by
    # the caller: keep their index inside the atlas
    texels = B.atlas_texels(scene.images)
    return B.texel_rgb(texels[flat.clamp(0, texels.numel() - 1)])


def sample_texture(scene: T.SceneData, tex_id, u, v, p: V3, ptab=None) -> V3:
    """texture::sample for per-ray texture ids (N,) at surface coordinates
    (u, v) and points `p`. `ptab` is the (6, 256) Perlin table of
    `bounce.pack_scene` (built here when the scene needs it and it is not
    given)."""
    tex_id = tex_id.long()
    ttype = scene.tex_type[tex_id]
    c0r, c1r = scene.tex_c0[tex_id], scene.tex_c1[tex_id]
    c0 = V3(c0r[:, 0], c0r[:, 1], c0r[:, 2])
    c1 = V3(c1r[:, 0], c1r[:, 1], c1r[:, 2])
    scale = scene.tex_scale[tex_id]

    out = c0  # TEX_CONST
    sines = torch.sin(scale * p.x) * torch.sin(scale * p.y) * torch.sin(scale * p.z)
    out = vwhere((ttype == T.TEX_CHECKER) & (sines < 0), c1, out)
    if scene.has_perlin:
        if ptab is None:
            ptab = B.perlin_table(scene)
        turb = B._turbulence(ptab, p * scale)
        out = vwhere(ttype == T.TEX_PERLIN, V3(turb, turb, turb), out)
    if scene.has_image:
        img = image_sample(scene, scene.tex_img[tex_id], c1.x, c1.y, u, v)
        out = vwhere(ttype == T.TEX_IMAGE, img, out)
    return out
