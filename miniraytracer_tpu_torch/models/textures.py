"""Texture sampling: constant / sine-checker / Perlin turbulence / image
(`miniraytracer_tpu/models/textures.py`), batched over per-ray texture ids
and selected by type code.

- checker: sin(s*x)*sin(s*y)*sin(s*z) < 0 -> odd else even (texture.cpp:7-14)
- perlin:  7-octave turbulence of hermite-smoothed gradient noise
  (texture.cpp:68-165) from the scene's permutation and gradient tables
  (`ops/noise.py`), or, for a scene with `fast_perlin`, from gradients hashed
  from the lattice cell (`_hash_gradient`)
- image:   nearest-neighbour, clamped, v-flipped (texture.cpp:207-225)
"""

from __future__ import annotations

import torch

from miniraytracer_tpu_torch.ops import bounce as B
from miniraytracer_tpu_torch.ops import noise, rng
from miniraytracer_tpu_torch.ops.vecmath import V3, vwhere
from miniraytracer_tpu_torch.scene import types as T


def _hash_gradient(ix, iy, iz) -> V3:
    """Table-free lattice gradient: the cell (i, j, k), 256-periodic like the
    reference's `& 255`, hashed to a point in the unit ball (in-ball like the
    reference's gradients, texture.cpp:168-170). The same construction as the
    tables (a random gradient per lattice point), another realisation."""
    h = rng.pcg_hash(rng._mul32((ix & 255).long(), 0x8DA6B343)
                     ^ rng._mul32((iy & 255).long(), 0xD8163841)
                     ^ rng._mul32((iz & 255).long(), 0xCB1AB31F))
    h2 = rng.pcg_hash(h)
    to_unit = lambda b: b.to(torch.float32) * (1.0 / 65536.0)
    return rng.sample_in_ball(to_unit(h & 0xFFFF), to_unit(h >> 16), to_unit(h2 & 0xFFFF))


def _perlin_noise_fast(p: V3):
    """`perlin_noise` with hash gradients (see `_hash_gradient`)."""
    (ix, fx, hx), (iy, fy, hy), (iz, fz, hz) = (noise._lattice(c) for c in p)
    acc = torch.zeros_like(p.x)
    for di in (0, 1):
        ax, wx = (hx if di else 1.0 - hx), fx - di
        for dj in (0, 1):
            ay, wy = (hy if dj else 1.0 - hy), fy - dj
            for dk in (0, 1):
                az, wz = (hz if dk else 1.0 - hz), fz - dk
                g = _hash_gradient(ix + di, iy + dj, iz + dk)
                acc = acc + ax * ay * az * (g.x * wx + g.y * wy + g.z * wz)
    return acc


def perlin_noise(scene: T.SceneData, p: V3):
    """One octave of gradient noise at points `p` (texture.cpp:118-152)."""
    if scene.fast_perlin:
        return _perlin_noise_fast(p)
    return noise.perlin_noise(noise.noise_tables(scene), p)


def perlin_turbulence(scene: T.SceneData, p: V3, depth: int = noise.PERLIN_DEPTH):
    """|sum_i 0.5^i noise(2^i p)| over `depth` octaves (texture.cpp:155-165)."""
    if scene.fast_perlin:
        return noise.turbulence(_perlin_noise_fast, p, depth)
    ptab = noise.noise_tables(scene)
    return noise.turbulence(lambda q: noise.perlin_noise(ptab, q), p, depth)


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


def sample_texture(scene: T.SceneData, tex_id, u, v, p: V3, ptab=None, accel=None,
                   plain=False) -> V3:
    """texture::sample for per-ray texture ids (N,) at surface coordinates
    (u, v) and points `p`.

    Turbulence (scenes with Perlin noise and without `fast_perlin`) goes to
    kernel B6 (`noise.flash_turbulence`) when `accel` (`intersect.make_accel`)
    has its "perlin" tables, to B6's plain version with `plain`, and
    otherwise to the plain version over `ptab`, the (6, 256) tables (built
    here when not given)."""
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
        ps = p * scale
        if scene.fast_perlin:
            turb = perlin_turbulence(scene, ps)
        elif accel and "perlin" in accel:
            turb = (noise.flash_turbulence_plain if plain
                    else noise.flash_turbulence)(accel["perlin"], ps)
        else:
            turb = noise.flash_turbulence_plain(
                noise.noise_tables(scene) if ptab is None else ptab, ps)
        out = vwhere(ttype == T.TEX_PERLIN, V3(turb, turb, turb), out)
    if scene.has_image:
        img = image_sample(scene, scene.tex_img[tex_id], c1.x, c1.y, u, v)
        out = vwhere(ttype == T.TEX_IMAGE, img, out)
    return out
