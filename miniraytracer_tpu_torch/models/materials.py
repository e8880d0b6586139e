"""Material shading in tensor operations (`miniraytracer_tpu/models/
materials.py`): all five behaviours evaluated for every lane and selected by
type code, in place of material.h's virtual dispatch.

- lambertian: cosine-lobe sample in the normal's basis, scattering pdf
  max(cos, 0)/pi (material.h:34-56);
- isotropic: uniform direction, scattering pdf 1/(2 pi) (material.h:58-77;
  the reference's 2 pi is kept);
- metal: reflection plus (1 - gloss) times a point in the unit ball; the
  attenuation is the albedo; specular (material.h:81-99);
- dielectric: Schlick's Fresnel with cosT for an entering ray, the nested
  medium counter, total internal reflection always reflects
  (material.h:103-176);
- diffuse_light: no scatter; one-sided emission where dot(n, dir) < 0
  (material.h:180-201).

A scene with lights mixes the material's sample 50/50 with a sample towards
the light list (main.cpp:87-92, pdf.h:64-80). The masked branches keep the
JAX package's eps guards, so no lane divides by zero whatever branch it takes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from miniraytracer_tpu_torch.models import pdfs
from miniraytracer_tpu_torch.models.textures import sample_texture
from miniraytracer_tpu_torch.ops import intersect as ix
from miniraytracer_tpu_torch.ops import rng
from miniraytracer_tpu_torch.ops.bounce import fresnel_schlick  # material.h:106-110
from miniraytracer_tpu_torch.ops.intersect import HitRecord, Rays
from miniraytracer_tpu_torch.ops.vecmath import (V3, vdot, vnormalize, vonb_from_w, vonb_l2w,
                                                 vreflect, vrefract, vsqrt, vwhere)
from miniraytracer_tpu_torch.scene import types as T

PI = rng.PI

# RNG slots: the draw numbers of one bounce under its key
SLOT_VOL = 0  # 0..3: the free path of each volume
SLOT_MIX = 8  # light or material sample (pdf.h:71-79)
SLOT_LPICK = 9  # which light
SLOT_LA, SLOT_LB = 10, 11  # the point on the light
SLOT_MA, SLOT_MB = 12, 13  # the material's direction
SLOT_FUZZ = 14  # 14..16: the metal's fuzz
SLOT_FRESNEL = 17  # the dielectric's reflect-or-refract


class Scatter(NamedTuple):
    new_rd: V3  # unit direction of the next ray
    new_inside: torch.Tensor  # (N,) i32
    weight: V3  # throughput factor of this bounce
    emitted: V3  # emission to add
    scattered: torch.Tensor  # (N,) bool: the path goes on
    add_emitted: torch.Tensor  # (N,) bool: the specular branch drops emission


def shade(scene: T.SceneData, rays: Rays, rec: HitRecord, keys, depth_ok, accel=None,
          plain=False) -> Scatter:
    """One shading event for every lane, as if each had hit (the caller
    masks misses). `keys` are the per-bounce keys, `depth_ok` the depth <
    max_bounces gate (main.cpp:79). `accel` and `plain` reach the texture
    (`sample_texture`)."""
    mat = rec.mat.long()
    mtype, tex_id = scene.mat_type[mat], scene.mat_tex[mat]
    mparam = ix.gather(scene.mat_param, mat)  # a train leaf: index_select's gradient
    albedo = sample_texture(scene, tex_id, rec.u, rec.v, rec.p, accel=accel, plain=plain)
    n, rd = rec.n, rays.rd
    zero = torch.zeros_like(rec.t)
    zero3 = V3(zero, zero, zero)

    # emission (diffuse_light, one-sided)
    is_light = mtype == T.MAT_DIFFUSE_LIGHT
    emitted = vwhere(is_light & (vdot(n, rd) < 0.0), albedo * mparam, zero3)

    # diffuse branch (lambertian, isotropic)
    is_iso = mtype == T.MAT_ISOTROPIC
    u_ma, u_mb = rng.uniform2(keys, SLOT_MA)
    cos_sampler = (rng.sample_cosine_direction_exact if scene.exact_cosine
                   else rng.sample_cosine_direction)
    cos_dir = vonb_l2w(*vonb_from_w(n), cos_sampler(u_ma, u_mb))
    mat_gen = vwhere(is_iso, rng.sample_on_sphere(u_ma, u_mb), cos_dir)

    def mat_pdf(d):
        return torch.where(is_iso, pdfs.isotropic_pdf_value(d), pdfs.cosine_pdf_value(n, d))

    if scene.lights:
        light_gen = pdfs.light_pdf_generate(
            scene, rec.p, rays.time, *rng.uniform3(keys, SLOT_LPICK))
        d = vnormalize(vwhere(rng.uniform(keys, SLOT_MIX) < 0.5, light_gen, mat_gen))
        pdf_v = 0.5 * pdfs.light_pdf_value(scene, rec.p, d, rays.time) + 0.5 * mat_pdf(d)
    else:
        d = vnormalize(mat_gen)
        pdf_v = mat_pdf(d)
    scatter_pdf = torch.where(is_iso, 1.0 / (2.0 * PI), torch.clamp_min(vdot(n, d), 0.0) / PI)
    # eps, not > 0: a denormal pdf makes a firefly; the sample gives nothing
    pdf_ok = pdf_v > 1e-12
    diffuse_w = albedo * torch.where(
        pdf_ok, scatter_pdf / torch.where(pdf_ok, pdf_v, 1.0), 0.0)

    # metal
    is_metal = mtype == T.MAT_METAL
    refl = vreflect(rd, n)
    fuzz = rng.sample_in_ball(*rng.uniform3(keys, SLOT_FUZZ))
    metal_dir = vnormalize(refl + fuzz * (1.0 - mparam))

    # dielectric (material.h:121-176); other rows carry mat_param 0, so the
    # index is taken as 1.5 there
    is_diel = mtype == T.MAT_DIELECTRIC
    ref_idx = torch.where(is_diel, mparam, 1.5)
    cos_i = -vdot(rd, n)
    entering = cos_i >= 0
    ni_over_nt = torch.where(entering, 1.0 / ref_idx, ref_idx)
    refracted, can_refract = vrefract(rd, vwhere(entering, n, -n), ni_over_nt)
    cs_arg = torch.clamp(1.0 - ni_over_nt * ni_over_nt * (1.0 - cos_i * cos_i), 0.0, 1.0)
    cs_ok = cs_arg > 1e-12
    cos_schlick = torch.where(
        entering, cos_i, torch.where(cs_ok, vsqrt(torch.where(cs_ok, cs_arg, 1.0)), 0.0))
    reflect_prob = torch.where(can_refract, fresnel_schlick(cos_schlick, ref_idx), 1.0)
    do_reflect = rng.uniform(keys, SLOT_FRESNEL) < reflect_prob
    diel_dir = vwhere(do_reflect, vnormalize(refl), vnormalize(refracted))
    # the nested-medium counter (material.h:158-173); a reflection keeps it
    inside_after = torch.where(entering, rays.inside + 1, torch.clamp_min(rays.inside - 1, 0))
    diel_inside = torch.where(do_reflect, rays.inside, inside_after)

    is_specular = is_metal | is_diel
    ones3 = V3(zero + 1.0, zero + 1.0, zero + 1.0)
    scattered = depth_ok & ~is_light  # lights never scatter (material.h:195)
    return Scatter(
        new_rd=vwhere(is_metal, metal_dir, vwhere(is_diel, diel_dir, d)),
        # metal and diffuse rays leave the medium (the ray constructor's default)
        new_inside=torch.where(is_diel, diel_inside, torch.zeros_like(rays.inside)),
        weight=vwhere(is_diel, ones3, vwhere(is_specular, albedo, diffuse_w)),
        emitted=emitted,
        scattered=scattered,
        # the specular branch drops emission (main.cpp:81-83)
        add_emitted=~(scattered & is_specular),
    )
