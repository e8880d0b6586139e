"""Sampling densities: the cosine lobe, the isotropic phase, the light list
(`miniraytracer_tpu/models/pdfs.py`; pdf.h's `value`/`generate` classes in
tensor operations).

The light list (scene.h:19-25) is a loop over its (type, row) pairs: a value
is the average over the list, a direction is generated towards a light
picked uniformly (scene_object.h:65-77). Reference quirks kept, as the JAX
package keeps them: the isotropic density is 1/(2 pi), not 1/(4 pi)
(pdf.h:41-43); a rect light's pdf works for any axis (the reference only
implements xz_rect).
"""

from __future__ import annotations

import torch

from miniraytracer_tpu_torch.ops import intersect as ix
from miniraytracer_tpu_torch.ops import rng
from miniraytracer_tpu_torch.ops.vecmath import (V3, vdot, vnormalize, vonb_from_w, vonb_l2w,
                                                 vsdot, vsqrt, vwhere)
from miniraytracer_tpu_torch.scene import types as T

PI = rng.PI


def cosine_pdf_value(n: V3, d: V3):
    """max(cos, 0)/pi of direction `d` about the normal `n` (pdf.h:24-30)."""
    c = vdot(d, n)
    return torch.where(c > 0, c / PI, 0.0)


def isotropic_pdf_value(d: V3):
    return torch.full_like(d.x, 1.0 / (2.0 * PI))


def _probe(origin: V3, d: V3, time) -> ix.Rays:
    return ix.Rays(ro=origin, rd=d, time=time,
                   inside=torch.zeros(time.shape, dtype=torch.int32, device=time.device))


def _light_sphere_pdf_value(scene: T.SceneData, si, origin: V3, d: V3, time):
    """sphere::pdf_value (sphere.cpp:63-72): one over the solid angle of the
    cone the sphere subtends, where the ray hits it."""
    inf = torch.full_like(time, ix.INF)
    hit = ix.sphere_ts(scene, _probe(origin, d, time), si, 1, ix.TMIN, inf)[0] < ix.INF
    r = scene.sph_radius[si]
    dist_sq = vsdot(ix._sphere_center_static(scene, si, time) - origin)
    cm_arg = torch.clamp(1.0 - r * r / torch.clamp_min(dist_sq, 1e-30), 0.0, 1.0)
    cm_ok = cm_arg > 1e-12
    cos_max = torch.where(cm_ok, vsqrt(torch.where(cm_ok, cm_arg, 1.0)), 0.0)
    solid_angle = 2.0 * PI * (1.0 - cos_max)
    return torch.where(hit & (solid_angle > 0), 1.0 / torch.clamp_min(solid_angle, 1e-12), 0.0)


def _light_rect_pdf_value(scene: T.SceneData, ri, origin: V3, d: V3, time):
    """xz_rect::pdf_value (rect.cpp:92-102), for any axis: dist^2 / (cos *
    area) where the ray hits it. The miss sentinel is squared only where it
    is not one."""
    inf = torch.full_like(time, ix.INF)
    ts = ix.rect_ts(scene, _probe(origin, d, time), ri, 1, ix.TMIN, inf)[0]
    hit = ts < ix.INF
    ts = torch.where(hit, ts, 1.0)
    area = ((scene.rect_i1[ri] - scene.rect_i0[ri])
            * (scene.rect_j1[ri] - scene.rect_j0[ri]))
    sign = scene.rect_sign[ri]
    nrm = V3(scene.rect_ek[ri, 0] * sign, scene.rect_ek[ri, 1] * sign,
             scene.rect_ek[ri, 2] * sign)
    cosine = torch.abs(vdot(d, nrm))
    return torch.where(hit, ts * ts / torch.clamp_min(cosine * area, 1e-12), 0.0)


def light_pdf_value(scene: T.SceneData, origin: V3, d: V3, time):
    """The average pdf over the light list (object_list::pdf_value,
    scene_object.h:65-71)."""
    acc = torch.zeros_like(time)
    for ltype, lidx in scene.lights:
        value = (_light_sphere_pdf_value if ltype == T.PRIM_SPHERE
                 else _light_rect_pdf_value)
        acc = acc + value(scene, lidx, origin, d, time)
    return acc / max(len(scene.lights), 1)


def light_pdf_generate(scene: T.SceneData, origin: V3, time, u_pick, u_a, u_b) -> V3:
    """An unnormalised direction towards a light picked uniformly
    (object_list::pdf_generate, scene_object.h:73-77): a cone sample for a
    sphere, a uniform point for a rect (rect.cpp:104-107)."""
    n_l = max(len(scene.lights), 1)
    pick = torch.clamp((u_pick * n_l).to(torch.int32), 0, n_l - 1)
    zero = torch.zeros_like(time)
    out = V3(zero, zero, zero)
    for li, (ltype, lidx) in enumerate(scene.lights):
        if ltype == T.PRIM_SPHERE:
            to_c = ix._sphere_center_static(scene, lidx, time) - origin
            local = rng.sample_towards_sphere(scene.sph_radius[lidx], vsdot(to_c), u_a, u_b)
            d = vonb_l2w(*vonb_from_w(vnormalize(to_c)), local)
        else:
            ii = scene.rect_i0[lidx] + u_a * (scene.rect_i1[lidx] - scene.rect_i0[lidx])
            jj = scene.rect_j0[lidx] + u_b * (scene.rect_j1[lidx] - scene.rect_j0[lidx])
            e = lambda tab: V3(tab[lidx, 0], tab[lidx, 1], tab[lidx, 2])
            point = e(scene.rect_ei) * ii + e(scene.rect_ej) * jj + e(scene.rect_ek) * scene.rect_k[lidx]
            d = point - origin
        out = vwhere(pick == li, d, out)
    return out
