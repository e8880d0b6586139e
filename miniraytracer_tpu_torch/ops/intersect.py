"""Hit records of the winning primitive (`miniraytracer_tpu/ops/intersect.py`):
what the hybrid renderer needs between its nearest-hit kernels and its step
kernel. The dense sweeps themselves are the kernels of `ops/flash.py`; this
module rebuilds, for each ray, the record (point, normal, uv, material) of
the sphere or triangle that won.

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
