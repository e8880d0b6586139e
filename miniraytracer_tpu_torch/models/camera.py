"""Batched thin-lens + motion-blur camera ray generation (camera.h:38-45),
as `miniraytracer_tpu/models/camera.py`. Componentwise SoA: origins and
directions are V3."""

from __future__ import annotations

from typing import NamedTuple

import torch

from miniraytracer_tpu_torch.ops import rng
from miniraytracer_tpu_torch.ops.vecmath import V3, vnormalize
from miniraytracer_tpu_torch.scene.types import Camera

# camera's RNG sub-key tag (draws: 0,1 lens disk, 2 shutter time)
CAM_FOLD = 0x0C0FFEE


class Rays(NamedTuple):
    ro: V3
    rd: V3
    time: torch.Tensor
    inside: torch.Tensor  # (N,) i32 dielectric nesting depth


def _v3_of(vec) -> V3:
    return V3(vec[0], vec[1], vec[2])


def get_rays(cam: Camera, s, t, keys) -> Rays:
    """Rays for film coordinates (s, t) in [0,1)^2, batched (N,).

    Lens-disk and shutter-time draws come from the ray's counter-based key,
    so results do not depend on schedule."""
    kc = rng.fold(keys, CAM_FOLD)
    u1 = rng.uniform(kc, 0)
    u2 = rng.uniform(kc, 1)
    u3 = rng.uniform(kc, 2)
    rd_disk = rng.sample_in_disk(u1, u2) * cam.lens_radius
    cu = _v3_of(cam.u)
    cv = _v3_of(cam.v)
    offset = cu * rd_disk.x + cv * rd_disk.y
    time = cam.time0 + (cam.time1 - cam.time0) * u3
    origin = _v3_of(cam.origin) + offset
    direction = (
        _v3_of(cam.llcorner)
        + _v3_of(cam.horz) * s
        + _v3_of(cam.vert) * t
        - _v3_of(cam.origin)
        - offset
    )
    return Rays(
        ro=origin,
        rd=vnormalize(direction),
        time=time,
        inside=torch.zeros(s.shape, dtype=torch.int32, device=s.device),
    )
