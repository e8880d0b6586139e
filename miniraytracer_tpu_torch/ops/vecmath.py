"""Vector math core of the port: a structure-of-arrays 3-vector over tensors.

Mirrors `miniraytracer_tpu/ops/vecmath.py` (V3, dot, cross, safe normalize,
select, reflect, refract, luminance, orthonormal basis). x/y/z stay three
separate (N,) tensors so every op is elementwise; the (..., 3) form exists
only at host boundaries (framebuffers, scene tables).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    @property
    def arr(self) -> torch.Tensor:
        """(..., 3) tensor form (host/frame boundary only)."""
        return torch.stack([self.x, self.y, self.z], dim=-1)


def vsqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device, as IEEE sqrtf,
    XLA and the CUDA kernels give it. torch's vectorised CPU float32 sqrt
    is one ulp off for ~0.6% of inputs, which moves the hits on large
    spheres (t is sqrt of a small difference of squares near 1e6)."""
    return torch.sqrt(x.double()).to(x.dtype)


def vdot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def vcross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def vnormalize(a: V3) -> V3:
    """Safe normalize: vectors with squared length <= 1e-20 become zero."""
    n2 = vdot(a, a)
    ok = n2 > 1e-20
    inv = torch.where(ok, 1.0 / vsqrt(torch.where(ok, n2, 1.0)), 0.0)
    return a * inv


def vwhere(mask, a: V3, b: V3) -> V3:
    """Componentwise select with an (N,)-shaped mask."""
    return V3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def vsdot(a: V3):
    """Squared length."""
    return a.x * a.x + a.y * a.y + a.z * a.z


def vlength(a: V3):
    return vsqrt(vsdot(a))


def vreflect(v: V3, n: V3) -> V3:
    """v - 2*dot(v,n)*n (vec3.h:178-181)."""
    return v - n * (2.0 * vdot(v, n))


def vrefract(v: V3, n: V3, ni_over_nt):
    """Snell refraction (vec3.h:185-198) -> (refracted, ok). Where sinT2 is
    within 1e-9 of 1 (or beyond it: total internal reflection), cosT is 0,
    the JAX package's eps margin."""
    ncosI = vdot(v, n)
    sinT2 = (ni_over_nt * ni_over_nt) * (1.0 - ncosI * ncosI)
    ok = sinT2 <= 1.0
    safe = sinT2 < 1.0 - 1e-9
    cosT = torch.where(safe, vsqrt(torch.where(safe, 1.0 - sinT2, 1.0)), 0.0)
    refracted = v * ni_over_nt + n * (ni_over_nt * (-ncosI) - cosT)
    return refracted, ok


def vluminance(c: V3):
    """BT.709 luminance (vec3.h:275-279)."""
    return 0.212655 * c.x + 0.715158 * c.y + 0.072187 * c.z


def vonb_from_w(n: V3):
    """Orthonormal basis (u, v, w) from a unit normal w = n (onb.h:19-23)."""
    big_x = torch.abs(n.x) > 0.9
    zero = torch.zeros_like(n.x)
    a = V3(torch.where(big_x, 0.0, 1.0 + zero), torch.where(big_x, 1.0, zero),
           zero)
    v = vnormalize(vcross(n, a))
    u = vcross(n, v)
    return u, v, n


def vonb_l2w(u: V3, v: V3, w: V3, local: V3) -> V3:
    """local.x*u + local.y*v + local.z*w (onb.h:25-27)."""
    return u * local.x + v * local.y + w * local.z


# ---------------------------------------------------------------------------
# Inverse trig as the cephes atanf polynomials (`miniraytracer_tpu/ops/
# vecmath.py:286-321`): the image-texture uv of every renderer goes through
# these, so texel quantization is the same bit for bit in both packages and
# in the CUDA kernels (`csrc/physics.cuh` has the same three functions).
# ---------------------------------------------------------------------------

_HALF_PI = 3.14159265358979323846 / 2
_QUARTER_PI = 3.14159265358979323846 / 4


def vatan(x: torch.Tensor) -> torch.Tensor:
    """Elementwise arctan: cephes atanf range reduction + 4-term polynomial."""
    ax = torch.abs(x)
    big = ax > 2.414213562373095  # tan(3pi/8)
    mid = (ax > 0.4142135623730951) & ~big  # tan(pi/8)
    safe_big = torch.where(big, ax, 1.0)
    x1 = torch.where(big, -1.0 / safe_big,
                     torch.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    y0 = torch.where(big, _HALF_PI, torch.where(mid, _QUARTER_PI, 0.0))
    z = x1 * x1
    p = ((((8.05374449538e-2 * z - 1.38776856032e-1) * z
           + 1.99777106478e-1) * z - 3.33329491539e-1) * z * x1 + x1)
    return torch.sign(x) * (y0 + p)


def vatan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Elementwise atan2 with C quadrant semantics; (0, 0) -> 0."""
    safe_x = torch.where(x == 0.0, 1.0, x)
    base = vatan(y / safe_x)
    pi = 2 * _HALF_PI
    return torch.where(
        x > 0.0, base,
        torch.where(x < 0.0,
                    torch.where(y >= 0.0, base + pi, base - pi),
                    torch.where(y > 0.0, _HALF_PI,
                                torch.where(y < 0.0, -_HALF_PI, 0.0 * base))))


def vasin(y: torch.Tensor) -> torch.Tensor:
    """Elementwise arcsin on [-1, 1] as atan2(y, sqrt(1 - y^2)); the 1e-30
    floor is the JAX package's (it keeps f32 +-pi/2 at |y| == 1)."""
    yc = torch.clamp(y, -1.0, 1.0)
    return vatan2(yc, vsqrt(torch.clamp_min(1.0 - yc * yc, 1e-30)))


def vdiv(x: torch.Tensor, d) -> torch.Tensor:
    """x / d for a Python number d as an elementwise division: on a CUDA
    device torch divides by a host scalar as a multiplication by its
    reciprocal, an ulp away from the kernels' IEEE division."""
    return x / torch.full_like(x, float(d))


def sphere_uv(n: V3):
    """Spherical (u, v) of a unit normal (sphere.cpp:6-11), pole-safe; (u, v)
    fix the texel, so the divisions are `vdiv`'s."""
    phi = vatan2(n.z, n.x)
    ny = torch.clamp(n.y, -1.0, 1.0)
    at_pole = torch.abs(ny) >= 1.0
    theta = torch.where(at_pole, torch.sign(ny) * _HALF_PI,
                        vasin(torch.where(at_pole, 0.0, ny)))
    return 0.5 - vdiv(phi, 4 * _HALF_PI), 0.5 + vdiv(theta, 2 * _HALF_PI)
