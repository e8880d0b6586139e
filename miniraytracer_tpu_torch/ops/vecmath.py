"""Vector math core of the port: a structure-of-arrays 3-vector over tensors.

Mirrors `miniraytracer_tpu/ops/vecmath.py` for what the fused forward path
uses (V3, dot, cross, safe normalize, select). x/y/z stay three separate
(N,) tensors so every op is elementwise; the (..., 3) form exists only at
host boundaries (framebuffers, scene tables).
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


def sphere_uv(n: V3):
    """Spherical (u, v) of a unit normal (sphere.cpp:6-11), pole-safe. The
    divisors are tensors: on a CUDA device torch divides by a host scalar as
    a multiplication by its reciprocal, an ulp away from the kernels' IEEE
    division, and (u, v) fix the texel."""
    phi = vatan2(n.z, n.x)
    ny = torch.clamp(n.y, -1.0, 1.0)
    at_pole = torch.abs(ny) >= 1.0
    theta = torch.where(at_pole, torch.sign(ny) * _HALF_PI,
                        vasin(torch.where(at_pole, 0.0, ny)))
    two_pi = torch.full_like(phi, 4 * _HALF_PI)
    return 0.5 - phi / two_pi, 0.5 + theta / (0.5 * two_pi)
