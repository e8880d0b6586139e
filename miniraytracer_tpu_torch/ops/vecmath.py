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
