"""4x4 matrix helpers (column-major, like the reference's mat4.h/.cpp).

The reference hand-writes an AVX multiply, a SIMD inverse and a set of
transform builders (mat4.cpp:13-253); here they are plain tensor functions,
batched over leading axes and differentiable, as in
`miniraytracer_tpu/ops/mat4.py`. Columns are `m[:, j]`; `apply_point` and
`apply_vector` multiply column vectors. A user-facing utility: no renderer
calls it.
"""

from __future__ import annotations

import torch

_F32 = torch.float32


def _vec(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def identity():
    return torch.eye(4, dtype=_F32)


def matmul(a, b):
    """a @ b for column-major 4x4 (mat4.h operator*)."""
    return a @ b


def transpose(m):
    return torch.swapaxes(m, -1, -2)


def invert(m):
    """Full inverse (mat4.cpp:13-127's cofactor expansion)."""
    return torch.linalg.inv(m)


def _with_linear(m3):
    """4x4 with the linear part `m3` and no translation."""
    m = torch.eye(4, dtype=_F32)
    m[:3, :3] = m3
    return m


def translate(t):
    """mat4 Translate builder."""
    m = torch.eye(4, dtype=_F32)
    m[:3, 3] = _vec(t)
    return m


def scale(s):
    """Uniform or per-axis scale."""
    s = _vec(s)
    if s.ndim == 0:
        s = torch.stack([s, s, s])
    return torch.diag(torch.cat([s, torch.ones((1,), dtype=_F32)]))


def _unit(axis):
    a = _vec(axis)
    return a / torch.linalg.norm(a)


def scale_axis(factor, axis):
    """Scale by `factor` along the unit direction `axis` (mat4.cpp:179-190):
    M = I + (factor-1) * axis axis^T."""
    a = _unit(axis)
    return _with_linear(torch.eye(3, dtype=_F32) + (factor - 1.0) * torch.outer(a, a))


def reflect(axis):
    """Reflection across the plane with unit normal `axis`: scale -1."""
    return scale_axis(-1.0, axis)


def involution(axis):
    """Point reflection through the axis line (mat4 Involution): 2 aa^T - I."""
    a = _unit(axis)
    return _with_linear(2.0 * torch.outer(a, a) - torch.eye(3, dtype=_F32))


def _axis_rot(rad, axis):
    rad = _vec(rad)
    c, s = torch.cos(rad), torch.sin(rad)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 0:
        r = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    elif axis == 1:
        r = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
    else:
        r = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    return _with_linear(torch.stack([torch.stack(row) for row in r]))


def rotate_x(rad):
    return _axis_rot(rad, 0)


def rotate_y(rad):
    """The reference's rotate_y sense (scene_object.cpp:85-92:
    x' = c x + s z, z' = c z - s x)."""
    return _axis_rot(rad, 1)


def rotate_z(rad):
    return _axis_rot(rad, 2)


def rotate_axis(rad, axis):
    """Rodrigues rotation about the unit `axis` (mat4.cpp Rotate)."""
    a = _unit(axis)
    rad = _vec(rad)
    c, s = torch.cos(rad), torch.sin(rad)
    x, y, z = a[0], a[1], a[2]
    zero = torch.zeros_like(x)
    k = torch.stack([torch.stack([zero, -z, y]), torch.stack([z, zero, -x]),
                     torch.stack([-y, x, zero])])
    return _with_linear(c * torch.eye(3, dtype=_F32) + s * k + (1 - c) * torch.outer(a, a))


def apply_point(m, p):
    """Transform points (..., 3) with w = 1."""
    return _vec(p) @ m[:3, :3].T + m[:3, 3]


def apply_vector(m, v):
    """Transform directions (..., 3) with w = 0."""
    return _vec(v) @ m[:3, :3].T


def apply_normal(m, n):
    """Transform normals by the inverse-transpose rule (obj_loader.cpp:117-119
    takes the inverse rotation for pure rotations)."""
    return _vec(n) @ torch.linalg.inv(m[:3, :3])
