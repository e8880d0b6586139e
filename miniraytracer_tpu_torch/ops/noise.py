"""Standalone 7-octave Perlin turbulence: kernel B6 and its plain version.
Port of `miniraytracer_tpu/ops/noise.py` (`flash_turbulence`, the TPU kernel
`_turb_kernel`).

`turbulence(noise_fn, p)` is |sum_i 0.5^i noise(2^i p)| over 7 octaves
(texture.cpp:155-165); `perlin_noise` is one octave of the reference's
gradient noise (texture.cpp:68-152): hermite-smoothed trilinear interpolation
of the gradients that the permutation tables pick for the 8 lattice corners.
The tables are the scene's six 256-entry rows (px py pz gx gy gz,
`noise_tables`): the JAX package's (96, 128) lane-replicated layout exists
only for the TPU's lane gather.

`flash_turbulence` launches kernel B6 (`csrc/noise.cu`, a persistent grid
striding over the points; its body is `physics.cuh::turbulence`, which the
fused kernels B1, B2, B4 and B5 share) for CUDA tensors and runs
`flash_turbulence_plain` for CPU tensors.
The plain version is also the turbulence of the fused renderers' plain
versions (`ops/bounce.py`) and of the textures in tensor operations
(`models/textures.py`).
"""

from __future__ import annotations

import ctypes

import torch

from miniraytracer_tpu_torch.ops.vecmath import V3
from miniraytracer_tpu_torch.scene import types as T
from miniraytracer_tpu_torch.utils import device

PERLIN_DEPTH = 7  # turbulence octaves (texture.cpp:158)

# Launches of kernel B6 (never of its plain version).
launches = 0


def noise_tables(scene: T.SceneData) -> torch.Tensor:
    """The scene's Perlin tables as six 256-entry float rows (px py pz gx gy
    gz), a (6, 256) float32 tensor on the scene's device."""
    f32 = lambda a: a.to(torch.float32).reshape(-1)
    return torch.stack([
        f32(scene.perlin_px), f32(scene.perlin_py), f32(scene.perlin_pz),
        f32(scene.perlin_vec[:, 0]), f32(scene.perlin_vec[:, 1]),
        f32(scene.perlin_vec[:, 2])])


def _lattice(c):
    """(cell, fraction, hermite weight) of one coordinate (texture.cpp:70-71)."""
    pf = torch.floor(c)
    fr = c - pf
    return pf.to(torch.int32), fr, fr * fr * (3.0 - 2.0 * fr)


def perlin_noise(ptab, p: V3):
    """One octave of gradient noise at points `p` from the (6, 256) tables.
    The 8 corners are summed in the order di, dj, dk, as in the JAX package."""
    (ix, fx, hx), (iy, fy, hy), (iz, fz, hz) = (_lattice(c) for c in p)
    perm = [[ptab[a][((ic + d) & 255).long()].to(torch.int32) for d in (0, 1)]
            for a, ic in enumerate((ix, iy, iz))]
    acc = torch.zeros_like(p.x)
    for di in (0, 1):
        ax, wx = (hx if di else 1.0 - hx), fx - di
        for dj in (0, 1):
            ay, wy = (hy if dj else 1.0 - hy), fy - dj
            for dk in (0, 1):
                az, wz = (hz if dk else 1.0 - hz), fz - dk
                gi = (perm[0][di] ^ perm[1][dj] ^ perm[2][dk]).long()
                d = ptab[3][gi] * wx + ptab[4][gi] * wy + ptab[5][gi] * wz
                acc = acc + ax * ay * az * d
    return acc


def turbulence(noise_fn, p: V3, depth: int = PERLIN_DEPTH):
    """|sum_i 0.5^i noise_fn(2^i p)| over `depth` octaves (texture.cpp:155-165)."""
    acc = torch.zeros_like(p.x)
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * noise_fn(p)
        weight *= 0.5
        p = p * 2.0
    return torch.abs(acc)


def flash_turbulence_plain(ptab, p: V3):
    """Plain PyTorch version of `flash_turbulence`, on any device."""
    return turbulence(lambda q: perlin_noise(ptab, q), p)


def flash_turbulence(ptab, p: V3):
    """7-octave Perlin turbulence at points `p` (V3 of (N,) float32) from the
    (6, 256) float32 tables of `noise_tables`. Returns (N,) float32: kernel B6
    for CUDA tensors, the plain version for CPU tensors. A failed build or
    launch raises."""
    n = p.x.shape[0]
    for name, c in zip("xyz", p):
        if c.shape != (n,):
            raise ValueError(f"p.{name} must have shape ({n},), got {tuple(c.shape)}")
    if device.kind(p.x, "turbulence") == "cpu":
        return flash_turbulence_plain(ptab, p)
    from miniraytracer_tpu_torch.utils import kernels

    global launches
    dev = p.x.device
    if (ptab.device != dev or ptab.dtype != torch.float32 or ptab.shape != (6, 256)
            or not ptab.is_contiguous()):
        raise ValueError(f"ptab must be a contiguous float32 (6, 256) tensor on {dev}")
    pts = [c.contiguous() for c in p]
    if any(c.device != dev or c.dtype != torch.float32 for c in pts):
        raise ValueError(f"p must be float32 tensors on {dev}")
    if n >= 2 ** 31 - 2 ** 20:  # the kernel's grid-stride index stays an int
        raise ValueError("too many points for int32 indexing")
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = kernels.load("noise")
    fn = lib.mrt_turbulence
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptab.data_ptr(), *(c.data_ptr() for c in pts), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"mrt_turbulence failed: {kernels.error_string(lib, rc)}")
    launches += 1
    return out
