"""Counter-based stateless RNG, bit-identical to `miniraytracer_tpu/ops/rng.py`.

Every random draw is a pure function of integer counters (pixel, sample,
bounce, slot), so this package, the JAX package and the CUDA kernel
(`csrc/bounce.cu`) draw the same numbers for the same path.

torch has no full uint32 arithmetic on the CPU (add, shift, remainder and
compare raise for UInt32), so a u32 word is held in an int64 tensor with
values in [0, 2^32). `_mul32` multiplies in 16-bit halves so that no product
leaves the int64 range, and every sum is masked back to 32 bits.
"""

from __future__ import annotations

import struct

import torch

from miniraytracer_tpu_torch.ops.vecmath import V3, vsqrt

PI = 3.14159265358979323846

_MASK = 0xFFFFFFFF
M1 = 0x9E3779B1  # golden-ratio Weyl constant
M2 = 0x85EBCA77
M3 = 0xC2B2AE3D


def _u32(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    if x.dtype != torch.int64:
        x = x.to(torch.int64)
    return x & _MASK


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) and a constant c < 2^32."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pcg_hash(x) -> torch.Tensor:
    """PCG-RXS-M-XS 32-bit output permutation over an LCG step."""
    x = _u32(x)
    state = (_mul32(x, 747796405) + 2891336453) & _MASK
    word = _mul32(((state >> ((state >> 28) + 4)) ^ state), 277803737)
    return (word >> 22) ^ word


def fold(key, data) -> torch.Tensor:
    """Mix an integer into a key, producing a new independent key."""
    return pcg_hash(_mul32(_u32(key), M1) + _mul32(_u32(data), M2) + M3)


def ray_key(pixel_id, sample_id) -> torch.Tensor:
    """Root key for one (pixel, sample) ray path."""
    h = pcg_hash(_mul32(_u32(pixel_id), M1) + 0x1234567)
    return pcg_hash(h + _mul32(_u32(sample_id), M2))


def bits(key, slot) -> torch.Tensor:
    """Random u32 (as int64) for draw number `slot` under `key`."""
    return pcg_hash(_u32(key) + _mul32(_u32(slot), M3))


def uniform(key, slot) -> torch.Tensor:
    """float32 in [0, 1) via the mantissa bit trick (pcg.cpp:53-65)."""
    b = bits(key, slot)
    f = ((b & 0x007FFFFF) | 0x3F800000).to(torch.int32)
    return f.view(torch.float32) - 1.0


def uniform2(key, slot):
    return uniform(key, slot), uniform(key, slot + 1)


def uniform3(key, slot):
    return uniform(key, slot), uniform(key, slot + 1), uniform(key, slot + 2)


# ---------------------------------------------------------------------------
# Direction and point samplers: pre-drawn uniforms in, componentwise V3 out
# (`miniraytracer_tpu/ops/rng.py:93-162`). sin, cos and the cube root are
# the library's, so they may differ from XLA's in the last bit.
# ---------------------------------------------------------------------------


def sample_cosine_direction(r1, r2) -> V3:
    """The reference's cosine-ish lobe in the local (u, v, w) frame
    (pcg.cpp:87-98), with its factor 2 on x and y kept (quirk, pcg.h:15-17)."""
    z = vsqrt(torch.clamp_min(1.0 - r2, 0.0))
    phi = 2.0 * PI * r1
    sq = 2.0 * vsqrt(r2)
    return V3(torch.cos(phi) * sq, torch.sin(phi) * sq, z)


def sample_cosine_direction_exact(r1, r2) -> V3:
    """Textbook cosine-weighted hemisphere sample (the opt-in variant)."""
    z = vsqrt(torch.clamp_min(1.0 - r2, 0.0))
    phi = 2.0 * PI * r1
    sq = vsqrt(r2)
    return V3(torch.cos(phi) * sq, torch.sin(phi) * sq, z)


def sample_on_sphere(r1, r2) -> V3:
    """Uniform direction on the unit sphere (pcg.cpp:102-110)."""
    x = r1 * 2.0 - 1.0
    phi = r2 * 2.0 * PI
    s = vsqrt(torch.clamp_min(1.0 - x * x, 0.0))
    return V3(x, torch.cos(phi) * s, torch.sin(phi) * s)


def sample_in_ball(r1, r2, r3) -> V3:
    """Uniform point in the unit ball: a direction scaled by the cube root of
    r3 (the analytic form of pcg.cpp:70-80's rejection loop). The fused
    kernels take the root as exp(log(r)/3) instead (`bounce._sample_in_ball`)."""
    return sample_on_sphere(r1, r2) * torch.pow(r3, 1.0 / 3.0)


def sample_in_disk(r1, r2) -> V3:
    """Uniform point in the unit disk (z=0), analytic form."""
    rad = vsqrt(r1)
    phi = 2.0 * PI * r2
    return V3(rad * torch.cos(phi), rad * torch.sin(phi), torch.zeros_like(r1))


def sample_towards_sphere(radius, dist_sq, r1, r2) -> V3:
    """Cone sample towards a sphere of `radius` at squared distance
    `dist_sq`, +z towards its centre (pcg.cpp:125-136), with the JAX
    package's eps margins on both square roots."""
    frac = torch.clamp(1.0 - radius * radius / torch.clamp_min(dist_sq, 1e-30), 0.0, 1.0)
    f_ok = frac > 1e-12
    sq_frac = torch.where(f_ok, vsqrt(torch.where(f_ok, frac, 1.0)), 0.0)
    z = 1.0 + r2 * (sq_frac - 1.0)
    phi = 2.0 * PI * r1
    z2 = z * z
    z_ok = z2 < 1.0 - 1e-12
    s = torch.where(z_ok, vsqrt(torch.where(z_ok, 1.0 - z2, 1.0)), 0.0)
    return V3(torch.cos(phi) * s, torch.sin(phi) * s, z)


# ---------------------------------------------------------------------------
# Exact PCG32 (XSH-RR) on Python ints, host side: replicates the reference's
# fixed-seed scene generation and Perlin tables.
# ---------------------------------------------------------------------------

_PCG_MULT = 6364136223846793005
_PCG_MASK = (1 << 64) - 1


class Pcg32:
    """Exact PCG32 (XSH-RR) — Python ints, host-side only.

    Mirrors pcg32_random_r / pcg32_srandom_r (pcg.cpp:13-37) for scene-gen
    determinism parity: the reference seeds its main thread with fixed
    constants (main.cpp:302) so object placement is reproducible.
    """

    def __init__(self, initstate: int, initseq: int, raw: bool = False):
        if raw:
            # pre-main static G_rng: struct-initialized, no srandom warmup
            self.state = initstate & _PCG_MASK
            self.inc = initseq & _PCG_MASK
        else:
            self.state = 0
            self.inc = ((initseq << 1) | 1) & _PCG_MASK
            self.rand32()
            self.state = (self.state + initstate) & _PCG_MASK
            self.rand32()

    def rand32(self) -> int:
        old = self.state
        self.state = (old * _PCG_MULT + self.inc) & _PCG_MASK
        xorshifted = (((old >> 18) ^ old) >> 27) & 0xFFFFFFFF
        rot = old >> 59
        return ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & 0xFFFFFFFF

    def randf(self) -> float:
        """float in [0,1) via the same mantissa trick (pcg.cpp:53-65)."""
        bits32 = 0x3F800000 | (self.rand32() & 0x007FFFFF)
        return struct.unpack("<f", struct.pack("<I", bits32))[0] - 1.0

    def in_ball(self):
        """random_in_sphere rejection loop (pcg.cpp:70-80), bit-faithful.

        Draw order: `Vec3(randf(), randf(), randf())` evaluates its
        arguments right to left under MSVC and GCC, so the first draw lands
        in z, then y, then x."""
        while True:
            z = 2.0 * self.randf() - 1.0
            y = 2.0 * self.randf() - 1.0
            x = 2.0 * self.randf() - 1.0
            if x * x + y * y + z * z < 1.0:
                return (x, y, z)
