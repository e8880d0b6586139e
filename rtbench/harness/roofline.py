"""The yardstick of the kernels' rooflines: the card's peaks and the frozen counts.

The least time a kernel could take is the larger of its bytes over the memory
rate and its fp32 operations over the instruction rate. The kernels are built
with `--fmad=false`, so a multiply and an add are two instructions: the rate
is half the published 67 TFLOP/s, which counts a fused multiply-add as two
(NVIDIA H100 SXM data sheet, 3.35 TB/s of HBM3).

The operation counts are frozen copies of those `chip_smoke.py` counted from
the kernel sources (`csrc/physics.cuh::bounce_physics`), per live ray: the hit
sweep 27 a sphere, 37 a rect, 55 a triangle, 55 a box, 90 a volume; the hit
point 6; the shading ~210; the step's own algebra and the share of a camera
ray ~40. Only active primitives count: an inactive pad row is work these
inputs do not need. The integer hashing of the RNG is not counted. The
adjoint replays the forward and runs the adjoint of the branch taken: twice
the forward's operations.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2


def ops_per_ray(active: dict) -> int:
    """fp32 operations of one bounce of a live ray over a scene with `active`
    primitives ({"S", "R", "Tc", "Bx", "V"}: counts of active rows)."""
    sweep = (27 * active["S"] + 37 * active["R"] + 55 * active["Tc"] + 55 * active["Bx"]
             + 90 * active["V"])
    return sweep + 6 + 210 + 40


def least_seconds(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def b1_frame(n_pixels: int, rays: int, active: dict, table_bytes: int) -> float:
    """Least seconds of one fused frame (B1): per pixel it reads its index and
    writes its colour, count and rays (6 words); every ray's operations."""
    return least_seconds(4 * n_pixels * 6 + table_bytes, rays * ops_per_ray(active))


def scan_step(n_lanes: int, launches: int, rays: int, active: dict, table_bytes: int):
    """Least seconds of one train step's B2 launches and of its B3 launches,
    from the step's total rays: B2 reads 19+3+1+2 and writes 19+3+1 rows of
    N words a launch; B3 reads 13+3+1+2+19 and writes 19. Summed over the
    step (not launch by launch) this is a lower bound of the launches' sum."""
    b2 = least_seconds(launches * (4 * n_lanes * 48 + table_bytes), rays * ops_per_ray(active))
    b3 = least_seconds(launches * (4 * n_lanes * 57 + table_bytes),
                       rays * 2 * ops_per_ray(active))
    return b2, b3
