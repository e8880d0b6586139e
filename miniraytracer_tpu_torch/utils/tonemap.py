"""HDR tone mapping for display (main.cpp:416-484), as in
`miniraytracer_tpu/utils/tonemap.py`, in its order of operations.

The linear frame is the ground truth (comparisons happen before the tone map,
main.cpp:57-58); these map it for display:
- drago: Adaptive Logarithmic Mapping (the reference's live default,
  main.cpp:416-444, L_dmax=230, bias=log0.7/log0.5);
- reinhard: Photographic Tone Reproduction (compiled out there, 445-476);
- gamma: plain sqrt gamma (477-484).

Each takes a global max (and reinhard a mean) luminance reduction over the
whole frame, on the frame's device.
"""

from __future__ import annotations

import math

import torch

from miniraytracer_tpu_torch.ops import vecmath as vm


def drago(frame: torch.Tensor, l_dmax: float = 230.0, bias_num: float = 0.7) -> torch.Tensor:
    """frame (..., 3) linear -> display RGB in [0, 1]."""
    bias = math.log(bias_num) / math.log(0.5)
    lum = vm.luminance(frame)
    l_wmax = torch.max(lum)
    invlogmax = 1.0 / torch.log10(l_wmax + 1.0)
    invmax = 1.0 / torch.clamp_min(l_wmax, 1e-12)
    loglw = torch.log(lum + 1.0)
    lum_new = (l_dmax * 0.01 * invlogmax) * (
        loglw / torch.log(2.0 + (lum * invmax) ** bias * 8.0))
    out = (lum_new[..., None] * frame) / (lum[..., None] + 1e-5)
    return torch.clamp(out, 0.0, 1.0)


def reinhard(frame: torch.Tensor, key: float = 0.10, sigma: float = 1e-5) -> torch.Tensor:
    lum = vm.luminance(frame)
    logavg = torch.exp(torch.mean(torch.log(sigma + lum)))
    l_wmax = torch.max(lum)
    invmax = 1.0 / torch.clamp_min(l_wmax, 1e-12)
    lum_new = key / logavg * lum
    lum_new = lum_new * (1.0 + lum_new * (invmax * invmax)) / (1.0 + lum_new)
    out = (lum_new[..., None] * frame) / (lum[..., None] + sigma)
    return torch.clamp(out, 0.0, 1.0)


def gamma(frame: torch.Tensor) -> torch.Tensor:
    return torch.clamp(vm.gamma_correct(frame), 0.0, 1.0)


OPERATORS = {"drago": drago, "reinhard": reinhard, "gamma": gamma}
