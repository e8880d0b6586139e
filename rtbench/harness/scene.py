"""A configuration's scene, built from its file and a seed.

The configuration names one of the program's scene constructors
(`miniraytracer_tpu_torch.models.scenes`, the reference renderer's scene.cpp)
and its aspect. The seed draws the albedos of the rows `albedo_rows` of
`tex_c0`, each channel scaled by a factor in [1 - spread, 1 + spread] and kept
in [0, 1]: the same paths (a lambertian albedo changes a path's weight, not
its directions), other colours.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def build(mrt, config: dict):
    return getattr(mrt.scenes, config["scene"])(float(config["aspect"]))


def seeded_albedos(scene, config: dict, seed: int):
    """The scene with the albedos the seed draws (on the scene's device)."""
    rows = list(config["albedo_rows"])
    spread = float(config["albedo_spread"])
    rng = np.random.default_rng(seed)
    factor = torch.as_tensor(rng.uniform(1 - spread, 1 + spread, (len(rows), 3)),
                             dtype=torch.float32)
    c0 = scene.tex_c0.clone()
    c0[rows] = torch.clamp(c0[rows] * factor.to(c0.device), 0.0, 1.0)
    return dataclasses.replace(scene, tex_c0=c0)
