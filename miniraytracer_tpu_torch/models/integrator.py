"""Forward-render entry points of the port (`miniraytracer_tpu/models/
integrator.py`): sample offsets, the renderer pick, and `render_auto`.

Only the fused renderer is ported. A scene outside the fused class raises
`NotImplementedError` naming the JAX renderer that would run it; nothing is
substituted silently.
"""

from __future__ import annotations

import math

import torch

from miniraytracer_tpu_torch.ops import bounce
from miniraytracer_tpu_torch.scene import types as T


def sample_offsets(spp: int, device=None):
    """Stratified sqrt(spp)^2 regular grid of subpixel offsets
    (main.cpp:316-332). Returns ((ns, 2) float32 tensor, ns)."""
    sq = math.isqrt(spp)
    ns = sq * sq
    i = torch.arange(ns, device=device)
    offs = torch.stack([
        (torch.div(i, sq, rounding_mode="floor").to(torch.float32) + 0.5) / sq,
        ((i % sq).to(torch.float32) + 0.5) / sq,
    ], dim=1)
    return offs, ns


def pick_renderer(scene: T.SceneData) -> str:
    """"fused" for scenes in the fused class (ops/bounce.can_fuse). Other
    scenes need a renderer the port does not have yet: raise, naming the
    JAX package's renderer for it."""
    if bounce.can_fuse(scene):
        return "fused"
    heavy = scene.n_tris + scene.n_spheres + 6 * scene.n_boxes
    if heavy >= 2000:
        jax_renderer = "render_workqueue"
    elif heavy >= 64 or scene.has_image:
        jax_renderer = "render_workqueue or render_wavefront_hybrid"
    else:
        jax_renderer = "render_wavefront"
    raise NotImplementedError(
        f"scene {scene.name!r} is outside the fused class; the JAX package "
        f"renders it with {jax_renderer} (miniraytracer_tpu.models."
        f"integrator.pick_renderer), which is not ported yet")


def render_auto(scene, width, height, spp, max_bounces=32, max_lum=1000.0):
    """Render with the picked forward renderer, on the scene's device.
    Returns (frame (H,W,3) float32 tensor, stats)."""
    pick_renderer(scene)
    return bounce.render_wavefront_fused(
        scene, width, height, spp, max_bounces, max_lum)
