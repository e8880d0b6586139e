"""Forward-render entry points of the port (`miniraytracer_tpu/models/
integrator.py`): sample offsets, the renderer pick, and `render_auto`.

The fused renderer (`ops/bounce.py`) and the hybrid step renderer
(`ops/hybrid.py`) are ported. A scene that the JAX package's rule sends to
another renderer raises `NotImplementedError` naming that renderer and the
kernel it needs; nothing is substituted silently.
"""

from __future__ import annotations

import math

import torch

from miniraytracer_tpu_torch.ops import bounce, hybrid
from miniraytracer_tpu_torch.scene import types as T
from miniraytracer_tpu_torch.utils.device import resolve


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


def _unported(scene, jax_renderer, needs):
    return NotImplementedError(
        f"scene {scene.name!r}: the JAX package renders it with {jax_renderer} "
        f"(miniraytracer_tpu.models.integrator.pick_renderer), which is not "
        f"ported yet: it needs {needs}")


def pick_renderer(scene: T.SceneData) -> str:
    """The JAX package's forward-renderer rule as it evaluates on the
    accelerator: "fused" for the fused class (`bounce.can_fuse`), "hybrid"
    for imageless scenes of the hybrid class (`hybrid.prefer_hybrid`) under
    2000 primitives. Where the rule picks the work queue or the plain
    wavefront, which the port does not have, this raises and names them."""
    if bounce.can_fuse(scene):
        return "fused"
    wq_needs = ("the work-queue renderer and its shade kernel B5 "
                "(ops/hybrid.py::_make_shade_kernel), ROADMAP.md A10")
    # a box costs about 6 rect tests in the sweep (box.h decomposition)
    heavy = scene.n_tris + scene.n_spheres + 6 * scene.n_boxes
    if heavy >= 2000:
        raise _unported(scene, "render_workqueue", wq_needs)
    if hybrid.prefer_hybrid(scene):
        if scene.has_image:
            raise _unported(scene, "render_workqueue", wq_needs)
        return "hybrid"
    if heavy >= 64:
        raise _unported(scene, "render_workqueue", wq_needs)
    raise _unported(scene, "render_wavefront",
                    "the plain wavefront renderer (no kernel), ROADMAP.md A5")


def render_auto(scene, width, height, spp, max_bounces=32, max_lum=1000.0,
                device=None):
    """Render with the picked forward renderer on `device`: None means the
    GPU (raises when there is none), and the scene is moved there. Returns
    (frame (H,W,3) float32 tensor on that device, stats)."""
    which = pick_renderer(scene)
    render = (hybrid.render_wavefront_hybrid if which == "hybrid"
              else bounce.render_wavefront_fused)
    return render(scene.to(resolve(device)), width, height, spp, max_bounces,
                  max_lum)
