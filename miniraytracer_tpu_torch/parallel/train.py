"""Differentiable render step ("train step") on one device.

Port of the single-device part of `miniraytracer_tpu/parallel/train.py`
(`dp = sp = 1`, no mesh): each step renders `spp_step` samples per pixel
through the fused AD scan (`ops/bounce_ad.py`; for a scene outside the fused
class its hybrid-ext scan), takes the SSE loss against a target image over
the pixels that completed a sample, and gets the gradients w.r.t.
`TrainParams` (material albedo, emission, gloss / refraction index, sphere
and triangle geometry) from the scan's hand-written backward kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from miniraytracer_tpu_torch.ops import bounce_ad, hybrid
from miniraytracer_tpu_torch.scene import types as T
from miniraytracer_tpu_torch.utils.device import resolve


class TrainParams(NamedTuple):
    """Differentiable scene-parameter subset (the gradient targets)."""

    tex_c0: torch.Tensor  # albedo / emission colors (X,3)
    tex_c1: torch.Tensor  # checker odd colors (X,3)
    mat_param: torch.Tensor  # gloss / ior / emission scale (M,)
    sph_c0: torch.Tensor  # sphere centers (S,3)
    sph_radius: torch.Tensor  # (S,)
    tri_m: torch.Tensor  # triangle base vertices (T,3)


def extract_params(scene: T.SceneData) -> TrainParams:
    return TrainParams(*(getattr(scene, k) for k in TrainParams._fields))


def apply_params(scene: T.SceneData, p: TrainParams) -> T.SceneData:
    return dataclasses.replace(scene, **p._asdict())


def params_from_numpy(fields: dict) -> TrainParams:
    """TrainParams from a dict of the JAX package's `TrainParams` leaves as
    numpy arrays (the counterpart of `scene.types.from_numpy`)."""
    return TrainParams(*(torch.as_tensor(np.asarray(fields[k], np.float32).copy())
                         for k in TrainParams._fields))


def make_train_step(*, width: int, height: int, max_bounces: int,
                    scan_steps: int = 0, spp_step: int = 1, device=None,
                    fused_ad=True, scene: T.SceneData | None = None):
    """The train step on one device.

    step(params, scene, target, sample0, lr) -> (params', loss, grads)

    `device` None means the GPU (it raises when there is none); the scene,
    the params and the target are moved there. `target` is the (width*height,
    3) image, pixel index x + y*width. Step `sample0` renders samples
    [sample0*spp_step, (sample0+1)*spp_step) of every pixel in one scan of
    `scan_steps` steps (0 = `spp_step*6 + max_bounces + 1`), compares the
    per-pixel mean of the finite completed samples with the target (SSE over
    pixels that completed at least one, divided by width*height*3), and
    returns the SGD update `p - lr*g`.

    `fused_ad=True` is the fused class's scan (`bounce.can_fuse` scenes);
    `fused_ad="ext"` the hybrid-ext scan (`bounce_ad.can_fuse_ad_ext`
    scenes: random_spheres, triangles, earth, book2_final), which needs the
    concrete `scene` here, as in the JAX package: its structure makes the
    compaction plan of ext-material mode once (`hybrid.smem_plan`), and the
    step must be given a scene of that structure. `fused_ad=False` (the
    unfused scans of the JAX package) raises: it is not ported.
    """
    if fused_ad is False:
        raise NotImplementedError(
            "fused_ad=False (the packed scan) is not ported yet, only fused_ad=True "
            "and fused_ad='ext': ROADMAP.md queue A, item 11")
    if fused_ad not in (True, "ext"):
        raise ValueError(f"fused_ad must be True, False or 'ext', got {fused_ad!r}")
    pack_plan = None
    if fused_ad == "ext":
        if scene is None:
            raise ValueError("make_train_step(fused_ad='ext') needs the concrete `scene` "
                             "(its structure makes the ext-material compaction plan)")
        if not bounce_ad.can_fuse_ad_ext(scene):
            raise ValueError(f"scene {scene.name!r} is not in the hybrid-ext class "
                             "(see bounce_ad.can_fuse_ad_ext)")
        if hybrid.ext_mat_mode(scene):
            pack_plan = hybrid.smem_plan(scene)
    dev = resolve(device)
    n_pix = width * height

    def loss_fn(params, scene, target, sample0):
        sc = apply_params(scene, params)
        pix = torch.arange(n_pix, dtype=torch.int32, device=dev)
        summ, nv, _rays = bounce_ad.sample_pixel_sums_fused(
            sc, pix, int(sample0) * spp_step, spp_step, width=width,
            height=height, max_bounces=max_bounces, scan_steps=scan_steps,
            use_ext=fused_ad == "ext", pack_plan=pack_plan)
        n_valid = nv[:, None]
        mean_color = summ / torch.clamp_min(n_valid, 1.0)
        err = torch.where(n_valid > 0, mean_color - target, 0.0)
        return torch.sum(err * err) / (n_pix * 3.0)

    def step(params, scene, target, sample0, lr):
        scene = scene.to(dev)
        target = torch.as_tensor(target, dtype=torch.float32).to(dev)
        if tuple(target.shape) != (n_pix, 3):
            raise ValueError(f"target must have shape ({n_pix}, 3)")
        leaves = TrainParams(*(p.detach().to(dev).requires_grad_(True)
                               for p in params))
        loss = loss_fn(leaves, scene, target, sample0)
        grads = torch.autograd.grad(loss, list(leaves), allow_unused=True)
        grads = TrainParams(*(torch.zeros_like(p) if g is None else g
                              for p, g in zip(leaves, grads)))
        new_params = TrainParams(*((p - lr * g).detach()
                                   for p, g in zip(leaves, grads)))
        return new_params, loss.detach(), grads

    return step
