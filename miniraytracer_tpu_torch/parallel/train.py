"""Differentiable render step ("train step") on one device.

Port of the single-device part of `miniraytracer_tpu/parallel/train.py`
(`dp = sp = 1`, no mesh): each step renders samples of every pixel, takes
the SSE loss against a target image over the pixels that completed a
sample, and gets the gradients w.r.t. `TrainParams` (material albedo,
emission, gloss / refraction index, sphere and triangle geometry). Three
renderers: the fused AD scan (`ops/bounce_ad.py`, the scan step kernel and
its hand-written backward kernel); its hybrid-ext form for scenes outside
the fused class; and the JAX package's default, the scans of
`models/integrator.py` (`fused_ad=False`: the bounce in tensor operations
under autograd, one item a lane or `pack` of them, each step
rematerialised), whose sweeps are the custom-VJP kernels of
`intersect.make_accel(differentiable=True)`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from miniraytracer_tpu_torch.models import integrator as integ
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


def scan_loss(scene: T.SceneData, target, sample0: int, offsets, *, width: int, height: int,
              max_bounces: int, pack: int = 1, scan_steps: int = 0, spp_step: int = 1,
              plain: bool = False, stats: dict | None = None):
    """The loss of `make_train_step(fused_ad=False)` (the JAX package's
    `_make_step` on one device), differentiable in the scene's tensors.

    `pack` = 1: one sample of every pixel through the unpacked scan
    (`integrator.sample_radiance(loop="scan")`), sample `sample0` at the
    offset `offsets[0]`; a non-finite sample counts as 0. `pack` > 1: the
    items are the pixel list tiled `spp_step` times, sample-major, item s of
    a pixel being sample `sample0*spp_step + s` at the offset `offsets[samp %
    len(offsets)]` (`offsets[0]` when `spp_step` is 1), padded to a multiple
    of `pack` by repeating the last item, through
    `integrator.sample_radiance_packed`; only the finite channels of the
    items that were done count. Both: the SSE of the per-pixel mean against
    `target` ((width*height, 3)) over the pixels with a counted sample,
    divided by width*height*3. `plain` runs the sweeps' plain versions on
    any device. `stats`, a dict, receives "rays" (the rays traced) and
    "done" (the samples that were done, finite or not) as 0-d tensors."""
    n_pix = width * height
    dev = scene.device
    offsets = torch.as_tensor(offsets, dtype=torch.float32).to(dev)
    pix = torch.arange(n_pix, dtype=torch.int64, device=dev)
    kw = dict(width=width, height=height, max_bounces=max_bounces, plain=plain)
    if pack > 1:
        n_items = n_pix * spp_step
        samp = sample0 * spp_step + torch.arange(spp_step, device=dev).repeat_interleave(n_pix)
        off = (offsets[samp % offsets.shape[0]] if spp_step > 1
               else offsets[0].expand(n_items, 2))
        pix_items = pix.repeat(spp_step)
        tail = -n_items % pack
        if tail:
            pix_items = torch.cat([pix_items, pix_items[-1:].expand(tail)])
            samp = torch.cat([samp, samp[-1:].expand(tail)])
            off = torch.cat([off, off[-1:].expand(tail, 2)])
        rad, done, rays = integ.sample_radiance_packed(scene, pix_items, samp, off, pack=pack,
                                                       scan_steps=scan_steps, **kw)
        n_done = done[:n_items].sum()
        rad = rad.arr[:n_items].reshape(spp_step, n_pix, 3)
        val = done[:n_items].reshape(spp_step, n_pix, 1) & torch.isfinite(rad)
        radiance = torch.where(val, rad, 0.0).sum(0)
        n_valid = val.to(torch.float32).sum(0)
    else:
        rad, rays = integ.sample_radiance(scene, pix, sample0, offsets[0], loop="scan", **kw)
        n_done = torch.full((), n_pix, device=dev)
        radiance = torch.where(torch.isfinite(rad.arr), rad.arr, 0.0)
        # as the JAX package counts: after the non-finite samples became 0
        n_valid = torch.isfinite(radiance).to(torch.float32)
    if stats is not None:
        stats.update(rays=rays, done=n_done)
    mean_color = radiance / torch.clamp_min(n_valid, 1.0)
    err = torch.where(n_valid > 0, mean_color - target, 0.0)
    return torch.sum(err * err) / (n_pix * 3.0)


def make_train_step(*, width: int, height: int, max_bounces: int, pack: int = 1,
                    scan_steps: int = 0, spp_step: int = 1, device=None,
                    fused_ad=True, scene: T.SceneData | None = None):
    """The train step on one device.

    step(params, scene, target, sample0, lr, *, offsets=None, stats=None)
      -> (params', loss, grads)

    `device` None means the GPU (it raises when there is none); the scene,
    the params and the target are moved there. `target` is the (width*height,
    3) image, pixel index x + y*width. The step returns the SGD update
    `p - lr*g`.

    `fused_ad=True` is the fused class's scan (`bounce.can_fuse` scenes);
    `fused_ad="ext"` the hybrid-ext scan (`bounce_ad.can_fuse_ad_ext`
    scenes: random_spheres, triangles, earth, book2_final), which needs the
    concrete `scene` here, as in the JAX package: its structure makes the
    compaction plan of ext-material mode once (`hybrid.smem_plan`), and the
    step must be given a scene of that structure. Both render samples
    [sample0*spp_step, (sample0+1)*spp_step) of every pixel in one scan of
    `scan_steps` steps (0 = `spp_step*6 + max_bounces + 1`), each sample at
    its own stratified offset of 64, and compare the per-pixel mean of the
    finite completed samples with the target (SSE over pixels that completed
    at least one, divided by width*height*3); `pack` is not used.

    `fused_ad=False` is the JAX package's default step, every scene: the
    scans of `models/integrator.py` (`scan_loss`), unpacked with `pack` = 1
    (one sample a step, `spp_step` not used) or packed with `pack` > 1
    (`spp_step` samples a pixel, `scan_steps` 0 = pack*6 + max_bounces + 1).
    `offsets` ((K, 2), default `sample_offsets(64)`'s table) are its
    subpixel offsets.

    `stats`, a dict, receives "rays" (the rays the step's forward traced)
    and "done" (its samples that completed) as 0-d tensors on the device,
    read by no one until the caller does.
    """
    if fused_ad not in (True, False, "ext"):
        raise ValueError(f"fused_ad must be True, False or 'ext', got {fused_ad!r}")
    if pack < 1 or spp_step < 1:
        raise ValueError("pack and spp_step must be >= 1")
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
    default_offsets = integ.sample_offsets(64, device=dev)[0]

    def loss_fn(params, scene, target, sample0, offsets, stats):
        sc = apply_params(scene, params)
        if fused_ad is False:
            return scan_loss(sc, target, int(sample0), offsets, width=width, height=height,
                             max_bounces=max_bounces, pack=pack, scan_steps=scan_steps,
                             spp_step=spp_step, stats=stats)
        pix = torch.arange(n_pix, dtype=torch.int32, device=dev)
        summ, nv, rays = bounce_ad.sample_pixel_sums_fused(
            sc, pix, int(sample0) * spp_step, spp_step, width=width,
            height=height, max_bounces=max_bounces, scan_steps=scan_steps,
            use_ext=fused_ad == "ext", pack_plan=pack_plan)
        if stats is not None:
            stats.update(rays=rays, done=nv.sum())
        n_valid = nv[:, None]
        mean_color = summ / torch.clamp_min(n_valid, 1.0)
        err = torch.where(n_valid > 0, mean_color - target, 0.0)
        return torch.sum(err * err) / (n_pix * 3.0)

    def step(params, scene, target, sample0, lr, *, offsets=None, stats=None):
        scene = scene.to(dev)
        target = torch.as_tensor(target, dtype=torch.float32).to(dev)
        if tuple(target.shape) != (n_pix, 3):
            raise ValueError(f"target must have shape ({n_pix}, 3)")
        leaves = TrainParams(*(p.detach().to(dev).requires_grad_(True)
                               for p in params))
        loss = loss_fn(leaves, scene, target, sample0,
                       default_offsets if offsets is None else offsets, stats)
        grads = torch.autograd.grad(loss, list(leaves), allow_unused=True)
        grads = TrainParams(*(torch.zeros_like(p) if g is None else g
                              for p, g in zip(leaves, grads)))
        new_params = TrainParams(*((p - lr * g).detach()
                                   for p, g in zip(leaves, grads)))
        return new_params, loss.detach(), grads

    return step
