"""Differentiable render step ("train step"), on one device or on a mesh.

Port of `miniraytracer_tpu/parallel/train.py`: each step renders samples of
every pixel, takes
the SSE loss against a target image over the pixels that completed a
sample, and gets the gradients w.r.t. `TrainParams` (material albedo,
emission, gloss / refraction index, sphere and triangle geometry). Three
renderers: the fused AD scan (`ops/bounce_ad.py`, the scan step kernel and
its hand-written backward kernel); its hybrid-ext form for scenes outside
the fused class; and the JAX package's default, the scans of
`models/integrator.py` (`fused_ad=False`: the bounce in tensor operations
under autograd, one item a lane or `pack` of them, each step
rematerialised), whose sweeps are the custom-VJP kernels of
`intersect.make_accel(differentiable=True)`. On a (dp, sp) mesh of ranks
(`parallel/mesh.py`) each rank renders its pixels and samples, and the loss
and the gradients are summed over the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from miniraytracer_tpu_torch.models import integrator as integ
from miniraytracer_tpu_torch.ops import bounce_ad, hybrid
from miniraytracer_tpu_torch.parallel.mesh import Mesh, _mesh_device, sp_sum
from miniraytracer_tpu_torch.parallel.render import _padded_size
from miniraytracer_tpu_torch.scene import types as T
from miniraytracer_tpu_torch.utils import profiling
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


def _scan_sums(scene: T.SceneData, pix, sample0: int, offsets, sp_i: int, *, width: int,
               height: int, max_bounces: int, pack: int, scan_steps: int, spp_step: int,
               plain: bool):
    """The scans' per-pixel (radiance sum (N, 3), valid count (N, 3), rays,
    samples done) of sp cell `sp_i`'s samples of the pixels `pix` ((N,)
    int64), with the JAX package's sample mapping (`parallel/train.py`):
    unpacked, sample `sample0 + sp_i` at `offsets[sp_i % K]`; packed, items
    `sample0*spp_step + sp_i*spp_step + s` for s < `spp_step`."""
    n = pix.shape[0]
    k = offsets.shape[0]
    kw = dict(width=width, height=height, max_bounces=max_bounces, plain=plain)
    if pack > 1:
        n_items = n * spp_step
        samp = (sample0 * spp_step + sp_i * spp_step
                + torch.arange(spp_step, device=pix.device).repeat_interleave(n))
        off = offsets[samp % k] if spp_step > 1 else offsets[sp_i % k].expand(n_items, 2)
        pix_items = pix.repeat(spp_step)
        tail = -n_items % pack
        if tail:
            pix_items = torch.cat([pix_items, pix_items[-1:].expand(tail)])
            samp = torch.cat([samp, samp[-1:].expand(tail)])
            off = torch.cat([off, off[-1:].expand(tail, 2)])
        rad, done, rays = integ.sample_radiance_packed(scene, pix_items, samp, off, pack=pack,
                                                       scan_steps=scan_steps, **kw)
        rad = rad.arr[:n_items].reshape(spp_step, n, 3)
        val = done[:n_items].reshape(spp_step, n, 1) & torch.isfinite(rad)
        return (torch.where(val, rad, 0.0).sum(0), val.to(torch.float32).sum(0), rays,
                done[:n_items].sum())
    rad, rays = integ.sample_radiance(scene, pix, sample0 + sp_i, offsets[sp_i % k],
                                      loop="scan", **kw)
    radiance = torch.where(torch.isfinite(rad.arr), rad.arr, 0.0)
    # as the JAX package counts: after the non-finite samples became 0
    return (radiance, torch.isfinite(radiance).to(torch.float32), rays,
            torch.full((), n, device=pix.device))


def _sse(radiance, n_valid, target, in_image=True):
    """SSE of the per-pixel mean radiance / n_valid against `target` over
    the pixels `in_image` with a counted sample."""
    mean_color = radiance / torch.clamp_min(n_valid, 1.0)
    err = torch.where(in_image & (n_valid > 0), mean_color - target, 0.0)
    return torch.sum(err * err)


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
    radiance, n_valid, rays, done = _scan_sums(
        scene, pix, sample0, offsets, 0, width=width, height=height, max_bounces=max_bounces,
        pack=pack, scan_steps=scan_steps, spp_step=spp_step, plain=plain)
    if stats is not None:
        stats.update(rays=rays, done=done)
    return _sse(radiance, n_valid, target) / (n_pix * 3.0)


def make_train_step(*, width: int, height: int, max_bounces: int, pack: int = 1,
                    scan_steps: int = 0, spp_step: int = 1, device=None,
                    fused_ad=True, scene: T.SceneData | None = None, mesh: Mesh | None = None):
    """The train step, on one device or on a (dp, sp) mesh of ranks.

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

    `mesh` (`parallel.mesh.make_mesh`; None: one device) runs the step on
    every rank of the mesh, on `mesh.device`, with the JAX package's sample
    mapping: rank (dp, sp) renders its dp row of `_padded_size(width*height,
    n_dp) // n_dp` pixels (past the image: the last pixel, masked out of the
    loss) for its sp cell's samples: fused and ext samples
    [(sample0 + sp)*spp_step, (sample0 + sp + 1)*spp_step), packed items
    `sample0*spp_step + sp*spp_step + s`, unpacked sample `sample0 + sp` at
    `offsets[sp % K]`. So a step consumes n_sp*spp_step samples, and
    consecutive steps overlap unless the caller steps `sample0` by n_sp, as
    in the JAX package. A (dp, n_sp) mesh at spp_step k trains on the samples
    of one device at spp_step k*n_sp where every sample completes (fused and
    ext: the scan claims samples only before a gate that scales with
    spp_step, so a short scan drops a few, a different few for each split).
    The (radiance sum, valid count) pairs are summed over
    sp (`parallel.mesh.sp_sum`, whose backward is the identity), each dp row's SSE is
    counted once (a sum over the dp group), and the backward's gradients are
    summed over the world, so every rank applies the same update. The loss
    is the one stated above over the n_sp*spp_step samples: the JAX
    package's mesh step returns n_sp times it, and n_sp times its gradients
    (ROADMAP.md, queue C). `target` is the whole (width*height, 3) or padded
    image, or this rank's rows (`render.make_frame`'s layout).

    `stats`, a dict, receives "rays" (the rays the step's forward traced)
    and "done" (its samples that completed) as 0-d tensors on the device,
    read by no one until the caller does; on a mesh, summed over the world,
    the padding lanes included.
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
            raise ValueError(f"scene {scene.name!r} is outside the hybrid-ext class "
                             "(see bounce_ad.can_fuse_ad_ext)")
        if hybrid.ext_mat_mode(scene):
            pack_plan = hybrid.smem_plan(scene)
    if mesh is None:
        mesh = Mesh(1, 1, 0, 0, resolve(device))
    elif device is not None and _mesh_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    dev = mesh.device
    n_pix = width * height
    n_pad = _padded_size(n_pix, mesh.n_dp)
    local = n_pad // mesh.n_dp
    first = mesh.dp_index * local
    lanes = first + torch.arange(local, dtype=torch.int64, device=dev)
    in_image = (lanes < n_pix)[:, None]
    pix = torch.clamp_max(lanes, n_pix - 1)
    sp_i = mesh.sp_index
    default_offsets = integ.sample_offsets(64, device=dev)[0]

    def target_rows(target):
        target = torch.as_tensor(target, dtype=torch.float32).to(dev)
        if target.dim() == 2 and target.shape[1] == 3:
            if target.shape[0] == local:
                return target
            if target.shape[0] in (n_pix, n_pad):
                pad = torch.zeros((n_pad - target.shape[0], 3), device=dev)
                return torch.cat([target, pad])[first:first + local]
        shapes = sorted({(n_pix, 3), (n_pad, 3), (local, 3)})
        raise ValueError(f"target must have shape {' or '.join(map(str, shapes))}")

    def shard_sse(params, scene, target_l, sample0, offsets, stats):
        sc = apply_params(scene, params)
        if fused_ad is False:
            offsets = torch.as_tensor(offsets, dtype=torch.float32).to(dev)
            radiance, n_valid, rays, done = _scan_sums(
                sc, pix, int(sample0), offsets, sp_i, width=width, height=height,
                max_bounces=max_bounces, pack=pack, scan_steps=scan_steps, spp_step=spp_step,
                plain=False)
        else:
            radiance, nv, rays = bounce_ad.sample_pixel_sums_fused(
                sc, pix.to(torch.int32), (int(sample0) + sp_i) * spp_step, spp_step,
                width=width, height=height, max_bounces=max_bounces, scan_steps=scan_steps,
                use_ext=fused_ad == "ext", pack_plan=pack_plan)
            n_valid, done = nv[:, None], nv.sum()
        if stats is not None:
            stats.update(rays=mesh.all_reduce(rays.clone(), "world"),
                         done=mesh.all_reduce(done.clone(), "world"))
        radiance = sp_sum(radiance, mesh)
        n_valid = mesh.all_reduce(n_valid.detach().clone(), "sp")
        return _sse(radiance, n_valid, target_l, in_image)

    def step(params, scene, target, sample0, lr, *, offsets=None, stats=None):
        with profiling.span("mrt.step"):
            scene = scene.to(dev)
            target_l = target_rows(target)
            leaves = TrainParams(*(p.detach().to(dev).requires_grad_(True)
                                   for p in params))
            with profiling.span("mrt.step.forward"):
                sse = shard_sse(leaves, scene, target_l, sample0,
                                default_offsets if offsets is None else offsets, stats)
            with profiling.span("mrt.step.backward"):
                grads = torch.autograd.grad(sse / (n_pix * 3.0), list(leaves),
                                            allow_unused=True)
            with profiling.span("mrt.step.update"):
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves, grads)]
                if mesh.distributed:
                    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), "world")
                    grads = [f.view_as(g)
                             for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
                grads = TrainParams(*grads)
                loss = mesh.all_reduce(sse.detach().clone(), "dp") / (n_pix * 3.0)
                new_params = TrainParams(*((p - lr * g).detach()
                                           for p, g in zip(leaves, grads)))
            return new_params, loss, grads

    return step
