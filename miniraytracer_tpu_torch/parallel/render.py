"""Sharded rendering over a (dp, sp) mesh of `torch.distributed` ranks.

Port of `miniraytracer_tpu/parallel/render.py`, one process a device in
place of `shard_map`:

- pixels are split evenly over dp: the frame is padded to
  `_padded_size(n_pix, n_dp)` and rank (dp, sp) covers `local = n_pad // n_dp`
  pixels from `dp * local`; a padding lane re-renders the last pixel and its
  row is dropped on output (and its rays are counted, as the JAX package
  counts them);
- samples are split over sp: contiguous sample blocks (the wavefront and the
  work queue) or one progressive pass a rank (`render_pass_sharded`), summed
  over the sp group;
- every rank returns the same whole frame, gathered as a world sum of
  zero-padded buffers to which only sp index 0 of each dp row contributes
  (adding zeros is exact), and the exact int ray count summed over the world.

At sp = 1 every result equals the single-device renderer's bit for bit: the
per-pixel work is keyed by (pixel, sample) alone.
"""

from __future__ import annotations

import math
import time as _time

import torch

from miniraytracer_tpu_torch.models import integrator as integ
from miniraytracer_tpu_torch.ops import bounce
from miniraytracer_tpu_torch.parallel.mesh import Mesh


def _padded_size(n: int, ndp: int) -> int:
    return -(-n // ndp) * ndp


def _local_pixels(mesh: Mesh, n_pix: int, device):
    """(this rank's pixel ids (local,) int32 with the padding clamped to the
    last pixel, local)."""
    local = _padded_size(n_pix, mesh.n_dp) // mesh.n_dp
    pix = mesh.dp_index * local + torch.arange(local, dtype=torch.int32, device=device)
    return torch.clamp_max(pix, n_pix - 1), local


def _sample_block(mesh: Mesh, ns: int):
    """(first sample, count) of this rank's contiguous block of ns samples;
    the blocks' sizes differ by at most one."""
    base_n, rem = divmod(ns, mesh.n_sp)
    i = mesh.sp_index
    return i * base_n + min(i, rem), base_n + int(i < rem)


def _gather(mesh: Mesh, rows, width: int, height: int):
    """The whole (H, W, 3) frame on every rank from each dp row's `rows`."""
    local = rows.shape[0]
    full = torch.zeros((local * mesh.n_dp, 3), dtype=rows.dtype, device=rows.device)
    if mesh.sp_index == 0:
        full[mesh.dp_index * local:(mesh.dp_index + 1) * local] = rows
    return mesh.all_reduce(full, "world")[:width * height].reshape(height, width, 3)


def _stats(t0, rays: int, ns: int, mesh: Mesh, **extra) -> dict:
    elapsed = _time.perf_counter() - t0
    return {"seconds": elapsed, "rays": rays,
            "mrays_per_s": rays / elapsed / 1e6 if elapsed > 0 else 0.0,
            "spp": ns, "devices": mesh.size, **extra}


def make_frame(width: int, height: int, mesh: Mesh):
    """This rank's zero rows (local, 3) of the padded running average."""
    local = _padded_size(width * height, mesh.n_dp) // mesh.n_dp
    return torch.zeros((local, 3), dtype=torch.float32, device=mesh.device)


def render_pass_sharded(scene, frame, sample_idx: int, offsets, max_lum, *, width: int,
                        height: int, max_bounces: int, mesh: Mesh, loop: str = "while",
                        n_active: int | None = None):
    """One sharded progressive step: min(n_sp, n_active) passes over every
    pixel. `frame` is this rank's rows (`make_frame`) holding `sample_idx`
    samples; `offsets` the (ns, 2) offset table, of which sp rank i reads row
    i % ns for its pass `sample_idx + min(i, n_active - 1)`. A non-finite
    sample is replaced by the previous average (0 for the first sample);
    ranks at sp index n_active and past (the last, partial step of a render
    whose spp is not a multiple of n_sp) add nothing. The passes' mean over
    sp is merged with `merge_pass`. `scene` must be on `mesh.device`.
    Returns (this rank's rows', the step's rays summed over the world, a
    0-d int64 tensor)."""
    n_pix = width * height
    pix, local = _local_pixels(mesh, n_pix, frame.device)
    if tuple(frame.shape) != (local, 3):
        raise ValueError(f"frame must be this rank's ({local}, 3) rows (make_frame)")
    n_active = mesh.n_sp if n_active is None else int(n_active)
    i = mesh.sp_index
    active = i < n_active
    radiance_v, rays = integ.sample_radiance(
        scene, pix, sample_idx + min(i, n_active - 1), offsets[i % offsets.shape[0]],
        width=width, height=height, max_bounces=max_bounces, loop=loop)
    radiance = radiance_v.arr
    if active:
        finite = torch.isfinite(radiance).all(dim=-1, keepdim=True)
        color = torch.where(finite, radiance, frame if sample_idx > 0 else 0.0)
    else:
        color, rays = torch.zeros_like(radiance), torch.zeros_like(rays)
    n_act = torch.tensor(float(n_active), device=frame.device)
    color = mesh.all_reduce(color, "sp") / n_act
    new_frame = integ.merge_pass(frame, color, sample_idx, n_act, max_lum)
    return new_frame, mesh.all_reduce(rays.clone(), "world")


def render_distributed(scene, width: int, height: int, spp: int, mesh: Mesh,
                       max_bounces: int = 32, max_lum: float = 1000.0, loop: str = "while",
                       progress=None):
    """The progressive render sharded over `mesh`: a host loop of
    ceil(ns / n_sp) `render_pass_sharded` steps, step i reading the offset
    table rolled by i, the last step merging only the passes left.
    `progress(done, ns, rows)` is called after each step with this rank's
    rows. Returns (the whole frame (H, W, 3) tensor, stats) on every rank;
    stats["rays"] is the exact int ray count of the mesh."""
    scene = scene.to(mesh.device)
    offs, ns = integ.sample_offsets(spp, device=scene.device)
    frame = make_frame(width, height, mesh)
    ray_counts = []
    t0 = _time.perf_counter()
    i = 0
    while i < ns:
        frame, rays = render_pass_sharded(
            scene, frame, i, torch.roll(offs, -i, 0) if i else offs, max_lum, width=width,
            height=height, max_bounces=max_bounces, mesh=mesh, loop=loop,
            n_active=min(mesh.n_sp, ns - i))
        ray_counts.append(rays)
        i += mesh.n_sp
        if progress is not None:
            progress(min(i, ns), ns, frame)
    full = _gather(mesh, frame, width, height)
    total = int(torch.stack(ray_counts).sum()) if ray_counts else 0  # waits for the device
    return full, _stats(t0, total, ns, mesh)


def render_wavefront_distributed(scene, width: int, height: int, spp: int, mesh: Mesh,
                                 max_bounces: int = 32, max_lum: float = 1000.0,
                                 fused: bool | None = None):
    """The whole-frame wavefront sharded over `mesh`: sp rank i renders the
    contiguous sample block `lo = i*base_n + min(i, rem)`, `base_n + (i <
    rem)` samples, of its dp row's pixels, one lane a pixel; `accum` and
    `count` are summed over sp and divided by max(count, 1). `fused` None
    takes the fused kernel where `bounce.can_fuse(scene)` (kernel B1 through
    `bounce.render_wavefront_fused_pixels`), else the wavefront of tensor
    operations (`integrator.render_wavefront_pixels`). Returns (the whole
    frame (H, W, 3) tensor, stats) on every rank."""
    scene = scene.to(mesh.device)
    if fused is None:
        fused = bounce.can_fuse(scene)
    sq = math.isqrt(spp)
    ns = sq * sq
    t0 = _time.perf_counter()
    pix, _ = _local_pixels(mesh, width * height, scene.device)
    lo, cnt = _sample_block(mesh, ns)
    render = bounce.render_wavefront_fused_pixels if fused else integ.render_wavefront_pixels
    accum, count, rays = render(scene, pix, lo, cnt, max_lum, width=width, height=height,
                                max_bounces=max_bounces, spp_sq=sq)
    accum = mesh.all_reduce(accum.contiguous(), "sp")
    count = mesh.all_reduce(count.contiguous(), "sp")
    rows = accum / torch.clamp_min(count.to(torch.float32), 1.0)[:, None]
    total = mesh.all_reduce(rays.sum(dtype=torch.int64), "world")
    full = _gather(mesh, rows, width, height)
    return full, _stats(t0, int(total), ns, mesh,  # waits for the device
                        renderer="wavefront-fused" if fused else "wavefront")


def render_workqueue_distributed(scene, width: int, height: int, spp: int, mesh: Mesh,
                                 max_bounces: int = 32, max_lum: float = 1000.0,
                                 lanes_per_shard: int = 0):
    """The work queue sharded over `mesh`: one queue a rank over its dp row's
    `local` pixels (`pix_base = dp * local`) and its sp block of samples
    (`sample_base = lo`), `lanes_per_shard` lanes (0: `local`), shading in
    tensor operations (`fused_shade=False`, as the JAX package's sharded
    queue); `accum` and `count` summed over sp. Returns (the whole frame
    (H, W, 3) tensor, stats) on every rank."""
    scene = scene.to(mesh.device)
    n_pix = width * height
    local = _padded_size(n_pix, mesh.n_dp) // mesh.n_dp
    sq = math.isqrt(spp)
    ns = sq * sq
    t0 = _time.perf_counter()
    lo, cnt = _sample_block(mesh, ns)
    accum, count, rays = integ.render_workqueue_pixels(
        scene, local, lanes_per_shard or local, cnt, max_lum, width=width, height=height,
        max_bounces=max_bounces, spp_sq=sq, fused_shade=False,
        pix_base=mesh.dp_index * local, sample_base=lo)
    accum = mesh.all_reduce(accum.contiguous(), "sp")
    count = mesh.all_reduce(count.contiguous(), "sp")
    rows = accum / torch.clamp_min(count, 1.0)[:, None]
    total = mesh.all_reduce(rays.clone(), "world")
    full = _gather(mesh, rows, width, height)
    return full, _stats(t0, int(total), ns, mesh)  # waits for the device
