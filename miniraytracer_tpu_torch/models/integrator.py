"""Render entry points of the port (`miniraytracer_tpu/models/
integrator.py`): the bounce in tensor operations (`_shade_and_advance`,
`trace_paths`), the AD paths' scans (`sample_radiance`,
`sample_radiance_packed`), the plain wavefront, the work-queue renderer, the
progressive renderer (`render`, exported as `render_progressive`), the
renderer pick and `render_auto`.

Four forward renderers: the fused render (`ops/bounce.py`), the hybrid step
renderer (`ops/hybrid.py`), and here the work queue (with its shading in the
hybrid machinery's step kernel, or in tensor operations) and the plain
wavefront, whose shading is `_shade_and_advance`: the nearest hit of
`intersect.scene_hit`, with the sweeps and the turbulence that
`intersect.make_accel` hands to kernels, then `materials.shade`. The scans
run the same bounce under autograd over `make_accel(differentiable=True)`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time as _time
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from miniraytracer_tpu_torch.models import camera as cam_mod
from miniraytracer_tpu_torch.models import materials as mat_mod
from miniraytracer_tpu_torch.ops import bounce, hybrid, rng
from miniraytracer_tpu_torch.ops import intersect as ix
from miniraytracer_tpu_torch.ops.vecmath import V3, luminance, vdiv, vluminance, vwhere
from miniraytracer_tpu_torch.scene import types as T
from miniraytracer_tpu_torch.utils import profiling
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


# ---------------------------------------------------------------------------
# The bounce in tensor operations
# ---------------------------------------------------------------------------


class PathState(NamedTuple):
    ro: V3
    rd: V3
    time: torch.Tensor
    inside: torch.Tensor
    beta: V3  # throughput
    radiance: V3
    alive: torch.Tensor  # (N,) bool
    keys: torch.Tensor  # (N,) u32 (in int64) root key of each path
    rays_traced: torch.Tensor  # () int64


def _shade_and_advance(scene, rays: ix.Rays, keys_b, depth_ok, alive, beta: V3,
                       radiance: V3, accel=None, plain=False):
    """One bounce for every lane: the nearest hit (`intersect.scene_hit`),
    shading (`materials.shade`) and the radiance and throughput advance
    (`bounce.advance`, with the sky of `bounce.background_color`).
    `accel` is `intersect.make_accel`'s dict; with `plain` its kernels' plain
    versions run. Returns (rec, scatter, cont, beta', radiance')."""
    u_vol = (torch.stack([rng.uniform(keys_b, mat_mod.SLOT_VOL + vi)
                          for vi in range(scene.n_volumes)], dim=-1)
             if scene.n_volumes > 0 else None)
    rec = ix.scene_hit(scene, rays, u_vol, accel=accel, plain=plain)
    sc = mat_mod.shade(scene, rays, rec, keys_b, depth_ok, accel=accel, plain=plain)
    cont, beta, radiance = bounce.advance(alive, rec.hit, sc.scattered, sc.add_emitted,
                                          sc.emitted, sc.weight,
                                          bounce.background_color(scene.use_sky, rays.rd),
                                          beta, radiance)
    return rec, sc, cont, beta, radiance


def _bounce(scene, state: PathState, depth, max_bounces, accel=None, plain=False) -> PathState:
    """One bounce of every path at the common depth `depth`."""
    rays = ix.Rays(ro=state.ro, rd=state.rd, time=state.time, inside=state.inside)
    rec, sc, cont, beta, radiance = _shade_and_advance(
        scene, rays, rng.fold(state.keys, depth), torch.full_like(state.alive, depth < max_bounces),
        state.alive, state.beta, state.radiance, accel, plain)
    return PathState(
        ro=vwhere(cont, rec.p, state.ro), rd=vwhere(cont, sc.new_rd, state.rd),
        time=state.time, inside=torch.where(cont, sc.new_inside, state.inside),
        beta=beta, radiance=radiance, alive=cont, keys=state.keys,
        rays_traced=state.rays_traced + state.alive.sum())


def _records_grad(*objs) -> bool:
    """Whether autograd records and a tensor in `objs` (tuples, dicts and
    the scene's dataclasses searched) requires a gradient."""
    if not torch.is_grad_enabled():
        return False
    todo = list(objs)
    while todo:
        o = todo.pop()
        if isinstance(o, torch.Tensor):
            if o.requires_grad:
                return True
        elif isinstance(o, (tuple, list)):
            todo.extend(o)
        elif isinstance(o, dict):
            todo.extend(o.values())
        elif dataclasses.is_dataclass(o):
            todo.extend(getattr(o, f.name) for f in dataclasses.fields(o))
    return False


def _remat(remat: bool, fn, *args):
    """fn(*args); with `remat`, under `torch.utils.checkpoint`: the backward
    runs fn again instead of keeping its intermediates (the JAX package's
    `jax.checkpoint` of each bounce). The RNG is counter-based, so there is
    no generator state to restore, and the recompute gives the forward's
    values: every sweep is deterministic (the clustered triangle sweep's
    ray sort is a stable argsort)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def trace_paths(scene: T.SceneData, rays0: ix.Rays, keys, max_bounces: int,
                loop: str = "while", plain=False):
    """Radiance of one path for each primary ray in `rays0`, with `keys` the
    paths' root keys: bounces at depth 0..max_bounces (at max_bounces only
    emission and the background count). Returns (radiance V3, rays traced as
    a 0-d int64 tensor).

    `loop="while"` stops when no path is alive, one read of `any(alive)` by
    the host a bounce. `loop="scan"` is the AD paths' loop: exactly
    max_bounces + 1 bounces and no host read, over
    `make_accel(differentiable=True)` (the custom-VJP sweeps), each bounce
    rematerialised in the backward when a gradient is recorded."""
    if loop not in ("while", "scan"):
        raise ValueError(f"loop must be 'while' or 'scan', got {loop!r}")
    n, dev = rays0.time.shape[0], rays0.time.device
    one, zero = torch.ones((n,), device=dev), torch.zeros((n,), device=dev)
    state = PathState(ro=rays0.ro, rd=rays0.rd, time=rays0.time, inside=rays0.inside,
                      beta=V3(one, one, one), radiance=V3(zero, zero, zero),
                      alive=torch.ones((n,), dtype=torch.bool, device=dev), keys=keys,
                      rays_traced=torch.zeros((), dtype=torch.int64, device=dev))
    if loop == "scan":
        accel = ix.make_accel(scene, differentiable=True)
        remat = _records_grad(scene, accel, state)
        step = lambda sc, acc, s, depth: _bounce(sc, s, depth, max_bounces, acc, plain)
        for depth in range(max_bounces + 1):
            state = _remat(remat, step, scene, accel, state, depth)
        return state.radiance, state.rays_traced
    accel = ix.make_accel(scene)
    depth = 0
    while depth <= max_bounces and bool(state.alive.any()):
        state = _bounce(scene, state, depth, max_bounces, accel, plain)
        depth += 1
    return state.radiance, state.rays_traced


def _camera_rays(scene: T.SceneData, pix, samp, off_x, off_y, width: int, height: int):
    """Camera rays and root keys of the items (pixel `pix`, absolute sample
    `samp`) at subpixel offsets (off_x, off_y): film coordinates
    ((x + off_x) / width, (y + off_y) / height), pixel index x + y*width."""
    x = (pix % width).to(torch.float32)
    y = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    keys = rng.ray_key(pix, samp)
    return cam_mod.get_rays(scene.camera, vdiv(x + off_x, width),
                            vdiv(y + off_y, height), keys), keys


def sample_radiance(scene: T.SceneData, pix, sample_idx, offset, *, width: int, height: int,
                    max_bounces: int, loop: str = "while", plain: bool = False):
    """One radiance sample for each pixel in `pix` ((N,) integer, index
    x + y*width), sample `sample_idx` (an int or a 0-d tensor) at the
    subpixel `offset` ((2,) tensor) on the scene's device, through
    `trace_paths(loop=...)`. Returns (radiance V3, rays traced as a 0-d int64
    tensor)."""
    pix = pix.to(torch.int64)
    samp = torch.as_tensor(sample_idx, device=pix.device).to(torch.int64).expand_as(pix)
    offset = torch.as_tensor(offset, dtype=torch.float32, device=pix.device)
    rays, keys = _camera_rays(scene, pix, samp, offset[0], offset[1], width, height)
    return trace_paths(scene, rays, keys, max_bounces, loop=loop, plain=plain)


# ---------------------------------------------------------------------------
# The packed scan: lanes regenerated onto their next item inside the scan
# ---------------------------------------------------------------------------


class PackedState(NamedTuple):
    out: torch.Tensor  # (L, pack, 3) each item's radiance, written when it ends
    count: torch.Tensor  # (L,) i32 items completed = slot of the current item
    ro: V3
    rd: V3
    time: torch.Tensor
    inside: torch.Tensor
    beta: V3
    radiance: V3
    depth: torch.Tensor  # (L,) i32 bounce depth of the current item
    alive: torch.Tensor  # (L,) bool: the lane traces a path
    keys: torch.Tensor
    rays_traced: torch.Tensor  # () int64


def _select_slot(table2d, slot):
    """(L, pack) table, (L,) slot in [0, pack) -> (L,) row values."""
    return torch.gather(table2d, 1, slot.to(torch.int64)[:, None])[:, 0]


def _write_slot(table, slot, val, mask):
    """`table` (L, pack, 3) with `val` (L, 3) written into column `slot`
    (L,) of the rows where `mask`: the JAX package's masked one-hot column
    update (its TPU form, which scatters nothing) as one broadcast select,
    with the same values and the same gradient (the cotangent of `val` is
    that of the written entry, the overwritten entry gets none)."""
    cols = torch.arange(table.shape[1], device=slot.device)
    sel = mask[:, None] & (slot[:, None] == cols[None, :])
    return torch.where(sel[:, :, None], val[:, None, :], table)


def sample_radiance_packed(scene: T.SceneData, pix, sample_idx, offset, *, width: int,
                           height: int, max_bounces: int, pack: int = 8,
                           scan_steps: int = 0, plain: bool = False):
    """Differentiable radiance of one sample for each item of `pix` ((I,)
    integer pixel ids, I a multiple of `pack`), `pack` items assigned to
    each lane and lanes regenerated inside a scan of fixed length (the JAX
    package's `sample_radiance_packed`, the unpacked scan's estimator at a
    fraction of its lanes).

    Lane j owns items [j*pack, (j+1)*pack); when its path ends, the item's
    radiance goes into slot `count` and the lane claims its next item.
    Claims are gated to steps t < scan_steps - (max_bounces + 1), so every
    started item finishes inside the scan: an item is either completed
    exactly (the same counter-keyed path as the unpacked scan) or never
    started (`done` False), which depends only on the lane's other items,
    never on its own value. `scan_steps` 0 takes pack*6 + max_bounces + 1.
    `sample_idx` is an int, a 0-d or an (I,) tensor; `offset` a (2,) or an
    (I, 2) tensor. Each step is rematerialised in the backward when a
    gradient is recorded.

    Returns (radiance V3 (I,), done (I,) bool, rays traced as a 0-d int64
    tensor)."""
    n_items = pix.shape[0]
    if pack < 1 or n_items % pack:
        raise ValueError(f"{n_items} items are not a multiple of pack={pack}")
    lanes = n_items // pack
    if scan_steps <= 0:
        scan_steps = pack * 6 + max_bounces + 1
    claim_limit = scan_steps - (max_bounces + 1)
    if claim_limit < 0:
        raise ValueError(f"scan_steps={scan_steps} is less than max_bounces + 1")
    dev = pix.device
    pix2d = pix.to(torch.int64).reshape(lanes, pack)
    samp2d = torch.as_tensor(sample_idx, device=dev).to(torch.int64).reshape(-1).expand(
        n_items).reshape(lanes, pack)
    off = torch.as_tensor(offset, dtype=torch.float32, device=dev)
    off = off.expand(n_items, 2) if off.ndim == 1 else off
    offx2d, offy2d = off[:, 0].reshape(lanes, pack), off[:, 1].reshape(lanes, pack)
    accel = ix.make_accel(scene, differentiable=True)

    rays0, keys0 = _camera_rays(scene, pix2d[:, 0], samp2d[:, 0], offx2d[:, 0], offy2d[:, 0],
                                width, height)
    zero = torch.zeros((lanes,), dtype=torch.float32, device=dev)
    ones3, zero3 = V3(zero + 1.0, zero + 1.0, zero + 1.0), V3(zero, zero, zero)
    state = PackedState(
        out=torch.zeros((lanes, pack, 3), dtype=torch.float32, device=dev),
        count=torch.zeros((lanes,), dtype=torch.int32, device=dev),
        ro=rays0.ro, rd=rays0.rd, time=rays0.time, inside=rays0.inside,
        beta=ones3, radiance=zero3,
        depth=torch.zeros((lanes,), dtype=torch.int32, device=dev),
        alive=torch.ones((lanes,), dtype=torch.bool, device=dev), keys=keys0,
        rays_traced=torch.zeros((), dtype=torch.int64, device=dev))

    def step(scene_, acc, s: PackedState, t: int) -> PackedState:
        rays = ix.Rays(ro=s.ro, rd=s.rd, time=s.time, inside=s.inside)
        rec, sc, cont, beta, radiance = _shade_and_advance(
            scene_, rays, rng.fold(s.keys, s.depth), s.depth < max_bounces, s.alive, s.beta,
            s.radiance, acc, plain)
        finished = s.alive & ~cont
        out = _write_slot(s.out, s.count, radiance.arr, finished)
        count = torch.where(finished, s.count + 1, s.count)
        regen = finished & (count < pack) & (t < claim_limit)
        slot_new = torch.clamp_max(count, pack - 1)
        new_rays, new_keys = _camera_rays(
            scene_, _select_slot(pix2d, slot_new), _select_slot(samp2d, slot_new),
            _select_slot(offx2d, slot_new), _select_slot(offy2d, slot_new), width, height)
        return PackedState(
            out=out, count=count,
            ro=vwhere(regen, new_rays.ro, vwhere(cont, rec.p, s.ro)),
            rd=vwhere(regen, new_rays.rd, vwhere(cont, sc.new_rd, s.rd)),
            time=torch.where(regen, new_rays.time, s.time),
            inside=torch.where(regen, new_rays.inside,
                               torch.where(cont, sc.new_inside, s.inside)),
            beta=vwhere(regen, ones3, beta), radiance=vwhere(regen, zero3, radiance),
            depth=torch.where(regen, 0, s.depth + 1), alive=cont | regen,
            keys=torch.where(regen, new_keys, s.keys),
            rays_traced=s.rays_traced + s.alive.sum())

    remat = _records_grad(scene, accel, state)
    for t in range(scan_steps):
        state = _remat(remat, step, scene, accel, state, t)
    out = state.out.reshape(n_items, 3)
    slot = torch.arange(pack, dtype=torch.int32, device=dev).repeat(lanes)
    done = slot < torch.repeat_interleave(state.count, pack)
    return V3(out[:, 0], out[:, 1], out[:, 2]), done, state.rays_traced


# ---------------------------------------------------------------------------
# The plain wavefront: one lane per pixel, regenerated onto its next sample
# ---------------------------------------------------------------------------


def render_wavefront_pixels(scene: T.SceneData, pix, sample_lo: int, n_samples: int,
                            max_lum, *, width: int, height: int, max_bounces: int,
                            spp_sq: int, plain: bool = False, stats=None):
    """Render samples [sample_lo, sample_lo + n_samples) of each pixel in `pix`
    ((N,) int32, index x + y*width), one lane a pixel, on the scene's device.
    When a lane's path ends it folds the sample into its pixel's running
    average (the draw2 merge with its NaN reuse and luminance clamp,
    main.cpp:214-229) and starts the pixel's next sample. A step is the
    bounce of `_shade_and_advance` (kernels for a CUDA scene, their plain
    versions for a CPU scene or with `plain`) and `bounce.finish_step`, the
    merge of the fused render's plain version; the host reads `any(alive)`
    once a step. Returns (accum (N,3) f32 = running average * count, count
    (N,) i32, rays (N,) i32); `stats`, a dict, receives "steps"."""
    bounce.check_render_args(scene, pix, width, height, spp_sq, max_bounces)
    accel = ix.make_accel(scene)
    cam = bounce.camera_table(scene.camera)
    pix64 = pix.to(torch.int64)
    s = bounce.initial_lanes(scene, pix64, sample_lo, n_samples, width=width,
                             height=height, spp_sq=spp_sq)
    steps = 0
    while bool(s.alive.any()):
        rays = ix.Rays(ro=s.ro, rd=s.rd, time=s.time, inside=s.inside)
        rec, sc, cont, beta, radiance = _shade_and_advance(
            scene, rays, rng.fold(s.keys, s.depth), s.depth < max_bounces, s.alive, s.beta,
            s.radiance, accel, plain)
        s = bounce.finish_step(cam, width, height, spp_sq, max_lum, sample_lo, n_samples,
                               pix64, s, cont, rec.p, sc.new_rd, sc.new_inside, beta, radiance)
        steps += 1
    if stats is not None:
        stats["steps"] = steps
    return s.accum.arr, s.count, s.rays


def render_wavefront(scene: T.SceneData, width: int, height: int, spp: int,
                     max_bounces: int = 32, max_lum: float = 1000.0, plain: bool = False,
                     device=None):
    """Full-frame plain-wavefront render on `device` (None means the GPU, and
    raises when there is none; the scene is moved there). Returns (frame
    (H,W,3) f32 tensor, stats); stats["rays"] is the exact int ray count,
    stats["steps"] the number of wave steps."""
    scene = scene.to(resolve(device))
    sq = int(math.isqrt(spp))
    ns = sq * sq
    t0 = _time.perf_counter()
    pix = torch.arange(width * height, dtype=torch.int32, device=scene.device)
    stats = {}
    accum, count, rays = render_wavefront_pixels(
        scene, pix, 0, ns, max_lum, width=width, height=height, max_bounces=max_bounces,
        spp_sq=sq, plain=plain, stats=stats)
    frame = accum / torch.clamp_min(count.to(torch.float32), 1.0)[:, None]
    total = int(rays.sum(dtype=torch.int64))  # waits for the device
    elapsed = _time.perf_counter() - t0
    return frame.reshape(height, width, 3), {
        "seconds": elapsed,
        "rays": total,
        "mrays_per_s": total / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": ns,
        "steps": stats["steps"],
        "renderer": "wavefront",
    }


# ---------------------------------------------------------------------------
# Work queue: lanes decoupled from pixels
# ---------------------------------------------------------------------------


def render_workqueue_pixels(scene: T.SceneData, n_pix: int, n_lanes: int, n_samples: int,
                            max_lum, *, width: int, height: int, max_bounces: int,
                            spp_sq: int, fused_shade: bool = True, plain: bool = False,
                            pix_base: int = 0, sample_base: int = 0, stats=None):
    """Render with a GLOBAL work queue (work_queue.cpp:133-175, at the
    granularity of one sample), on the scene's device. Work item w is (pixel
    w % n_pix + pix_base, sample w // n_pix + sample_base), so early items
    sweep the whole frame; its row of the frame is w % n_pix. A pixel past
    the image (a padded shard of `parallel/render.py`) is clamped to the last
    one, whose repeat the caller drops. A lane whose path ends adds its sample to the
    frame and claims the next item at once, by an exclusive prefix sum over
    the lanes that finished: occupancy stays high when a few pixels (through
    glass) need ten times the bounces of the rest, where a pixel-pinned loop
    ends with its slowest pixel.

    Shading is the hybrid machinery's step kernel with `fused_shade`
    (`hybrid.make_workqueue_shader`), else `_shade_and_advance` over
    `intersect.make_accel`: the kernels for a CUDA scene, their plain
    versions for a CPU scene or with `plain`. Claiming, merging and
    regeneration are tensor operations, with one `any(alive)` read by the
    host a step.

    Against the pixel-pinned renderers' merge: samples accumulate out of
    order, the luminance clamp applies to each sample (not to the running
    average), and a non-finite sample is dropped. Equal in expectation. On a
    CUDA device the merge adds with float atomics, and two lanes can hold the
    same pixel in one step, so a frame repeats only to rounding; claims and
    ray counts repeat exactly.

    Returns (accum (n_pix, 3) f32 sums, count (n_pix,) f32, rays traced as a
    0-d int64 tensor). `stats`, a dict, receives "steps" and "claimed" (items
    handed out, the first `n_lanes` included)."""
    if (min(n_pix, n_lanes, width, height, spp_sq) < 1 or n_pix > width * height
            or max_bounces < 0 or n_samples < 0):
        raise ValueError("n_pix (at most width * height), n_lanes, width, height and "
                         "spp_sq must be >= 1, max_bounces and n_samples >= 0")
    dev = scene.device
    total_items = n_pix * n_samples
    if fused_shade:
        shader = hybrid.make_workqueue_shader(scene, plain=plain)
    else:
        accel = ix.make_accel(scene)

        def shader(rays, keys_b, depth_ok, alive, beta, radiance):
            rec, sc, cont, beta, radiance = _shade_and_advance(
                scene, rays, keys_b, depth_ok, alive, beta, radiance, accel, plain)
            return rec.p, sc.new_rd, sc.new_inside, cont, beta, radiance

    def camera_rays(item):
        pix = torch.clamp(item % n_pix + pix_base, 0, width * height - 1)
        samp = torch.div(item, n_pix, rounding_mode="floor") + sample_base
        ss, tt = bounce.film_coords(pix, samp, width, height, spp_sq)
        keys = rng.ray_key(pix, samp)
        return cam_mod.get_rays(scene.camera, ss, tt, keys), keys

    n = n_lanes
    item = torch.arange(n, dtype=torch.int64, device=dev)
    rays0, keys = camera_rays(item)
    ro, rd, time, inside = rays0.ro, rays0.rd, rays0.time, rays0.inside
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    ones3, zero3 = V3(zero + 1.0, zero + 1.0, zero + 1.0), V3(zero, zero, zero)
    beta, radiance = ones3, zero3
    depth = torch.zeros((n,), dtype=torch.int32, device=dev)
    alive = item < total_items
    # rows [0, n_pix) are the frame (r, g, b, count); a lane with nothing to
    # add adds zeros to a row of its own behind them, so that no two lanes
    # meet on one dummy row
    frame = torch.zeros((n_pix + n, 4), dtype=torch.float32, device=dev)
    own_row = n_pix + item
    next_item = torch.full((), n, dtype=torch.int64, device=dev)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    steps = 0
    while bool(alive.any()):
        keys_b = rng.fold(keys, depth)
        p_next, adv_rd, adv_inside, cont, beta, radiance = shader(
            ix.Rays(ro=ro, rd=rd, time=time, inside=inside), keys_b,
            depth < max_bounces, alive, beta, radiance)
        finished = alive & ~cont

        # ---- add finished samples to the frame ----
        ok = (finished & torch.isfinite(radiance.x) & torch.isfinite(radiance.y)
              & torch.isfinite(radiance.z))
        lum = vluminance(radiance)
        scale = torch.where(lum > max_lum, max_lum / torch.clamp_min(lum, 1e-12), 1.0)
        okf = ok.to(torch.float32)
        add = torch.stack([*(torch.where(ok, c * scale, 0.0) for c in radiance), okf], dim=1)
        frame.index_add_(0, torch.where(ok, item % n_pix, own_row), add)

        # ---- claim new items: the prefix sum is the queue's fetch-and-add ----
        fin_i = finished.to(torch.int64)
        upto = torch.cumsum(fin_i, dim=0)
        new_item = torch.where(finished, next_item + upto - fin_i, item)
        regen = finished & (new_item < total_items)
        new_rays, new_keys = camera_rays(torch.where(regen, new_item, 0))

        rays_traced = rays_traced + alive.sum()
        next_item = next_item + upto[-1]
        item = new_item
        ro = vwhere(regen, new_rays.ro, vwhere(cont, p_next, ro))
        rd = vwhere(regen, new_rays.rd, vwhere(cont, adv_rd, rd))
        time = torch.where(regen, new_rays.time, time)
        inside = torch.where(regen, new_rays.inside, torch.where(cont, adv_inside, inside))
        beta = vwhere(regen, ones3, beta)
        radiance = vwhere(regen, zero3, radiance)
        depth = torch.where(regen, 0, depth + 1)
        alive = cont | regen
        keys = torch.where(regen, new_keys, keys)
        steps += 1
    if stats is not None:
        stats["steps"] = stats.get("steps", 0) + steps
        stats["claimed"] = stats.get("claimed", 0) + int(next_item)
    return frame[:n_pix, :3], frame[:n_pix, 3], rays_traced


def wq_auto_lanes(scene: T.SceneData, n_pix: int) -> int:
    """Lanes of the work queue when the caller names none: the JAX package's
    two values (65,536 with an external box set, whose sweep holds a
    (boxes, lanes) grid; 131,072 otherwise), so that both packages claim
    alike. Whether they suit a GPU is an open measurement (PERF.md)."""
    cap = 65_536 if hybrid._ext_types(scene)[2] else 131_072
    return min(n_pix, cap)


def render_workqueue(scene: T.SceneData, width: int, height: int, spp: int,
                     max_bounces: int = 32, max_lum: float = 1000.0, n_lanes: int = 0,
                     chunk: int = 0, fused_shade="auto", plain: bool = False, device=None):
    """Whole-frame work-queue render on `device` (None means the GPU, and
    raises when there is none; the scene is moved there). `n_lanes` = 0
    takes `wq_auto_lanes`. `chunk` > 0 renders the samples in blocks of that
    many, one queue each, merged at the end: stratification spans the full
    spp, so the estimator is that of the one-shot render up to the order of
    accumulation. `fused_shade` "auto" resolves through
    `hybrid.prefer_hybrid` (see `render_workqueue_pixels`). Returns (frame (H,W,3) f32 tensor, stats);
    stats["rays"] is the exact int ray count, stats["steps"] the number of
    queue steps, stats["claimed"] the items handed out."""
    scene = scene.to(resolve(device))
    if fused_shade == "auto":
        fused_shade = hybrid.prefer_hybrid(scene)
    sq = int(math.isqrt(spp))
    ns = sq * sq
    n_pix = width * height
    lanes = n_lanes or wq_auto_lanes(scene, n_pix)
    t0 = _time.perf_counter()
    stats = {}
    accum = count = rays = None
    block = chunk if 0 < chunk < ns else max(ns, 1)
    for base in range(0, max(ns, 1), block):
        a, c, r = render_workqueue_pixels(
            scene, n_pix, lanes, min(block, ns - base), max_lum, width=width,
            height=height, max_bounces=max_bounces, spp_sq=sq,
            fused_shade=bool(fused_shade), plain=plain, sample_base=base, stats=stats)
        accum, count, rays = (a, c, r) if accum is None else (accum + a, count + c, rays + r)
    frame = accum / torch.clamp_min(count, 1.0)[:, None]
    total = int(rays)  # waits for the device
    elapsed = _time.perf_counter() - t0
    return frame.reshape(height, width, 3), {
        "seconds": elapsed,
        "rays": total,
        "mrays_per_s": total / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": ns,
        "steps": stats["steps"],
        "claimed": stats["claimed"],
        "lanes": lanes,
        "renderer": "workqueue",
    }


# ---------------------------------------------------------------------------
# The progressive renderer: one sample of every pixel a pass (draw2)
# ---------------------------------------------------------------------------


def merge_pass(frame, color, sample_idx, n_new, max_lum):
    """Fold `n_new` fresh per-pixel sample averages `color` (N, 3) into the
    running average `frame` (N, 3) that holds `sample_idx` samples already
    (draw2, main.cpp:221-229): the incremental average, then the luminance
    clamp on the running average. `color` must be finite already. The
    average's weight is computed in float32, as the JAX package does."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=frame.device)
    k, n_new = f32(sample_idx), f32(n_new)
    # tensor / tensor: torch divides a Python number by a tensor as a
    # multiplication by the reciprocal, an ulp away from the division
    new_frame = torch.where(k > 0, frame + (color - frame) * (n_new / (k + n_new)), color)
    lum = luminance(new_frame)
    scale = torch.where(lum > max_lum, f32(max_lum) / torch.clamp_min(lum, 1e-12), 1.0)
    return new_frame * scale[:, None]


def render_pixels(scene: T.SceneData, frame, pix, sample_idx, offset, max_lum, *,
                  width: int, height: int, max_bounces: int, loop: str = "while",
                  plain: bool = False):
    """One progressive pass over the pixels `pix`, whose running averages
    are the rows of `frame` (N, 3): sample `sample_idx` of each at the
    subpixel `offset` (`sample_radiance`), a non-finite sample replaced by
    the pixel's previous average (0 for the first sample; main.cpp:214-219),
    then `merge_pass`. Returns (frame', rays traced as a 0-d int64 tensor)."""
    radiance_v, rays = sample_radiance(scene, pix, sample_idx, offset, width=width,
                                       height=height, max_bounces=max_bounces, loop=loop,
                                       plain=plain)
    radiance = radiance_v.arr
    finite = torch.isfinite(radiance).all(dim=-1, keepdim=True)
    first = torch.as_tensor(sample_idx, device=frame.device) <= 0
    color = torch.where(finite, radiance, torch.where(first, 0.0, frame))
    return merge_pass(frame, color, sample_idx, 1.0, max_lum), rays


def render_tile_pass(scene: T.SceneData, frame_rows, pix, sample_idx, offset, max_lum, *,
                     width: int, height: int, max_bounces: int, loop: str = "while",
                     plain: bool = False):
    """One progressive pass over one batch of tile pixels (the pass behind
    the JAX package's CLI preview, which sweeps the frame in Hilbert tile
    order): `render_pixels` over `pix` and its rows `frame_rows`."""
    return render_pixels(scene, frame_rows, pix, sample_idx, offset, max_lum, width=width,
                         height=height, max_bounces=max_bounces, loop=loop, plain=plain)


def render_pass(scene: T.SceneData, frame, sample_idx, offset, max_lum, *, width: int,
                height: int, max_bounces: int, loop: str = "while", plain: bool = False):
    """One progressive pass over every pixel: `frame` is the (H*W, 3) running
    average, pixel index x + y*width with y from the bottom (flip the rows
    for display). Returns (frame', rays traced as a 0-d int64 tensor)."""
    pix = torch.arange(width * height, dtype=torch.int64, device=frame.device)
    return render_pixels(scene, frame, pix, sample_idx, offset, max_lum, width=width,
                         height=height, max_bounces=max_bounces, loop=loop, plain=plain)


def render(scene: T.SceneData, width: int, height: int, spp: int, max_bounces: int = 32,
           max_lum: float = 1000.0, loop: str = "while", device=None, progress=None,
           plain: bool = False):
    """The progressive render (exported as `render_progressive`): a host loop
    of passes of one sample of every pixel (`render_pass`), over the
    stratified offsets of `sample_offsets(spp)`, on `device` (None means the
    GPU, and raises when there is none; the scene is moved there).
    `progress(i, ns, frame)` is called after pass i. The ray counts are
    summed once at the end, with no read by the host between passes.
    Returns (frame (H, W, 3) float32 tensor, stats); stats["rays"] is the
    exact int ray count."""
    scene = scene.to(resolve(device))
    dev = scene.device
    offs, ns = sample_offsets(spp, device=dev)
    frame = torch.zeros((width * height, 3), dtype=torch.float32, device=dev)
    ray_counts = []
    t0 = _time.perf_counter()
    for i in range(ns):
        frame, rays = render_pass(scene, frame, i, offs[i], max_lum, width=width,
                                  height=height, max_bounces=max_bounces, loop=loop,
                                  plain=plain)
        ray_counts.append(rays)
        if progress is not None:
            progress(i + 1, ns, frame)
    total = int(torch.stack(ray_counts).sum()) if ray_counts else 0  # waits for the device
    elapsed = _time.perf_counter() - t0
    return frame.reshape(height, width, 3), {
        "seconds": elapsed,
        "rays": total,
        "mrays_per_s": total / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": ns,
        "renderer": "progressive",
    }


def pick_renderer(scene: T.SceneData) -> str:
    """The JAX package's forward-renderer rule, as it evaluates on its
    accelerator: "fused" for the fused class (`bounce.can_fuse`);
    "workqueue" for scenes heavy in intersection (2000 primitives or more, a
    box counted six times), for scenes of the hybrid class with an image
    texture, and for other scenes with 64 primitives or more; "hybrid" for
    imageless scenes of the hybrid class; "wavefront" for the rest. The rule
    is carried over as it stands; the rates behind it were measured on
    another accelerator, and which renderer is faster on a GPU is an open
    measurement (PERF.md)."""
    if bounce.can_fuse(scene):
        return "fused"
    # a box costs about 6 rect tests in the sweep (box.h decomposition)
    heavy = scene.n_tris + scene.n_spheres + 6 * scene.n_boxes
    if heavy >= 2000:
        return "workqueue"
    if hybrid.prefer_hybrid(scene):
        return "workqueue" if scene.has_image else "hybrid"
    if heavy >= 64:
        return "workqueue"
    return "wavefront"


def render_auto(scene, width, height, spp, max_bounces=32, max_lum=1000.0,
                device=None):
    """Render with the picked forward renderer on `device`: None means the
    GPU (raises when there is none), and the scene is moved there. Returns
    (frame (H,W,3) float32 tensor on that device, stats)."""
    with profiling.span("mrt.render"):
        dev = resolve(device)
        renderers = {"fused": bounce.render_wavefront_fused,
                     "hybrid": hybrid.render_wavefront_hybrid,
                     "workqueue": functools.partial(render_workqueue, device=dev),
                     "wavefront": functools.partial(render_wavefront, device=dev)}
        render = renderers[pick_renderer(scene)]
        return render(scene.to(dev), width, height, spp, max_bounces, max_lum)
