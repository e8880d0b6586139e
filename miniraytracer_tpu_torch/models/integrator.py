"""Forward-render entry points of the port (`miniraytracer_tpu/models/
integrator.py`): the bounce in tensor operations (`_shade_and_advance`,
`trace_paths`), the plain wavefront, the work-queue renderer, the renderer
pick and `render_auto`.

Four renderers: the fused render (`ops/bounce.py`), the hybrid step renderer
(`ops/hybrid.py`), and here the work queue (with its shading in the hybrid
machinery's step kernel, or in tensor operations) and the plain wavefront,
whose shading is `_shade_and_advance`: the nearest hit of
`intersect.scene_hit`, with the sweeps and the turbulence that
`intersect.make_accel` hands to kernels, then `materials.shade`.
"""

from __future__ import annotations

import math
import time as _time
from typing import NamedTuple

import torch

from miniraytracer_tpu_torch.models import camera as cam_mod
from miniraytracer_tpu_torch.models import materials as mat_mod
from miniraytracer_tpu_torch.ops import bounce, hybrid, rng
from miniraytracer_tpu_torch.ops import intersect as ix
from miniraytracer_tpu_torch.ops.vecmath import V3, vluminance, vwhere
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


def trace_paths(scene: T.SceneData, rays0: ix.Rays, keys, max_bounces: int,
                loop: str = "while", plain=False):
    """Radiance of one path for each primary ray in `rays0`, with `keys` the
    paths' root keys: bounces at depth 0..max_bounces (at max_bounces only
    emission and the background count) while any path is alive, one read of
    `any(alive)` by the host a bounce. Returns (radiance V3, rays traced as a
    0-d int64 tensor). The fixed-length `loop="scan"` of the AD paths is not
    ported (ROADMAP.md A11)."""
    if loop != "while":
        raise NotImplementedError(
            f"trace_paths(loop={loop!r}): the scan loop of the AD paths is not ported "
            "yet (ROADMAP.md A11)")
    n, dev = rays0.time.shape[0], rays0.time.device
    one, zero = torch.ones((n,), device=dev), torch.zeros((n,), device=dev)
    state = PathState(ro=rays0.ro, rd=rays0.rd, time=rays0.time, inside=rays0.inside,
                      beta=V3(one, one, one), radiance=V3(zero, zero, zero),
                      alive=torch.ones((n,), dtype=torch.bool, device=dev), keys=keys,
                      rays_traced=torch.zeros((), dtype=torch.int64, device=dev))
    accel = ix.make_accel(scene)
    depth = 0
    while depth <= max_bounces and bool(state.alive.any()):
        state = _bounce(scene, state, depth, max_bounces, accel, plain)
        depth += 1
    return state.radiance, state.rays_traced


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
                     max_bounces: int = 32, max_lum: float = 1000.0, plain: bool = False):
    """Full-frame plain-wavefront render on the scene's device. Returns
    (frame (H,W,3) f32 tensor, stats); stats["rays"] is the exact int ray
    count, stats["steps"] the number of wave steps."""
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
                            sample_base: int = 0, stats=None):
    """Render with a GLOBAL work queue (work_queue.cpp:133-175, at the
    granularity of one sample), on the scene's device. Work item w is (pixel
    w % n_pix, sample w // n_pix + sample_base), so early items sweep the
    whole frame. A lane whose path ends adds its sample to the
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
        pix = item % n_pix
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
                     chunk: int = 0, fused_shade="auto", plain: bool = False):
    """Whole-frame work-queue render on the scene's device. `n_lanes` = 0
    takes `wq_auto_lanes`. `chunk` > 0 renders the samples in blocks of that
    many, one queue each, merged at the end: stratification spans the full
    spp, so the estimator is that of the one-shot render up to the order of
    accumulation. `fused_shade` "auto" resolves through
    `hybrid.prefer_hybrid` (see `render_workqueue_pixels`). Returns (frame (H,W,3) f32 tensor, stats);
    stats["rays"] is the exact int ray count, stats["steps"] the number of
    queue steps, stats["claimed"] the items handed out."""
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
    render = {"fused": bounce.render_wavefront_fused,
              "hybrid": hybrid.render_wavefront_hybrid,
              "workqueue": render_workqueue,
              "wavefront": render_wavefront}[pick_renderer(scene)]
    return render(scene.to(resolve(device)), width, height, spp, max_bounces, max_lum)
