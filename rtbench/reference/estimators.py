"""What the program's timed calls return, worked out again by the plain tracer.

- `frame_pixels`: pixels of a rendered frame (`render(scene, W, H, spp)` of
  the fused class): every sample of each pixel traced on its own, then folded
  into the pixel in sample order as the renderer folds it (the draw2 running
  average with its NaN reuse and luminance clamp), divided by the count.
- `fit_step`: one SGD step of the differentiable render
  (`make_train_step(fused_ad=True)`): the samples [sample0*spp, (sample0+1)*spp)
  of every pixel at an 8x8 stratified offset, the scan's claim gate worked out
  from each path's length (a pixel's next sample starts in the sub-step where
  the last one ends, and only before `claim_limit`), the SSE of the per-pixel
  mean of the finite samples against the target over width*height*3, its
  gradient by autograd through a second trace of the counted samples, and the
  update p - lr*g.
"""

from __future__ import annotations

import torch

from rtbench.reference import tracer

# the leaves a train step updates, as the program's TrainParams names them
PARAMS = ("tex_c0", "tex_c1", "mat_param", "sph_c0", "sph_radius", "tri_m")


def frame_pixels(scene, pix, spp: int, *, width: int, height: int, max_bounces: int,
                 max_lum: float = 1000.0, dt=torch.float32, device=None):
    """Pixels `pix` ((P,) int64) of the frame: (P, 3)."""
    sq = int(spp ** 0.5)
    while (sq + 1) * (sq + 1) <= spp:
        sq += 1
    ns = sq * sq
    sc = tracer.pack(scene, dt, device)
    pix = pix.to(sc.cam.device)
    p = pix.shape[0]
    samp = torch.arange(ns, device=pix.device).repeat_interleave(p)
    rad, _ = tracer.trace(sc, pix.repeat(ns), samp, width=width, height=height, sq=sq,
                          max_bounces=max_bounces)
    rad = rad.reshape(ns, p, 3)
    accum = torch.zeros((p, 3), dtype=dt, device=pix.device)
    for j in range(ns):
        cnt = torch.full((p, 1), float(j), dtype=dt, device=pix.device)
        prev = accum * (1.0 / torch.clamp_min(cnt, 1.0)) if j else torch.zeros_like(accum)
        color = torch.where(torch.isfinite(rad[j]).all(1, keepdim=True), rad[j], prev)
        avg = prev + (color - prev) * (1.0 / (cnt + 1.0)) if j else color
        lum = (0.212655 * avg[:, 0] + 0.715158 * avg[:, 1] + 0.072187 * avg[:, 2])[:, None]
        avg = avg * torch.where(lum > max_lum, max_lum / torch.clamp_min(lum, 1e-12), 1.0)
        accum = avg * (cnt + 1.0)
    return accum / torch.full_like(accum, float(ns))


def claim_limit(spp: int) -> int:
    """The sub-step from which the train step's scan claims no sample: it
    runs `spp*6 + max_bounces + 1` sub-steps, the last `max_bounces + 1` of
    them claiming nothing, so every claimed sample ends inside the scan."""
    return spp * 6


def fit_step(scene, params: dict, target, sample0: int, lr: float, *, width: int,
             height: int, spp: int, max_bounces: int, dt=torch.float32, chunk: int = 1 << 23,
             grad_chunk: int = 1 << 22):
    """One train step from `params` ({name: tensor}, the PARAMS leaves) on the
    device of `target` ((width*height, 3)). Returns (loss, grads, new params,
    samples done), the grads and params as {name: float32 tensor}."""
    dev = target.device
    n_pix = width * height
    claim = claim_limit(spp)
    sb = sample0 * spp
    n = n_pix * spp  # sample-major: item i is sample i // n_pix of pixel i % n_pix
    leaves = {k: params[k].detach().to(device=dev, dtype=dt) for k in PARAMS}
    with torch.no_grad():
        sc = tracer.pack(scene, dt, dev, leaves)
        i = torch.arange(n, device=dev)
        pix = i % n_pix
        rad, rays, levels = tracer.paths(
            sc, pix, sb + torch.div(i, n_pix, rounding_mode="floor"), width=width,
            height=height, sq=8, max_bounces=max_bounces, chunk=chunk, keep=True)
        del i
        rad, rays = rad.reshape(spp, n_pix, 3), rays.reshape(spp, n_pix)
        before = torch.cumsum(rays, 0) - rays  # sub-steps the earlier samples took
        started = before <= claim
        started[0] = True
        take = started & torch.isfinite(rad).all(2)
        total = torch.zeros((n_pix, 3), dtype=dt, device=dev)
        for s in range(spp):
            total = total + torch.where(take[s, :, None], rad[s], 0.0)
        nv = take.sum(0).to(dt)[:, None]
        err = torch.where(nv > 0, total / torch.clamp_min(nv, 1.0) - target.to(dt), 0.0)
        loss = torch.sum(err * err) / (n_pix * 3.0)
        cot_pix = 2.0 * err / torch.clamp_min(nv, 1.0) / (n_pix * 3.0)
        cot = torch.where(take.reshape(-1, 1), cot_pix[pix], 0.0)
        done = int(started.sum())
        del rad, rays, before, total, pix

    def sc_of():
        wanted = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        return tracer.pack(scene, dt, dev, wanted), wanted

    got = tracer.path_grads(sc_of, levels, cot, max_bounces=max_bounces, chunk=grad_chunk)
    grads = {k: got.get(k, torch.zeros_like(v)) for k, v in leaves.items()}
    new = {k: (leaves[k] - lr * grads[k]).float() for k in PARAMS}
    return float(loss), {k: g.float() for k, g in grads.items()}, new, done
