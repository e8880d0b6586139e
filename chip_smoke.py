"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `miniraytracer_tpu_torch/csrc` and drives
both ported paths on the card:

- the forward render: kernel B1 (`bounce.cu`) against its plain PyTorch
  version and against the real reference renderer's frames, then the Cornell
  box at 500x500, 64 spp, 32 bounces through the public `render` entry point;
- the train step: kernels B2/B3 (`bounce_ad.cu`, the scan step and its
  hand-derived backward) against their plain versions on five scenes lane
  by lane, then three steps of `make_train_step` on the Cornell box at
  500x500, 32 bounces, 128 samples a step, whose loss must fall on a
  held-out sample set.

Each main path is driven with the kernels' launch counts set to 0 just before
and read just after. Every phase raises on failure, so the exit code is
nonzero and no result line is printed. The last three lines of standard
output are the card's name and power limit, a JSON object with one entry per
kernel (launches on the main path, error against the plain version, time,
the plain version's time, the bound), and a JSON object naming the device.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(HERE, "tests", "reference_renders.npz")
FUSED_SCENES = ("cornell_box", "cornell_smoke", "two_spheres", "perlin_spheres")
# tests/test_reference_parity.py CASES: channel-mean tolerance at 16 spp
PARITY_TOL = {"two_spheres": 0.01, "perlin_spheres": 0.015,
              "cornell_box": 0.035, "cornell_smoke": 0.015}


# The least time the card could take (the "bound") is the larger of bytes moved
# over the memory rate and fp32 operations over the instruction rate. The kernels
# are built with --fmad=false, so a multiply and an add are two instructions:
# the rate is half the published 67 TFLOP/s, which counts a fused multiply-add
# as two (NVIDIA H100 SXM data sheet, 3.35 TB/s of HBM3).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
# fp32 operations per traced ray, counted from the kernel sources for the
# Cornell box's tables (6 rects, 1 box, 1 sphere, 1 rect light;
# `physics.cuh::bounce_physics`): hit sweep 27 (sphere) + 6 x 37 (rects) + 55
# (box) ~ 305; hit point 6; the diffuse shade (ONB 28, cosine sample and its
# sin/cos ~70, light sample 15, normalize 10, the rect light's pdf 50, cosines
# and weight 25, texture/emission 10) ~ 210 (glass and light hits cost less);
# the step's own algebra and the share of a camera ray (~60 per sample of ~3
# rays) ~ 40; the integer hashing of the RNG is not counted. The backward
# replays the forward and then runs the adjoint of the branch taken, about as
# many operations again.
FP32_OPS_PER_RAY_FWD = 560
FP32_OPS_PER_RAY_BWD = 2 * FP32_OPS_PER_RAY_FWD


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by) of work that moves n_bytes and does n_ops."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, repeats):
    """Per-call milliseconds of fn() between CUDA events, one per repeat."""
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_and_host_ms(fn):
    """One fn(): (milliseconds between CUDA events around it, milliseconds the
    host took to enqueue it). Where the two are equal the device waited for
    the host."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    host = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return start.elapsed_time(end), host


def compare(name, kernel_out, plain_out):
    """Frames and ray counts of the kernel against the plain version."""
    (a, c, r), (a2, c2, r2) = kernel_out, plain_out
    f = a / c.clamp_min(1)[:, None].float()
    f2 = a2 / c2.clamp_min(1)[:, None].float()
    err = (f - f2).abs().amax(dim=1)
    rays, rays2 = int(r.sum(dtype=torch.int64)), int(r2.sum(dtype=torch.int64))
    m, m2 = f.mean(0), f2.mean(0)
    mean_rel = float(((m - m2).abs() / m2.abs().clamp_min(1e-6)).max())
    frac = float((err < 1e-4).float().mean())
    ray_rel = abs(rays - rays2) / max(rays2, 1)
    print(f"  {name}: rays kernel {rays} plain {rays2} (rel {ray_rel:.3g}); "
          f"pixels within 1e-4: {frac:.6f}; max abs err {float(err.max()):.3g}; "
          f"channel means rel diff {mean_rel:.3g}")
    check(torch.isfinite(f).all().item(), f"{name}: kernel frame not finite")
    check(ray_rel <= 1e-3, f"{name}: ray counts differ by more than 0.1%")
    check(frac >= 0.99, f"{name}: fewer than 99% of pixels within 1e-4")
    check(mean_rel <= 1e-3, f"{name}: channel means differ by more than 1e-3")
    return float(err.max())


def main() -> None:
    # 1. the card
    check(torch.cuda.is_available(), "no CUDA device: this script needs a GPU")
    card_line = card()
    print(card_line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    import miniraytracer_tpu_torch as mrt
    from miniraytracer_tpu_torch.ops import bounce, bounce_ad
    from miniraytracer_tpu_torch.utils import kernels

    # 2. build the kernels from the sources in this checkout
    t0 = time.perf_counter()
    names = ("bounce", "bounce_ad")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(kernels.build, names))  # one nvcc each, side by side
    print(f"phase 2: built csrc/bounce.cu and csrc/bounce_ad.cu in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())

    dev = torch.device("cuda")

    def both(scene, w, h, spp_sq, bounces):
        pix = torch.arange(w * h, dtype=torch.int32, device=dev)
        kw = dict(width=w, height=h, max_bounces=bounces, spp_sq=spp_sq)
        k = bounce.render_wavefront_fused_pixels(
            scene, pix, 0, spp_sq * spp_sq, 1000.0, **kw)
        p = bounce.render_wavefront_fused_pixels_plain(
            scene, pix, 0, spp_sq * spp_sq, 1000.0, **kw)
        return k, p

    # 3. kernel against the plain version, four fused scenes, 64x64x4x8
    print("phase 3: kernel vs plain PyTorch, 64x64, 4 spp, 8 bounces")
    max_err = 0.0
    for name in FUSED_SCENES:
        scene = getattr(mrt.scenes, name)(1.0).to(dev)
        k, p = both(scene, 64, 64, 2, 8)
        max_err = max(max_err, compare(name, k, p))

    # 4. kernel against the reference renderer's frames (channel means)
    print("phase 4: kernel vs reference renderer, 100x100, 16 spp, 16 bounces")
    with np.load(REFERENCE) as z:
        refs = {k: z[k] for k in z.files}
    for name in FUSED_SCENES:
        scene = getattr(mrt.scenes, name)(1.0).to(dev)
        frame, _ = bounce.render_wavefront_fused(scene, 100, 100, 16,
                                                 max_bounces=16)
        ours = frame.cpu().numpy()
        check(np.isfinite(ours).all(), f"{name}: frame not finite")
        ref_mean = refs[name].mean(axis=(0, 1))
        rel = np.abs(ref_mean - ours.mean(axis=(0, 1))) / np.maximum(ref_mean, 1e-6)
        print(f"  {name}: channel means rel diff {rel.max():.4f} "
              f"(tolerance {PARITY_TOL[name]})")
        check(rel.max() < PARITY_TOL[name], f"{name}: reference parity")

    # 5. the main path: render() of the Cornell box at 500x500x64x32
    print("phase 5: mrt.render(cornell_box, 500, 500, 64, max_bounces=32)")
    scene = mrt.scenes.cornell_box(1.0)
    torch.cuda.synchronize()
    bounce.launches = 0
    frame, stats = mrt.render(scene, 500, 500, 64, max_bounces=32)
    launches = bounce.launches
    scene = scene.to(dev)
    check(stats["renderer"] == "fused", f"renderer {stats['renderer']}")
    check(launches > 0, "the render did not launch the fused kernel")
    check(frame.shape == (500, 500, 3) and frame.is_cuda, "frame shape/device")
    check(torch.isfinite(frame).all().item(), "frame not finite")
    check(stats["rays"] > 0, "no rays traced")
    print(f"  renderer {stats['renderer']}, kernel launches {launches}, "
          f"rays {stats['rays']}, frame mean {frame.mean(dim=(0, 1)).tolist()}")
    ms = cuda_ms(lambda: mrt.render(scene, 500, 500, 64, max_bounces=32), 3)
    fwd = stats["rays"] / (statistics.median(ms) / 1e3) / 1e6
    print(f"  forward {fwd:.1f} Mrays/s (median of 3 warm renders, "
          f"{statistics.median(ms):.2f} ms each; runs {ms}) on {card_line}")

    # kernel and plain version at 500x500x4x32, in turns
    k, p = both(scene, 500, 500, 2, 32)
    max_err = max(max_err, compare("cornell_box 500x500x4x32", k, p))
    pix = torch.arange(500 * 500, dtype=torch.int32, device=dev)
    kw = dict(width=500, height=500, max_bounces=32, spp_sq=2)
    run_k = lambda: bounce.render_wavefront_fused_pixels(scene, pix, 0, 4, 1000.0, **kw)
    run_p = lambda: bounce.render_wavefront_fused_pixels_plain(scene, pix, 0, 4, 1000.0, **kw)
    plain_ms, kernel_ms = [], []
    for fn, out in ((run_p, plain_ms), (run_k, kernel_ms), (run_k, kernel_ms),
                    (run_p, plain_ms)):
        out.extend(cuda_ms(fn, 1))
    print(f"  500x500x4spp x32 bounces: kernel {kernel_ms} ms, plain {plain_ms} ms "
          f"on {card_line}")

    rays_b1 = int(k[2].sum(dtype=torch.int64))
    n_px = 500 * 500
    b1_bound, b1_by = bound(4 * n_px * (1 + 5) + 4 * sum(t.numel() for t in bounce.pack_scene(scene)[1]),
                            rays_b1 * FP32_OPS_PER_RAY_FWD)
    frame_bound, _ = bound(4 * n_px * 6, stats["rays"] * FP32_OPS_PER_RAY_FWD)
    print(f"  bound of B1: {b1_bound:.4f} ms at 500x500x4x32 ({rays_b1} rays, by {b1_by}); "
          f"{frame_bound:.4f} ms for the 64-spp frame ({stats['rays']} rays)")
    kernel_rows = [{
        "name": "fused_render",
        "route": "cuda",
        "source": "miniraytracer_tpu_torch/csrc/bounce.cu",
        "replaces": "miniraytracer_tpu/ops/bounce.py:1171",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": statistics.mean(kernel_ms),
        "plain_ms": statistics.mean(plain_ms),
        "bound_ms": b1_bound,
        "bound_by": b1_by,
        "library_ms": None,
    }]

    kernel_rows += train_phases(mrt, bounce, bounce_ad, dev, card_line)

    print(card_line)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def device_share(fn):
    """One fn() under torch.profiler: (wall ms, device busy ms, {kernel name:
    (device ms, launches)}). The wall time ends after a synchronize; the
    profiler itself slows the host, so the idle share it gives is an upper
    bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms, count = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, count + 1)
    return wall, sum(ms for ms, _ in by_name.values()), by_name


def scan_with_grads(mrt, bounce, bounce_ad, scene, w, h, spp, bounces, plain):
    """One scan of the whole image from the scene's TrainParams, through the
    kernels (the public entry point) or through their plain versions (the
    same scan put together from `scan_forward` and `scan_backward`). Returns
    (sums, nvalid, rays, grads): grads(target, mask) gives the SSE loss over
    the pixels of `mask` and its gradient for every TrainParams leaf."""
    leaves = mrt.TrainParams(*(p.detach().clone().requires_grad_(True)
                               for p in mrt.extract_params(scene)))
    sc = mrt.apply_params(scene, leaves)
    pix = torch.arange(w * h, dtype=torch.int32, device=scene.device)
    if plain:
        meta, tables = bounce.pack_scene(sc)
        _, claim, k_sub, outer = bounce_ad.scan_plan(spp, bounces)
        cfg = bounce_ad.StepConfig(w, h, 8, bounces, spp, claim, k_sub)
        sb = torch.zeros_like(pix)
        consts = [t.detach() for t in tables]
        state = bounce_ad.initial_state(sc, pix, sb, spp, width=w, height=h, sq_off=8)
        (f, _, _), residual = bounce_ad.scan_forward(
            meta, cfg, outer, consts, *state, pix, sb, plain=True)
        f.requires_grad_(True)
        summ, nv = f[bounce_ad.A_SUM:bounce_ad.A_SUM + 3].t(), f[bounce_ad.A_NV].detach()
        rays = int(f[bounce_ad.A_RAYS].detach().to(torch.int64).sum())
    else:
        summ, nv, rays = bounce_ad.sample_pixel_sums_fused(
            sc, pix, 0, spp, width=w, height=h, max_bounces=bounces)
        rays = int(rays)

    def grads(target, mask):
        err = torch.where((mask & (nv > 0))[:, None],
                          summ / nv.clamp_min(1)[:, None] - target, 0.0)
        loss = (err * err).sum() / (w * h * 3.0)
        if plain:
            cot, = torch.autograd.grad(loss, f)
            d_tables = bounce_ad.scan_backward(meta, cfg, outer, consts, residual,
                                               pix, sb, cot, plain=True)
            pairs = [(t, g) for t, g in zip(tables, d_tables)
                     if g is not None and t.requires_grad]
            out = torch.autograd.grad([t for t, _ in pairs], list(leaves),
                                      grad_outputs=[g for _, g in pairs], allow_unused=True)
        else:
            out = torch.autograd.grad(loss, list(leaves), allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, out)]

    return summ.detach(), nv, rays, grads


def compare_scans(mrt, bounce, bounce_ad, scene, w, h, spp, bounces, where):
    """The whole scan through the kernels against the plain versions: ray
    counts within 0.1%, `nvalid` equal on 99.9% of pixels, sums within
    1e-5*(1+|sum|) on 99%; then the SSE loss against a flat grey target over
    the pixels that agree (a pixel is one lane with its own scan, so the
    others get no cotangent) and every TrainParams gradient within rtol 5e-3,
    atol 5e-4 of the leaf's largest entry, all finite."""
    sk, nvk, rk, grads_k = scan_with_grads(mrt, bounce, bounce_ad, scene, w, h, spp, bounces, False)
    sp, nvp, rp, grads_p = scan_with_grads(mrt, bounce, bounce_ad, scene, w, h, spp, bounces, True)
    nv_same = nvk == nvp
    close = nv_same & ((sk - sp).abs() <= 1e-5 * (1 + sp.abs())).all(1)
    target = torch.full((w * h, 3), 0.25, device=sk.device)
    (lk, gk), (lp, gp) = grads_k(target, close), grads_p(target, close)
    worst, seen = 0.0, []
    for leaf, a, b in zip(mrt.TrainParams._fields, gk, gp):
        check(torch.isfinite(a).all().item(), f"{where}: grad {leaf} not finite")
        if b.numel() and float(b.abs().max()) > 0:
            seen.append(leaf)
        scale = max(float(b.abs().max()) if b.numel() else 0.0, 1e-3)
        excess = (((a - b).abs() - 5e-3 * b.abs()).max().item() / (5e-4 * scale)
                  if b.numel() else 0.0)
        worst = max(worst, excess)
    print(f"  {where}: rays kernel {rk} plain {rp}; nvalid equal on "
          f"{float(nv_same.float().mean()):.5f} of pixels, sums within 1e-5*(1+|s|) on "
          f"{float(close.float().mean()):.5f}; loss kernel {float(lk):.6g} plain {float(lp):.6g}; "
          f"grads of {', '.join(seen)}: worst excess over rtol 5e-3 / atol 5e-4*scale "
          f"{worst:.3g} (<= 1 passes)")
    check(abs(rk - rp) <= 1e-3 * max(rp, 1), f"{where}: ray counts differ by more than 0.1%")
    check(float(nv_same.float().mean()) >= 0.999 and float(close.float().mean()) >= 0.99,
          f"{where}: scan sums/nvalid differ")
    check(abs(float(lk) - float(lp)) <= 1e-4 * abs(float(lp)), f"{where}: losses differ")
    check(len(seen) > 0, f"{where}: every plain gradient is zero")
    check(worst <= 1.0, f"{where}: TrainParams grads differ from plain autograd")


def compare_launch(bounce_ad, args, res, gen, where):
    """One launch of B2 and one of B3 against their plain versions, from the
    entry state `res` = (residual rows (13, N), istate, keys, pix, sb).

    The kernel and the plain version round sin, cos, log and exp differently,
    so a lane in a few thousand takes another discrete decision (another
    primitive wins, a Fresnel draw falls the other way) within the launch's
    sub-steps and its floats then differ wholly. Tolerances are per lane and
    per group of rows, never one scale for the whole state:

    - B2: a lane agrees when its integer rows, its key and its alive, nvalid
      and ray-count rows are equal, its origin is within 1e-5 of the largest
      coordinate in the state (an ulp of float32 at 800 is 6e-5) and every
      other float (direction, time, throughput, radiance, sum) is within
      1e-5*(1+|plain|). At least 99% of lanes must agree.
    - B3 is linear in the cotangent lane by lane, so the seeded cotangent is
      zeroed on the lanes that disagree. On the others every entry of `d_f`
      must be within 2e-3*|plain| + 2e-4*(the lane's largest |plain|), on at
      least 99% of them; `d_tab` within rtol 2e-3, atol 2e-4 of its largest
      entry (its atomic sums vary at about 1e-6).

    Returns the errors and the closures timed."""
    A = bounce_ad
    res_f, lanes = res[0], res[1:]
    n = res_f.shape[1]
    zeros = torch.zeros((3, n), device=res_f.device)
    f_in = torch.cat([zeros, res_f, zeros[:2]])
    run = {
        "fwd_k": lambda: A.ad_step_fwd(*args, f_in, *lanes),
        "fwd_p": lambda: A.ad_step_fwd_plain(*args, f_in, *lanes),
    }
    (fk, ik, kk), (fp, ip, kp) = run["fwd_k"](), run["fwd_p"]()
    err = (fk - fp).abs()
    tol = 1e-5 * (1 + fp.abs())
    ro_scale = float(fp[A.A_RO:A.A_RD].abs().max().clamp_min(1.0))
    tol[A.A_RO:A.A_RD] = 1e-5 * ro_scale
    tol[A.A_ALIVE:] = 0.0  # alive, nvalid, rays: whole numbers
    agree = (ik == ip).all(0) & (kk == kp) & (err <= tol).all(0)
    cot = torch.randn((A.NF, n), device=res_f.device, generator=gen) * agree
    run["bwd_k"] = lambda: A.ad_step_bwd(*args, res_f, *lanes, cot)
    run["bwd_p"] = lambda: A.ad_step_bwd_plain(*args, res_f, *lanes, cot)
    (dk, tk), (dp, tp) = run["bwd_k"](), run["bwd_p"]()
    d_err = (dk - dp).abs()
    top = dp.abs().amax(0)
    close = (d_err <= 2e-3 * dp.abs() + 2e-4 * top).all(0)
    rel = (d_err.amax(0) / top.clamp_min(1e-30))[agree & close]
    q = torch.quantile(rel[torch.randperm(rel.numel(), device=rel.device)[:1_000_000]],
                       torch.tensor([0.5, 0.99], device=rel.device))
    other = torch.ones_like(err, dtype=torch.bool)
    other[A.A_RO:A.A_RD] = False
    out = {
        "agree": float(agree.float().mean()),
        "fwd_err_ro": float(err[A.A_RO:A.A_RD][:, agree].max()), "ro_scale": ro_scale,
        "fwd_err": float((err * other)[:, agree].max()),
        "fwd_rel": float((err / (1 + fp.abs()))[:, agree].max()),
        "df_close": float(close[agree].float().mean()),
        "df_err": float(d_err[:, agree & close].max()),
        "df_scale": float(top[agree & close].max()),
        "df_rel": float(rel.max()), "df_rel_median": float(q[0]), "df_rel_p99": float(q[1]),
        "dtab_rel": float(((tk - tp).abs() / tp.abs().max().clamp_min(1e-30)).max()),
        "rays": int(fp[A.A_RAYS].sum()),
        "run": run,
    }
    print(f"    {where}: lanes that agree {out['agree']:.5f}; on them forward max abs err: "
          f"origin {out['fwd_err_ro']:.3g} (coordinates up to {ro_scale:.3g}), other rows "
          f"{out['fwd_err']:.3g}; d_f inside rtol 2e-3 + 2e-4 of the lane's largest on "
          f"{out['df_close']:.5f} of them, error over the lane's largest: median "
          f"{out['df_rel_median']:.3g}, 99th percentile {out['df_rel_p99']:.3g}, worst "
          f"{out['df_rel']:.3g}; d_tab max err {out['dtab_rel']:.3g} of its largest entry")
    check(out["agree"] >= 0.99, f"{where}: B2 agrees with plain on {out['agree']:.4f} of lanes")
    check(out["df_close"] >= 0.99,
          f"{where}: B3 d_f differs from plain on {1 - out['df_close']:.4f} of lanes")
    check(((tk - tp).abs() <= 2e-3 * tp.abs() + 2e-4 * tp.abs().max()).all().item(),
          f"{where}: B3 d_tab differs from plain (rtol 2e-3), max {out['dtab_rel']:.3g} of scale")
    return out


def launch_states(mrt, bounce, bounce_ad, scene, w, h, spp, bounces, plain):
    """(meta, cfg, outer, tables, pix, sb, first state, residual of a whole
    forward scan) of a scene on its device."""
    meta, tables = bounce.pack_scene(scene)
    _, claim, k_sub, outer = bounce_ad.scan_plan(spp, bounces)
    cfg = bounce_ad.StepConfig(w, h, 8, bounces, spp, claim, k_sub)
    pix = torch.arange(w * h, dtype=torch.int32, device=scene.device)
    sb = torch.zeros_like(pix)
    state = bounce_ad.initial_state(scene, pix, sb, spp, width=w, height=h, sq_off=8)
    _, residual = bounce_ad.scan_forward(meta, cfg, outer, tables, *state, pix, sb, plain=plain)
    return meta, cfg, outer, tables, pix, sb, state, residual


def train_phases(mrt, bounce, bounce_ad, dev, card_line):
    """Phases 6 and 7: the AD step kernels and the train step. Returns the
    two kernels' rows of the result line."""
    # 6. B2/B3 against their plain versions, five scenes, 64x64x2x8
    print("phase 6: AD step kernels vs plain PyTorch, 64x64, 2 spp, 8 bounces")
    w = h = 64
    spp, bounces = 2, 8
    scenes = {name: getattr(mrt.scenes, name)(1.0) for name in FUSED_SCENES}
    scenes["ad_probe"] = mrt.scenes.ad_probe()
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {}
    for name, scene in scenes.items():
        scene = scene.to(dev)
        compare_scans(mrt, bounce, bounce_ad, scene, w, h, spp, bounces, name)
        # single launches at three steps of the plain scan (two that still
        # claim samples and one of the tail), a seeded cotangent
        meta, cfg, outer, tables, pix, sb, _, (res_f, res_i, res_k) = launch_states(
            mrt, bounce, bounce_ad, scene, w, h, spp, bounces, True)
        for t in (0, 1, outer // 2):
            c = compare_launch(bounce_ad, (meta, cfg, tables, t),
                               (res_f[t], res_i[t], res_k[t], pix, sb), gen, f"{name} launch {t}")
            for k in ("fwd_err", "fwd_rel", "df_err", "df_rel", "dtab_rel"):
                worst[k] = max(worst.get(k, 0.0), c[k])

    # 7. the train step at full width: Cornell 500x500, 32 bounces, 128 spp/step
    w = h = 500
    bounces, spp_step, n_steps, lr = 32, 128, 3, 0.5
    scan_steps, claim, k_sub, outer = bounce_ad.scan_plan(spp_step, bounces)
    print(f"phase 7: make_train_step(cornell_box, 500x500, {bounces} bounces, "
          f"spp_step={spp_step}): scan_steps {scan_steps}, {k_sub} sub-steps a launch, "
          f"{outer} launches each way")
    res_bytes = bounce_ad.residual_bytes(w * h, outer)
    free, total = torch.cuda.mem_get_info()
    print(f"  residual {res_bytes / 1e9:.2f} GB; device memory free {free / 1e9:.1f} of "
          f"{total / 1e9:.1f} GB")
    check(res_bytes < 0.5 * free, "not enough free device memory for the residual")
    scene = mrt.scenes.cornell_box(1.0)
    # target: the same box with other wall albedos (red, white, green)
    c0 = scene.tex_c0.clone()
    c0[0] = torch.tensor([0.45, 0.15, 0.10])
    c0[1] = torch.tensor([0.55, 0.55, 0.55])
    c0[2] = torch.tensor([0.20, 0.30, 0.25])
    target, _ = mrt.render(dataclasses.replace(scene, tex_c0=c0), w, h, 64, max_bounces=bounces)
    target = target.reshape(-1, 3)
    step = mrt.make_train_step(width=w, height=h, max_bounces=bounces, spp_step=spp_step)
    params0 = params = mrt.extract_params(scene)
    torch.cuda.synchronize()
    bounce_ad.fwd_launches = bounce_ad.bwd_launches = 0
    losses = []
    for i in range(n_steps):
        # lr: the loss is a mean over pixels and channels, so its curvature in
        # an albedo is about the mean squared irradiance (~0.1): 0.5 is a
        # small step, and the three of them move an albedo by about 0.02
        params, loss, grads = step(params, scene, target, i, lr)
        losses.append(float(loss))
        check(all(torch.isfinite(g).all().item() for g in grads), f"step {i}: grads not finite")
    fwd_launches, bwd_launches = bounce_ad.fwd_launches, bounce_ad.bwd_launches
    # Step i draws its own 128 samples a pixel, and the AD path clamps no
    # sample's luminance, so the loss of a step carries the noise of its
    # sample set and the losses of different steps do not compare. "Falling"
    # is read on one held-out sample set that no step trained on (sample
    # index n_steps), for the first and the last params; each step's own
    # sample set is also evaluated again with the first params.
    same_set = [float(step(params0, scene, target, i, 0.0)[1]) for i in range(n_steps)]
    held_first = float(step(params0, scene, target, n_steps, 0.0)[1])
    held_last = float(step(params, scene, target, n_steps, 0.0)[1])
    print(f"  losses of the {n_steps} steps (lr {lr}, new samples each) {losses}; the first "
          f"params on the same sample sets {same_set}")
    print(f"  held-out sample set {n_steps}: loss {held_first} with the first params, "
          f"{held_last} after {n_steps} updates; launches forward {fwd_launches}, "
          f"backward {bwd_launches}")
    print(f"  wall albedos now {params.tex_c0[:3].tolist()}; last grads, max abs: "
          + ", ".join(f"{k} {float(g.abs().max()):.3g}" for k, g in grads._asdict().items()))
    check(all(np.isfinite(l) for l in losses + same_set + [held_first, held_last]),
          "loss not finite")
    check(held_last < held_first, "the loss on held-out samples did not fall over the steps")
    check(fwd_launches == n_steps * outer and bwd_launches == n_steps * outer,
          "the train step did not launch each kernel once per scan step")
    check(all(p.is_cuda for p in params), "params left the card")

    # time a step (lr 0: the same work every time)
    scene_d = scene.to(dev)
    params0 = mrt.extract_params(scene_d)
    one_step = lambda: step(params0, scene_d, target, 0, 0.0)
    step_ms = cuda_ms(one_step, 3)
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    with torch.no_grad():
        _, nv, rays = bounce_ad.sample_pixel_sums_fused(
            scene_d, pix, 0, spp_step, width=w, height=h, max_bounces=bounces)
    rays = int(rays)
    done_frac = float(nv.sum()) / (w * h * spp_step)
    med = statistics.median(step_ms)
    print(f"  step {med:.1f} ms (median of 3 warm; runs {step_ms}); rays {rays}; "
          f"done_frac {done_frac:.4f}; fwd+bwd {rays / (med / 1e3) / 1e6:.1f} Mrays/s "
          f"on {card_line}")
    wall, busy, by_name = device_share(one_step)
    print(f"  one step under torch.profiler: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"(idle share {max(0.0, 1 - busy / wall):.3f}; without the profiler the same "
          f"device time is {busy / med:.3f} of the median step)")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]:
        print(f"    {ms:8.2f} ms  {100 * ms / busy:5.1f}%  x{count:<4d} {name[:90]}")

    # the kernels alone over one whole scan, then one launch against plain
    meta, cfg, outer, tables, pix, sb, state, residual = launch_states(
        mrt, bounce, bounce_ad, scene_d, w, h, spp_step, bounces, False)
    res_f, res_i, res_k = residual
    cot0 = torch.zeros((bounce_ad.NF, w * h), device=dev)
    cot0[:3] = 1.0
    fwd_scan = lambda: bounce_ad.scan_forward(meta, cfg, outer, tables, *state, pix, sb,
                                              keep=False)
    bwd_scan = lambda: bounce_ad.scan_backward(meta, cfg, outer, tables, residual, pix, sb, cot0)
    fwd_scan(), bwd_scan()  # warm
    (b2_scan, b2_host), (b3_scan, b3_host) = (
        min(cuda_and_host_ms(fn) for _ in range(3)) for fn in (fwd_scan, bwd_scan))
    b2_scan, b2_host, b3_scan, b3_host = (x / outer for x in (b2_scan, b2_host, b3_scan, b3_host))
    print(f"  over a whole scan ({outer} launches each, best of 3): B2 {b2_scan:.3f} ms a launch "
          f"(the host enqueues one in {b2_host:.3f} ms), B3 {b3_scan:.3f} ms a launch (host "
          f"{b3_host:.3f} ms), on {card_line}")

    t_mid = outer // 4
    print(f"  launch {t_mid} of the scan, {w * h} lanes, kernels vs plain:")
    c = compare_launch(bounce_ad, (meta, cfg, tables, t_mid),
                       (res_f[t_mid], res_i[t_mid], res_k[t_mid], pix, sb), gen,
                       f"cornell_box 500x500 launch {t_mid}")
    run, launch_rays = c["run"], c["rays"]
    ms = {key: [] for key in run}
    for key in ("fwd_p", "fwd_k", "fwd_k", "fwd_p", "bwd_p", "bwd_k", "bwd_k", "bwd_p"):
        reps = 5 if key.endswith("_k") else 1  # a kernel launch is short: time five
        ms[key].append(cuda_ms(lambda: [run[key]() for _ in range(reps)], 1)[0] / reps)
    print(f"    {launch_rays} rays: B2 kernel {ms['fwd_k']} ms, plain {ms['fwd_p']} ms; B3 kernel "
          f"{ms['bwd_k']} ms, plain {ms['bwd_p']} ms on {card_line}")
    del residual, res_f, res_i, res_k, run, c["run"]
    torch.cuda.empty_cache()
    # the whole scan at this width, shortened to 2 samples a pixel
    compare_scans(mrt, bounce, bounce_ad, scene_d, w, h, 2, bounces,
                  "cornell_box 500x500, 2 spp, whole scan")
    n = w * h
    table_bytes = 4 * sum(t.numel() for t in tables)
    # rows of N words moved: B2 reads 19+3+1+2 and writes 19+3+1; B3 reads
    # 13+3+1+2+19 and writes 19
    b2_bound, b2_by = bound(4 * n * 48 + table_bytes,
                            launch_rays * FP32_OPS_PER_RAY_FWD)
    b3_bound, b3_by = bound(4 * n * 57 + table_bytes,
                            launch_rays * FP32_OPS_PER_RAY_BWD)
    b2_mean, _ = bound(4 * n * 48 + table_bytes, rays / outer * FP32_OPS_PER_RAY_FWD)
    b3_mean, _ = bound(4 * n * 57 + table_bytes, rays / outer * FP32_OPS_PER_RAY_BWD)
    print(f"  bounds: that launch B2 {b2_bound:.4f} ms by {b2_by}, B3 {b3_bound:.4f} ms by "
          f"{b3_by}; the scan's mean launch ({rays // outer} rays) B2 {b2_mean:.4f} ms, "
          f"B3 {b3_mean:.4f} ms")
    common = {"route": "cuda", "source": "miniraytracer_tpu_torch/csrc/bounce_ad.cu",
              "library_ms": None}
    return [
        {"name": "ad_step_fwd", "replaces": "miniraytracer_tpu/ops/bounce_ad.py:219",
         "launches": fwd_launches, "max_abs_err": max(worst["fwd_err"], c["fwd_err"]),
         "max_rel_lane_err": max(worst["fwd_rel"], c["fwd_rel"]),
         "lanes_agreeing": c["agree"],
         "ms": statistics.mean(ms["fwd_k"]), "plain_ms": statistics.mean(ms["fwd_p"]),
         "bound_ms": b2_bound, "bound_by": b2_by, "scan_ms_per_launch": b2_scan,
         "scan_bound_ms_per_launch": b2_mean, **common},
        {"name": "ad_step_bwd", "replaces": "miniraytracer_tpu/ops/bounce_ad.py:276",
         "launches": bwd_launches, "max_abs_err": max(worst["df_err"], c["df_err"]),
         "err_scale": c["df_scale"], "max_rel_lane_err": max(worst["df_rel"], c["df_rel"]),
         "lanes_agreeing": c["df_close"],
         "ms": statistics.mean(ms["bwd_k"]), "plain_ms": statistics.mean(ms["bwd_p"]),
         "bound_ms": b3_bound, "bound_by": b3_by, "scan_ms_per_launch": b3_scan,
         "scan_bound_ms_per_launch": b3_mean, **common},
    ]


if __name__ == "__main__":
    main()
