"""Time design variants of two kernels of the port in turns on one card.

    python3 time_designs.py DIR [DIR ...]

Each DIR holds a variant of `miniraytracer_tpu_torch/csrc/`: a `flash.cu`
(the cluster loop of B9-B13) or a `bounce_ad.cu` (B2/B3), with the headers
they include. Keep the directories in a git-ignored place such as
`_checkout/`. Each is built with the port's nvcc flags (`utils/kernels.py`)
into a library beside its source; the wrappers launch it in place of the
checkout's build of the same name. The first variant of each kind is the
reference: every other one must give its results (the sweeps: t and index
equal on every ray; B3: `d_f` within `chip_smoke.compare_launch`'s per-lane
tolerance). Then, in turns (all variants, the order reversed every other
round, each warmed first), with CUDA events:

- bounce_ad.cu: B3 at launch 50 of the Cornell box's scan (500x500, 32
  bounces, 128 samples a pixel) and over that whole scan, and in each ext
  mode at launch 20 of a 500x500, 8-sample scan (triangles with stand-in
  meshes: ext; random_spheres: ext-material; earth: image);
- flash.cu: B10 alone (from a visiting plan made once) on the rays of queue
  steps 2 and 10 of the triangles scene at 500x500, from the nearest rect's
  distance as the work queue seeds it, with how its gated (ray, cluster)
  pairs spread over warps of 32 sorted rays; B13 on book2_final's and B12 on
  a 5000-sphere scene's queue step 2.

Prints each variant's registers and stack (ptxas -v), the card's name and
power limit, and per timing the median and the runs in ms.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import statistics
import subprocess
import sys

import torch

import chip_smoke as cs


def build(path):
    """(name, kind, CDLL, nvcc log) of the variant in directory `path`."""
    from miniraytracer_tpu_torch.utils import kernels

    kind = "bounce_ad" if os.path.exists(os.path.join(path, "bounce_ad.cu")) else "flash"
    out = os.path.join(path, f"lib{kind}.so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out,
                           os.path.join(path, f"{kind}.cu")], capture_output=True, text=True)
    cs.check(proc.returncode == 0, f"{path} did not build:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(out)
    lib.mrt_error_string.argtypes = [ctypes.c_int]
    lib.mrt_error_string.restype = ctypes.c_char_p
    return os.path.basename(os.path.normpath(path)), kind, lib, proc.stdout + proc.stderr


def launched_with(kind, lib, fn):
    """fn() with the wrappers of csrc/<kind>.cu launching `lib`."""
    from miniraytracer_tpu_torch.utils import kernels

    with cs.launching(kernels, kind, lib):
        return fn()


def in_turns(what, kind, libs, fn, reps, rounds=3, per=1):
    """Median ms of `reps` calls of fn() (divided by `per`) for each variant,
    in turns; prints them beside the first variant's."""
    for lib in libs.values():
        launched_with(kind, lib, fn)
    torch.cuda.synchronize()
    ms = {name: [] for name in libs}
    names = list(libs)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            t = launched_with(kind, libs[name],
                              lambda: cs.cuda_ms(lambda: [fn() for _ in range(reps)], 1)[0])
            ms[name].append(t / reps / per)
    base = statistics.median(ms[names[0]])
    print(f"  {what}:")
    for name, runs in ms.items():
        m = statistics.median(runs)
        print(f"    {name:10s} {m:.4f} ms ({m / base:.3f} of {names[0]}); runs "
              f"{[round(x, 4) for x in runs]}")


def time_b3(mrt, libs, dev):
    from miniraytracer_tpu_torch.ops import bounce, bounce_ad, hybrid

    A = bounce_ad
    scene = mrt.scenes.cornell_box(1.0).to(dev)
    meta, cfg, outer, tables, pix, sb, _, residual = cs.launch_states(
        mrt, bounce, A, scene, 500, 500, 128, 32, False)
    res_f, res_i, res_k = residual
    gen = torch.Generator(device=dev).manual_seed(0)
    cot = torch.randn((A.NF, 500 * 500), device=dev, generator=gen)
    t = outer // 4
    one = lambda: A.ad_step_bwd(meta, cfg, tables, t, res_f[t], res_i[t], res_k[t], pix, sb, cot,
                                None)
    first = next(iter(libs))
    d_ref, tab_ref = launched_with("bounce_ad", libs[first], one)[:2]
    top = d_ref.abs().amax(0)
    for name, lib in libs.items():
        d, tab = launched_with("bounce_ad", lib, one)[:2]
        close = float(((d - d_ref).abs() <= 2e-3 * d_ref.abs() + 2e-4 * top).all(0).float().mean())
        rel = float((tab - tab_ref).abs().max() / tab_ref.abs().max())
        print(f"  B3 {name}: d_f within tolerance of {first} on {close:.6f} of lanes; d_tab max "
              f"err {rel:.3g} of its largest entry")
        cs.check(close >= 0.99 and rel <= 2e-3, f"B3 {name} differs from {first}")
    in_turns(f"B3 at launch {t} of the Cornell scan (5 a timing)", "bounce_ad", libs, one, 5)
    cot0 = torch.zeros((A.NF, 500 * 500), device=dev)
    cot0[:3] = 1.0
    in_turns(f"B3 over the whole Cornell scan, a launch ({outer} launches)", "bounce_ad", libs,
             lambda: A.scan_backward(meta, cfg, outer, tables, residual, pix, sb, cot0), 1,
             per=outer)
    del residual, res_f, res_i, res_k
    torch.cuda.empty_cache()
    for mode, name in (("ext", "triangles"), ("ext_mat", "random_spheres"), ("image", "earth")):
        sc = cs.ext_scene(mrt, name).to(dev)
        meta, cfg, tables, images, pix, sb, _, states = cs.ext_states(
            A, hybrid, sc, 500, 8, 32, (20,), False)
        rf, ri, rk, ext = states[20]
        cot = torch.randn((A.NF, 500 * 500), device=dev, generator=gen)
        in_turns(f"B3[{mode}] on {name} at launch 20 (5 a timing)", "bounce_ad", libs,
                 lambda: A.ad_step_bwd(meta, cfg, tables, 20, rf, ri, rk, pix, sb, cot, None,
                                       ext, images), 5)
        del states
        torch.cuda.empty_cache()


def warp_spread(flash, bounce, cull, ro, rd, inside, seed, plan):
    """How the (ray, cluster) pairs that pass the gate against the final best
    (a lower bound of the loop's own) spread over warps of 32 sorted rays:
    (pairs, distinct (warp, cluster), [mean, p50, p90, p99, max] pairs a warp,
    the same of distinct clusters a warp)."""
    cds, bounds, orig_of, cl_ord = cull
    nc = bounds.shape[1]
    ray_of, grp_oct = plan
    n = ray_of.numel()
    pos = torch.empty(n, dtype=torch.int64, device=ray_of.device)
    pos[ray_of.long()] = torch.arange(n, device=ray_of.device)
    oct_of = grp_oct.long().repeat_interleave(flash.VISIT_GROUP)[:n][pos]
    t_best, _ = flash.launch_tri_planned(10, cull, ro, rd, inside, bounce.TMIN, seed, *plan)
    dead = torch.zeros(n, dtype=torch.bool, device=ro.x.device)
    for c in (*ro, *rd):
        dead |= torch.isnan(c)
    keys = []
    live = torch.nonzero(~dead)[:, 0]
    for s in range(0, live.numel(), 8192):
        lanes = live[s:s + 8192]
        order = cl_ord[oct_of[lanes]].long()
        tnear, tfar = flash._slab_distances(bounds[0:3][:, order], bounds[3:6][:, order],
                                            type(ro)(*(c[lanes] for c in ro)),
                                            [1.0 / c[lanes] for c in rd])
        gated = flash._crosses(tnear, tfar, bounce.TMIN) & (tnear < t_best[lanes][:, None])
        r, k = torch.nonzero(gated, as_tuple=True)
        keys.append((pos[lanes][r] // 32) * nc + order[r, k])
    keys = torch.cat(keys)
    distinct = torch.unique(keys)
    warps = -(-n // 32)
    q = torch.tensor([0.5, 0.9, 0.99], device=keys.device)

    def stat(x):
        return [round(float(x.mean()), 2), *[round(float(v), 1) for v in torch.quantile(x, q)],
                int(x.max())]

    return (int(keys.numel()), int(distinct.numel()),
            stat(torch.bincount(keys // nc, minlength=warps).float()),
            stat(torch.bincount(distinct // nc, minlength=warps).float()))


def time_cluster_loop(mrt, libs, dev):
    from miniraytracer_tpu_torch.models import integrator
    from miniraytracer_tpu_torch.ops import bounce, flash, hybrid
    from miniraytracer_tpu_torch.ops import intersect as ix
    from miniraytracer_tpu_torch.ops.vecmath import V3

    first = next(iter(libs))

    def same(what, fn):
        ref = launched_with("flash", libs[first], fn)
        for name, lib in libs.items():
            out = launched_with("flash", lib, fn)
            cs.check(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
                     f"{what}: {name} differs from {first}")
        print(f"  {what}: every variant equals {first} on every ray (t and index)")

    tri = cs.triangles_scene(mrt).to(dev)
    cull = flash.scene_tri_cull(tri)
    calls = cs.queue_snapshots(integrator, hybrid, tri, 500, 500, 2, 32,
                               integrator.wq_auto_lanes(tri, 500 * 500))
    for step in (2, 10):
        _, fstate, inside, _, _ = calls[step]
        ro, rd, time_, inside, alive = cs.snapshot_rays(hybrid, fstate, inside)
        real = ix.Rays(ro=V3(*fstate[hybrid.SH_RO:hybrid.SH_RO + 3]),
                       rd=V3(*fstate[hybrid.SH_RD:hybrid.SH_RD + 3]), time=time_, inside=inside)
        inf = torch.full_like(time_, 3.0e38)
        t_r, _ = ix._chunked_min(lambda s, c: ix.rect_ts(tri, real, s, c, bounce.TMIN, inf),
                                 tri.n_rects, time_.numel(), dev)
        seed = torch.where(alive, t_r, 0.0)
        plan = flash._visit_plan(ro, rd, cull[1], True)
        b10 = lambda: flash.launch_tri_planned(10, cull, ro, rd, inside, bounce.TMIN, seed, *plan)
        same(f"B10, triangles queue step {step}", b10)
        pairs, events, per_warp, clusters = launched_with(
            "flash", libs[first], lambda: warp_spread(flash, bounce, cull, ro, rd, inside, seed, plan))
        print(f"  step {step}: {int(alive.sum())} rays alive; {pairs} (ray, cluster) pairs pass "
              f"the gate, {events} distinct (warp, cluster); a warp of 32 rays: pairs "
              f"{per_warp}, clusters {clusters} (mean, median, 90th, 99th percentile, most)")
        in_turns(f"B10 alone, triangles queue step {step} (10 a timing)", "flash", libs, b10, 10)
    del calls
    torch.cuda.empty_cache()
    for name, sc, kernel in (
            ("book2_final", mrt.scenes.book2_final(1.0), flash.flash_sphere_hit_gated),
            ("5000 spheres", mrt.scenes.hybrid_probe(1.0, 5000, 0),
             flash.flash_sphere_hit_streamed)):
        sc = sc.to(dev)
        cull = flash.sph_cull_build(sc, flash.sphere_coefficients(sc))
        calls = cs.queue_snapshots(integrator, hybrid, sc, 500, 500, 2, 32,
                                   integrator.wq_auto_lanes(sc, 500 * 500))
        _, fstate, inside, _, _ = calls[2]
        *rays, _ = cs.snapshot_rays(hybrid, fstate, inside)
        fn = lambda: kernel(cull, *rays, bounce.TMIN)
        same(f"{kernel.__name__}, {name} queue step 2", fn)
        in_turns(f"{kernel.__name__}, {name} queue step 2 (10 a timing)", "flash", libs, fn, 10)
        del calls
        torch.cuda.empty_cache()


def main():
    cs.check(torch.cuda.is_available(), "no CUDA device: this script needs a GPU")
    cs.check(len(sys.argv) > 1, "name the variant directories")
    import miniraytracer_tpu_torch as mrt
    from miniraytracer_tpu_torch.utils import kernels

    card = cs.card()
    print(card)
    with concurrent.futures.ThreadPoolExecutor(len(sys.argv)) as pool:
        built = list(pool.map(build, sys.argv[1:]))
        for name in ("bounce", "bounce_ad", "flash", "hybrid"):
            kernels.build(name)
    libs = {"bounce_ad": {}, "flash": {}}
    for name, kind, lib, log in built:
        libs[kind][name] = lib
        entries = (("ad_step_bwd_kernel",) if kind == "bounce_ad" else
                   ("flash_tri_clustered_kernel", "flash_sphere_gated_kernel",
                    "flash_sphere_streamed_kernel"))
        for entry in entries:
            for line in cs.ptxas_lines(log, entry):
                print(f"  {name}: {line.strip()}")
    dev = torch.device("cuda")
    if libs["bounce_ad"]:
        time_b3(mrt, libs["bounce_ad"], dev)
    if libs["flash"]:
        time_cluster_loop(mrt, libs["flash"], dev)
    print(card)


if __name__ == "__main__":
    main()
