"""Time design variants of kernels of the port in turns on one card.

    python3 time_designs.py [--only GROUPS] [--count] [--trig] DIR [DIR ...]

Each DIR is a copy of `miniraytracer_tpu_torch/csrc/` holding a variant of
one or more of `bounce.cu` (B1), `bounce_ad.cu` (B2/B3), `flash.cu` (the
cluster loop of B9-B13), `hybrid.cu` (B5) and `noise.cu` (B6), with the
headers they include. Keep the directories
in a git-ignored place such as `_checkout/designs/`. Each source is built
with the port's nvcc flags (`utils/kernels.py`) into a library beside it; the
wrappers launch it in place of the checkout's build of the same name. The
first variant of each kind is the reference that every other one must equal.
Then, in turns (all variants, the order reversed every other round, each
warmed first), with CUDA events:

- b1 (bounce.cu): B1 alone on the Cornell box's frame at 500x500, 32
  bounces, 64 and 4 samples a pixel, and on perlin_spheres' at 64; accum,
  count and rays equal to the reference's on every pixel;
- b2 (bounce_ad.cu): B2 at launch 50 of the Cornell box's scan (500x500, 32
  bounces, 128 samples a pixel) and over that whole scan (with the host's
  time to enqueue it), every row of that launch and every launch's state of
  the scan equal to the reference's; and in each ext mode at launch 20 of a
  500x500, 8-sample scan (triangles with stand-in meshes: ext;
  random_spheres: ext-material; earth: image);
- b3 (bounce_ad.cu): B3 at launch 50 of the Cornell scan and over the whole
  scan, and in each ext mode at launch 20 (`d_f` and `d_ext` equal to the
  reference's bit for bit at launches 50 and 100 and in each mode, `d_tab`,
  which sums float atomics, within 2e-4 of its largest entry);
- cluster (flash.cu): B10 alone (from a visiting plan made once) on the rays
  of queue steps 2 and 10 of the triangles scene at 500x500, from the nearest
  rect's distance as the work queue seeds it, with how its gated (ray,
  cluster) pairs spread over warps of 32 sorted rays; B13 on book2_final's
  and B12 on a 5000-sphere scene's queue step 2 (t and index equal on every
  ray);
- b5 (hybrid.cu): B5 alone on the lanes of queue steps 0, 2 and a late one
  of earth's and book2_final's 500x500 renders (every row equal to the
  reference's), timed at step 2;
- b6 (noise.cu): B6 alone on the 131,072 points of random_spheres_2's queue
  step 2 and on a million uniform points (every value equal), timed on the
  first.
B5 and B6 last 0.005-0.03 ms on the card, less than their wrappers take to
enqueue them, so each of their turns is the median device time of 20
launches queued behind a spin (`chip_smoke.queued_ms`).

A DIR named probe_* is a probe: a copy that computes something else (a
part of a kernel), timed beside the variants and not held equal.

`--only b1,b2` picks groups (default: every group whose source a DIR holds).
`--trig` holds the last DIR's `exact_sinf`/`exact_cosf` (physics.cuh) against
CUDA's sinf/cosf on all 2^32 float inputs, bit for bit.
Prints each variant's registers, stack and spills (ptxas -v), its SASS's
local (LDL/STL), shared (LDS), global (LDG) and generic (LD) loads and calls,
the grid a launch of B1, B2, B3, B5 and B6 takes (blocks an SM holds from the
occupancy API, SMs, blocks), the card's name and power limit, and per timing the median
and the runs in ms. With `--count`, B1 and B2 of each variant are also built
with lane counters (`lane_counting_copy`, never part of the port) and run
once on the Cornell frame and scan: the share of a warp's lanes active where
a step starts, where a lane regenerates and in each shading branch, and from
those branch counts the fp32, integer and load instructions a ray takes,
counted from the source per branch (the bound's 560 fp32 a ray beside them).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import re
import shutil
import statistics
import subprocess

import torch

import chip_smoke as cs

KINDS = ("bounce", "bounce_ad", "flash", "hybrid", "noise")
GROUPS = {"b1": "bounce", "b2": "bounce_ad", "b3": "bounce_ad", "cluster": "flash",
          "b5": "hybrid", "b6": "noise"}
# entry functions whose ptxas and SASS lines are printed, by kind
ENTRIES = {"bounce": ("fused_render_kernel",),
           "bounce_ad": ("ad_step_fwd_kernel", "ad_step_bwd_kernel"),
           "flash": ("flash_tri_clustered_kernel", "flash_sphere_gated_kernel",
                     "flash_sphere_streamed_kernel"),
           "hybrid": ("shade_step_kernel", "hybrid_step_kernel"),
           "noise": ("turbulence_kernel",)}


def nvcc_build(src, out):
    """Build `src` into the library `out` with the port's flags: (CDLL, log)."""
    from miniraytracer_tpu_torch.utils import kernels

    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True)
    cs.check(proc.returncode == 0, f"{src} did not build:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(out)
    if hasattr(lib, "mrt_error_string"):
        lib.mrt_error_string.argtypes = [ctypes.c_int]
        lib.mrt_error_string.restype = ctypes.c_char_p
    return lib, proc.stdout + proc.stderr


def build(path, kind):
    """(variant name, kind, CDLL, nvcc log, library path) of csrc/<kind>.cu
    in the variant directory `path`."""
    out = os.path.join(path, f"lib{kind}.so")
    lib, log = nvcc_build(os.path.join(path, f"{kind}.cu"), out)
    return os.path.basename(os.path.normpath(path)), kind, lib, log, out


# Lane counters: (anchor line, counter slot) pairs. `lane_counting_copy` puts
# MRT_COUNT(slot) after each anchor it finds in a variant's physics.cuh and
# bounce_ad.cu (slot 2 and 3 under their condition); every anchor is a line
# both the parent's and the new designs have.
COUNT_SLOTS = ("step", "regenerate", "miss", "light hit", "metal", "dielectric", "diffuse",
               "light sample", "perlin")
COUNT_ANCHORS = (
    ("  ++rays;\n", "MRT_COUNT(0);"), ("  rays = rays + 1.0f;\n", "MRT_COUNT(0);"),
    ("  int samp = P.sample_lo + s.count;\n", "MRT_COUNT(1);"),
    ("    int samp = sampbase + s.count;\n", "MRT_COUNT(1);"),
    ("  out.img_idx = -1;\n", "if (!out.hit) MRT_COUNT(2);"),
    ("  out.is_light = mtype == (float)MAT_DIFFUSE_LIGHT;\n", "if (out.is_light) MRT_COUNT(3);"),
    ("  if (is_metal) {\n", "MRT_COUNT(4);"), ("  if (is_diel) {\n", "MRT_COUNT(5);"),
    ("  const bool is_iso = mtype == (float)MAT_ISOTROPIC;\n", "MRT_COUNT(6);"),
    ("    if (u_mix < 0.5f) {\n", "MRT_COUNT(7);"),
    ("  if (P.perlin && ttype == (float)TEX_PERLIN) {\n", "MRT_COUNT(8);"))
COUNT_CODE = """
__device__ unsigned long long mrt_counts[2 * 16];
// warps (even slots) and their active lanes (odd slots) that reach `slot`
__device__ __forceinline__ void mrt_count(int slot) {
  const unsigned mask = __activemask();
  if ((int)(threadIdx.x % 32) == __ffs(mask) - 1) {
    atomicAdd(&mrt_counts[2 * slot], 1ull);
    atomicAdd(&mrt_counts[2 * slot + 1], (unsigned long long)__popc(mask));
  }
}
#define MRT_COUNT(slot) mrt_count(slot)
"""
COUNT_EXPORT = """
extern "C" void mrt_read_counts(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, mrt_counts, sizeof(mrt_counts));
  static const unsigned long long zero[2 * 16] = {};
  cudaMemcpyToSymbol(mrt_counts, zero, sizeof(zero));
}
"""


def lane_counting_copy(path):
    """A copy of the variant directory `path` (in `path`/_count) whose B1 and
    B2 count their active lanes at COUNT_ANCHORS; the directory."""
    dst = os.path.join(path, "_count")
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    for name in os.listdir(path):
        if name.endswith((".cu", ".cuh", ".h")):
            shutil.copy(os.path.join(path, name), dst)
    for name in ("physics.cuh", "bounce_ad.cu"):
        f = os.path.join(dst, name)
        src = open(f).read()
        for anchor, add in COUNT_ANCHORS:
            src = src.replace(anchor, anchor + add + "\n")
        if name == "physics.cuh":
            src = src.replace("namespace {\n", "namespace {\n" + COUNT_CODE, 1)
            src = src.replace("}  // namespace\n", "}  // namespace\n" + COUNT_EXPORT, 1)
        open(f, "w").write(src)
    return dst


def sass_counts(lib_path, entry):
    """{kernel instance: {class: count}} of the SASS of `entry` in a library:
    local loads and stores, shared, global and generic loads, calls."""
    cuobjdump = os.path.join(os.path.dirname(
        __import__("miniraytracer_tpu_torch.utils.kernels", fromlist=["_nvcc"])._nvcc()),
        "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True).stdout
    res, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if entry in m.group(1) else None
            if cur:
                res[cur] = dict.fromkeys(("LDL", "STL", "LDS", "LDG", "LD", "CALL"), 0)
            continue
        if cur:
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)[.\s]", line)
            if m and m.group(1) in res[cur]:
                res[cur][m.group(1)] += 1
    return res


def launched_with(kind, lib, fn):
    """fn() with the wrappers of csrc/<kind>.cu launching `lib`."""
    from miniraytracer_tpu_torch.utils import kernels

    with cs.launching(kernels, kind, lib):
        return fn()


def in_turns(what, kind, libs, fn, reps, rounds=3, per=1, queued=False):
    """Median ms of `reps` calls of fn() (divided by `per`) for each variant,
    in turns; prints them beside the first variant's. With `queued`, a turn is
    the median device time of `reps` calls queued behind a spin
    (`chip_smoke.queued_ms`), so that a short kernel's wrapper is not what is
    timed."""
    for lib in libs.values():
        launched_with(kind, lib, fn)
    torch.cuda.synchronize()
    ms = {name: [] for name in libs}
    names = list(libs)
    turn = ((lambda: statistics.median(cs.queued_ms(fn, reps))) if queued else
            (lambda: cs.cuda_ms(lambda: [fn() for _ in range(reps)], 1)[0] / reps / per))
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            ms[name].append(launched_with(kind, libs[name], turn))
    base = statistics.median(ms[names[0]])
    print(f"  {what}:")
    for name, runs in ms.items():
        m = statistics.median(runs)
        print(f"    {name:10s} {m:.5f} ms ({m / base:.3f} of {names[0]}); runs "
              f"{[round(x, 5) for x in runs]}")


def time_b1(mrt, libs, dev):
    from miniraytracer_tpu_torch.ops import bounce

    pix = torch.arange(500 * 500, dtype=torch.int32, device=dev)
    first = next(iter(libs))
    for name, spp_sq, reps in (("cornell_box", 8, 3), ("cornell_box", 2, 5),
                               ("perlin_spheres", 8, 2)):
        meta, tables = bounce.pack_scene(getattr(mrt.scenes, name)(1.0).to(dev))
        kw = dict(width=500, height=500, max_bounces=32, spp_sq=spp_sq)
        frame = lambda: bounce._launch_kernel(meta, tables, pix, 0, spp_sq * spp_sq, 1000.0, **kw)
        ref = launched_with("bounce", libs[first], frame)
        for vname, lib in libs.items():
            out = launched_with("bounce", lib, frame)
            cs.check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                     f"B1 {vname} differs from {first} on {name} at {spp_sq ** 2} spp")
        print(f"  B1 on {name} at 500x500x{spp_sq ** 2}x32: every variant equals {first} on every "
              f"pixel (accum, count, rays); {int(ref[2].sum(dtype=torch.int64))} rays")
        in_turns(f"B1, the {name} frame at 500x500x{spp_sq ** 2}x32 ({reps} a timing)", "bounce",
                 libs, frame, reps)


def time_b2(mrt, libs, dev):
    from miniraytracer_tpu_torch.ops import bounce, bounce_ad, hybrid

    A = bounce_ad
    first = next(iter(libs))
    scene = mrt.scenes.cornell_box(1.0).to(dev)
    meta, cfg, outer, tables, pix, sb, state, residual = launched_with(
        "bounce_ad", libs[first],
        lambda: cs.launch_states(mrt, bounce, A, scene, 500, 500, 128, 32, False))
    res_f, res_i, res_k = residual
    n = 500 * 500
    t = outer // 4
    zeros = torch.zeros((3, n), device=dev)
    f_in = torch.cat([zeros, res_f[t], zeros[:2]])
    one = lambda: A.ad_step_fwd(meta, cfg, tables, t, f_in, res_i[t], res_k[t], pix, sb)
    scan = lambda keep: A.scan_forward(meta, cfg, outer, tables, *state, pix, sb, keep=keep)
    ref = launched_with("bounce_ad", libs[first], one)
    end = launched_with("bounce_ad", libs[first], lambda: scan(False))[0]
    for name, lib in libs.items():
        out = launched_with("bounce_ad", lib, one)
        cs.check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                 f"B2 {name} differs from {first} at launch {t}")
        if name != first:
            last, res = launched_with("bounce_ad", lib, lambda: scan(True))
            cs.check(all(torch.equal(a, b) for a, b in zip(last + res, end + residual)),
                     f"B2 {name} differs from {first} over the scan")
            del last, res
    print(f"  B2: every variant equals {first} on every row of launch {t} and on every "
          f"launch's state over the Cornell scan ({outer} launches)")
    in_turns(f"B2 at launch {t} of the Cornell scan (10 a timing)", "bounce_ad", libs, one, 10)
    del residual, res_f, res_i, res_k
    torch.cuda.empty_cache()
    in_turns(f"B2 over the whole Cornell scan, a launch ({outer} launches)", "bounce_ad", libs,
             lambda: scan(False), 1, per=outer)
    print("  the host's time to enqueue the scan, a launch (best of 3):")
    for name, lib in libs.items():
        host = min(launched_with("bounce_ad", lib, lambda: cs.cuda_and_host_ms(
            lambda: scan(False)))[1] for _ in range(3)) / outer
        print(f"    {name:10s} {host:.4f} ms")
    for mode, name in (("ext", "triangles"), ("ext_mat", "random_spheres"), ("image", "earth")):
        sc = cs.ext_scene(mrt, name).to(dev)
        meta, cfg, tables, images, pix, sb, _, states = cs.ext_states(
            A, hybrid, sc, 500, 8, 32, (20,), False)
        rf, ri, rk, ext = states[20]
        f_in = torch.cat([torch.zeros((3, n), device=dev), rf, torch.zeros((2, n), device=dev)])
        one = lambda: A.ad_step_fwd(meta, cfg, tables, 20, f_in, ri, rk, pix, sb, ext, images)
        ref = launched_with("bounce_ad", libs[first], one)
        for vname, lib in libs.items():
            out = launched_with("bounce_ad", lib, one)
            cs.check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                     f"B2[{mode}] {vname} differs from {first}")
        in_turns(f"B2[{mode}] on {name} at launch 20, every row equal (10 a timing)",
                 "bounce_ad", libs, one, 10)
        del states
        torch.cuda.empty_cache()


# fp32 instructions, integer instructions and table words loaded, counted from
# physics.cuh per event (--fmad=false: a multiply and an add are two; a hash is
# ~8 integer instructions, a uniform one hash): the sweep per primitive, then
# per step, per regeneration and per shading branch. The same counts as
# chip_smoke.FP32_OPS_PER_RAY_FWD's 560 for the Cornell box.
SWEEP_COST = {"S": (27, 3, 10), "R": (37, 3, 17), "Tc": (45, 3, 11), "Bx": (55, 4, 13),
              "V": (60, 12, 16)}
EVENT_COST = {"step": (46, 16, 0), "regenerate": (60, 40, 21), "miss": (12, 0, 0),
              "light hit": (16, 4, 11), "metal": (60, 30, 11), "dielectric": (70, 12, 11),
              "diffuse": (185, 60, 28), "light sample": (15, 4, 17), "perlin": (600, 120, 210)}


def lane_counts(mrt, built, dev):
    """Active-lane shares and events a ray of B1 (the Cornell frame at
    500x500x64x32) and B2 (the whole Cornell scan) of each variant, from its
    lane-counting build."""
    from miniraytracer_tpu_torch.ops import bounce, bounce_ad

    scene = mrt.scenes.cornell_box(1.0).to(dev)
    meta, tables = bounce.pack_scene(scene)
    pix = torch.arange(500 * 500, dtype=torch.int32, device=dev)
    sweep = [sum(meta[k] * c[i] for k, c in SWEEP_COST.items()) for i in range(3)]
    _, claim, k_sub, outer = bounce_ad.scan_plan(128, 32)
    cfg = bounce_ad.StepConfig(500, 500, 8, 32, 128, claim, k_sub)
    sb = torch.zeros_like(pix)
    state = bounce_ad.initial_state(scene, pix, sb, 128, width=500, height=500, sq_off=8)
    runs = {"bounce": ("B1, Cornell 500x500x64x32", lambda: bounce._launch_kernel(
                meta, tables, pix, 0, 64, 1000.0, width=500, height=500, max_bounces=32,
                spp_sq=8)),
            "bounce_ad": ("B2, the Cornell scan", lambda: bounce_ad.scan_forward(
                meta, cfg, outer, tables, *state, pix, sb, keep=False))}
    for name, kind, lib in built:
        what, fn = runs[kind]
        lib.mrt_read_counts.argtypes = [ctypes.c_void_p]
        raw = (ctypes.c_ulonglong * 32)()
        launched_with(kind, lib, fn)
        torch.cuda.synchronize()
        lib.mrt_read_counts(raw)
        warps, lanes = raw[0::2], raw[1::2]
        rays = max(lanes[0], 1)
        shares = ", ".join(f"{slot} {lanes[i] / max(32 * warps[i], 1):.3f} ({lanes[i] / rays:.3f} "
                           f"a ray)" for i, slot in enumerate(COUNT_SLOTS) if warps[i])
        per_ray = [sweep[c] + sum(EVENT_COST[slot][c] * lanes[i] / rays
                                  for i, slot in enumerate(COUNT_SLOTS)) for c in range(3)]
        print(f"  {name} {what}: {lanes[0]} rays; active lanes of a warp where (share, events "
              f"a ray): {shares}")
        print(f"    a ray, counted from the source per event: fp32 {per_ray[0]:.0f}, integer "
              f"{per_ray[1]:.0f}, table words loaded {per_ray[2]:.0f} (the bound counts "
              f"{cs.FP32_OPS_PER_RAY_FWD} fp32)")


def same_b3(what, libs, fn):
    """B3's outputs with every variant against the first: `d_f` (and `d_ext`)
    bit for bit, `d_tab` (float atomics in another order) within 2e-4 of its
    largest entry; probes are timed only."""
    first = next(iter(libs))
    ref = launched_with("bounce_ad", libs[first], fn)
    probes = [name for name in libs if name.startswith("probe_")]
    worst = 0.0
    for name, lib in libs.items():
        if name in probes:
            continue
        out = launched_with("bounce_ad", lib, fn)
        rel = float((out[1] - ref[1]).abs().max() / ref[1].abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
        cs.check(cs.equal_outputs([out[0], *out[2:]], [ref[0], *ref[2:]]) and rel <= 2e-4,
                 f"{what}: {name} differs from {first} (d_tab {rel:.3g} of its largest)")
    print(f"  {what}: every variant's d_f{' and d_ext' if len(ref) > 2 else ''} equal to "
          f"{first}'s bit for bit, d_tab within {worst:.3g} of its largest entry"
          + (f" (probes, timed only: {', '.join(probes)})" if probes else ""))


def time_b3(mrt, libs, dev):
    from miniraytracer_tpu_torch.ops import bounce, bounce_ad, hybrid

    A = bounce_ad
    scene = mrt.scenes.cornell_box(1.0).to(dev)
    meta, cfg, outer, tables, pix, sb, _, residual = cs.launch_states(
        mrt, bounce, A, scene, 500, 500, 128, 32, False)
    res_f, res_i, res_k = residual
    gen = torch.Generator(device=dev).manual_seed(0)
    cot = torch.randn((A.NF, 500 * 500), device=dev, generator=gen)
    cot0 = torch.zeros((A.NF, 500 * 500), device=dev)
    cot0[:3] = 1.0
    t = outer // 4
    for at in (t, outer // 2):
        same_b3(f"B3 at launch {at} of the Cornell scan", libs, lambda: A.ad_step_bwd(
            meta, cfg, tables, at, res_f[at], res_i[at], res_k[at], pix, sb, cot, None))
    one = lambda: A.ad_step_bwd(meta, cfg, tables, t, res_f[t], res_i[t], res_k[t], pix, sb, cot,
                                None)
    in_turns(f"B3 at launch {t} of the Cornell scan (5 a timing)", "bounce_ad", libs, one, 5)
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
        one = lambda: A.ad_step_bwd(meta, cfg, tables, 20, rf, ri, rk, pix, sb, cot, None, ext,
                                    images)
        same_b3(f"B3[{mode}] on {name} at launch 20", libs, one)
        in_turns(f"B3[{mode}] on {name} at launch 20 (5 a timing)", "bounce_ad", libs, one, 5,
                 rounds=5)
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


def same_rows(what, kind, libs, fn):
    """fn()'s outputs with every variant equal to the first variant's, bit for
    bit; a probe (a DIR named probe_*, which computes something else to
    time a part of the kernel) is timed only."""
    first = next(iter(libs))
    ref = launched_with(kind, libs[first], fn)
    probes = [name for name in libs if name.startswith("probe_")]
    for name, lib in libs.items():
        if name not in probes:
            out = launched_with(kind, lib, fn)
            cs.check(cs.equal_outputs(out, ref), f"{what}: {name} differs from {first}")
    print(f"  {what}: every variant equals {first} bit for bit"
          + (f" (probes, timed only: {', '.join(probes)})" if probes else ""))


def time_b5(mrt, libs, dev):
    """B5 alone on the lanes of queue steps 0, 2 and a late one of earth's and
    book2_final's 500x500 renders (every row equal), timed at step 2."""
    from miniraytracer_tpu_torch.models import integrator
    from miniraytracer_tpu_torch.ops import hybrid

    for name in ("earth", "book2_final"):
        sc = getattr(mrt.scenes, name)(1.0).to(dev)
        calls = cs.queue_snapshots(integrator, hybrid, sc, 500, 500, 2, 32,
                                   integrator.wq_auto_lanes(sc, 500 * 500))
        for t in (0, 2, len(calls) - 4):
            args = calls[t]
            alive = int((args[1][hybrid.SH_ALIVE] > 0).sum())
            same_rows(f"B5 {name} queue step {t} ({args[1].shape[1]} lanes, {alive} alive)",
                      "hybrid", libs, lambda: hybrid.shade_step(*args))
        args = calls[2]
        in_turns(f"B5 alone, {name} queue step 2, device ms a launch", "hybrid", libs,
                 lambda: hybrid.shade_step(*args), 20, queued=True)
        del calls
        torch.cuda.empty_cache()


def time_b6(mrt, libs, dev):
    """B6 alone on the 131,072 points of random_spheres_2's queue step 2 and on
    uniform points (every value equal), timed on the first."""
    from miniraytracer_tpu_torch.models import integrator
    from miniraytracer_tpu_torch.ops import noise
    from miniraytracer_tpu_torch.ops.vecmath import V3

    rs2 = mrt.scenes.random_spheres_2(1.0).to(dev)
    ptab, p, n_perlin = cs.turbulence_points(integrator, noise, rs2, 500, 2)
    gen = torch.Generator(device=dev).manual_seed(5)
    u = torch.rand((3, 1_000_003), generator=gen, device=dev) * 600.0 - 300.0
    same_rows(f"B6 on random_spheres_2's queue step 2 ({p.x.numel()} points, {n_perlin} on a "
              f"Perlin surface)", "noise", libs, lambda: noise.flash_turbulence(ptab, p))
    same_rows("B6 on 1,000,003 uniform points in [-300, 300]^3", "noise", libs,
              lambda: noise.flash_turbulence(ptab, V3(u[0], u[1], u[2])))
    in_turns(f"B6 alone, {p.x.numel()} points, device ms a launch", "noise", libs,
             lambda: noise.flash_turbulence(ptab, p), 20, queued=True)


TRIG_SRC = """#include "physics.cuh"
__global__ void trig_kernel(unsigned long long* bad) {
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t u = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; u < (1ull << 32);
       u += stride) {
    const float x = __uint_as_float((uint32_t)u);
    const float v[4] = {sinf(x), exact_sinf(x), cosf(x), exact_cosf(x)};
    for (int f = 0; f < 2; ++f) {
      if (__float_as_uint(v[2 * f]) == __float_as_uint(v[2 * f + 1])) continue;
      const bool nans = v[2 * f] != v[2 * f] && v[2 * f + 1] != v[2 * f + 1];
      atomicAdd(&bad[2 * f + (nans ? 1 : 0)], 1ull);
    }
  }
}
extern "C" int mrt_trig_check(unsigned long long* out) {
  unsigned long long* bad;
  cudaMalloc(&bad, 4 * sizeof(unsigned long long));
  cudaMemset(bad, 0, 4 * sizeof(unsigned long long));
  trig_kernel<<<132 * 16, 256>>>(bad);
  cudaMemcpy(out, bad, 4 * sizeof(unsigned long long), cudaMemcpyDeviceToHost);
  cudaFree(bad);
  return (int)cudaGetLastError();
}
"""


def trig_check_build(path):
    """The library of TRIG_SRC built against the physics.cuh of `path`."""
    src = os.path.join(path, "trig_check.cu")
    with open(src, "w") as f:
        f.write(TRIG_SRC)
    return nvcc_build(src, os.path.join(path, "libtrig_check.so"))[0]


def trig_check(lib):
    """physics.cuh's exact_sinf/exact_cosf against CUDA's sinf/cosf on all
    2^32 float inputs, bit for bit."""
    out = (ctypes.c_ulonglong * 4)()
    rc = lib.mrt_trig_check(out)
    cs.check(rc == 0, f"the trig check did not run: CUDA error {rc}")
    print(f"  exact_sinf / exact_cosf against sinf / cosf on all 2^32 inputs: {out[0]} / {out[2]} "
          f"differ in their bits ({out[1]} / {out[3]} more where both are NaN)")
    cs.check(out[0] == 0 and out[2] == 0, "exact_sinf or exact_cosf differs from the library's")


PROBE = {
    "bounce": [("fused_render_kernel", "fused_render_grid")],
    "bounce_ad": [("ad_step_fwd_kernel<false, false, false>", "ad_step_fwd_grid"),
                  ("ad_step_bwd_kernel<false, false, false>", "ad_step_bwd_grid")],
}
PROBE_SRC = """#include "{kind}.cu"
extern "C" void mrt_{fn}(const int* ip, int* out) {{
  int dev = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], {kernel}, 128, 0);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  out[2] = (ip[0] + 127) / 128;
  out[3] = 128;
  out[4] = 0;
}}
"""


# The grid queries of B5 and B6 (absent from the parent's design, one thread
# a unit): the function, and what it is asked (filled in by main).
GRID_FNS = {"hybrid": "mrt_shade_step_grid", "noise": "mrt_turbulence_grid"}
GRID_ARGS = {"noise": [("turbulence_kernel at 131,072 points", 131072)]}


def shade_params(bounce, meta, n):
    """The parameter block of a shade step on n lanes of the packed scene
    `meta`, as `hybrid.shade_step` builds it (an atlas of one 512 x 1024
    image), as a ctypes array."""
    ip = bounce.kernel_params(meta, n, 0, 0, width=1, height=1, max_bounces=0, spp_sq=1)
    ip += [int(bool(meta.get("ext_mat"))), int(meta["image"]), 1, 512, 1024]
    return (ctypes.c_int * len(ip))(*ip)


def grid_of(path, kind, kernel, fn, lib, ip):
    """(blocks an SM holds, SMs, blocks, threads, dynamic shared bytes) of a
    launch of B1, B2 or B3 with the parameter block `ip`: the variant's own
    `mrt_<fn>`, or for a design without one (one thread a lane) a probe built
    beside it."""
    if not hasattr(lib, f"mrt_{fn}"):
        src = os.path.join(path, f"probe_{fn}.cu")
        with open(src, "w") as f:
            f.write(PROBE_SRC.format(kind=kind, fn=fn, kernel=kernel))
        lib = nvcc_build(src, os.path.join(path, f"libprobe_{fn}.so"))[0]
    out = (ctypes.c_int * 5)()
    getattr(lib, f"mrt_{fn}")((ctypes.c_int * len(ip))(*ip), out)
    return tuple(out)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dirs", nargs="+")
    parser.add_argument("--only", default=",".join(GROUPS))
    parser.add_argument("--count", action="store_true")
    parser.add_argument("--trig", action="store_true")
    args = parser.parse_args()
    cs.check(torch.cuda.is_available(), "no CUDA device: this script needs a GPU")
    import miniraytracer_tpu_torch as mrt
    from miniraytracer_tpu_torch.ops import bounce, bounce_ad, hybrid
    from miniraytracer_tpu_torch.utils import kernels

    groups = args.only.split(",")
    kinds = [k for k in KINDS if any(GROUPS[g] == k for g in groups)]
    jobs = [(d, k) for d in args.dirs for k in kinds if os.path.exists(os.path.join(d, f"{k}.cu"))]
    card = cs.card()
    print(card)
    counting = []
    with concurrent.futures.ThreadPoolExecutor(2 * len(jobs) + 4) as pool:
        built = list(pool.map(lambda job: build(*job), jobs))
        if args.count:
            copies = {d: lane_counting_copy(d) for d in args.dirs}
            counting = list(pool.map(
                lambda job: (os.path.basename(os.path.normpath(job[0])), job[1],
                             build(copies[job[0]], job[1])[2]),
                [job for job in jobs if job[1] in ("bounce", "bounce_ad")]))
        trig = pool.submit(trig_check_build, args.dirs[-1]) if args.trig else None
        for name in ("bounce", "bounce_ad", "flash", "hybrid", "noise"):
            kernels.build(name)
    meta, _ = bounce.pack_scene(mrt.scenes.cornell_box(1.0))
    _, claim, k_sub, _ = bounce_ad.scan_plan(128, 32)
    earth_meta, _ = hybrid.pack_scene_hybrid(mrt.scenes.earth(1.0))
    book2_meta, _ = hybrid.pack_scene_hybrid(mrt.scenes.book2_final(1.0))
    GRID_ARGS["hybrid"] = [("shade_step_kernel on earth's 131,072 lanes",
                            shade_params(bounce, earth_meta, 131072)),
                           ("shade_step_kernel on book2_final's 65,536 lanes",
                            shade_params(bounce, book2_meta, 65536))]
    ips = {"bounce": bounce.kernel_params(meta, 250000, 0, 64, width=500, height=500,
                                          max_bounces=32, spp_sq=8),
           "bounce_ad": bounce_ad.kernel_params(
               meta, bounce_ad.StepConfig(500, 500, 8, 32, 128, claim, k_sub), 250000, 50)}
    libs = {k: {} for k in KINDS}
    for name, kind, lib, log, path in built:
        libs[kind][name] = lib
        for entry in ENTRIES[kind]:
            for line in cs.ptxas_lines(log, entry):
                print(f"  {name}: {line.strip()}")
            for fn, c in sass_counts(path, entry).items():
                print(f"  {name}: SASS of {fn[:60]}: {c}")
        grids = []
        if kind in PROBE:
            for kernel, fn in PROBE[kind]:
                grids.append((f"{kernel.split('<')[0]} on the Cornell box at 500x500",
                              grid_of(os.path.dirname(path), kind, kernel, fn, lib, ips[kind])))
        elif kind in GRID_FNS and hasattr(lib, GRID_FNS[kind]):
            for what, arg in GRID_ARGS[kind]:
                out = (ctypes.c_int * 5)()
                getattr(lib, GRID_FNS[kind])(arg, out)
                grids.append((what, tuple(out)))
        elif kind in GRID_FNS:
            print(f"  {name}: {GRID_FNS[kind]} absent: one thread a unit, "
                  f"{'128' if kind == 'hybrid' else '256'} a block")
        for what, (per_sm, sms, blocks, threads, smem) in grids:
            print(f"  {name}: {what}: {per_sm} blocks "
                  f"of {threads} an SM (occupancy API) x {sms} SMs; launches {blocks} blocks, "
                  f"{smem} B of dynamic shared memory ({blocks / max(per_sm * sms, 1):.2f} "
                  f"waves)")
    dev = torch.device("cuda")
    if trig is not None:
        trig_check(trig.result())
    if counting:
        lane_counts(mrt, counting, dev)
    if "b1" in groups and libs["bounce"]:
        time_b1(mrt, libs["bounce"], dev)
    if "b2" in groups and libs["bounce_ad"]:
        time_b2(mrt, libs["bounce_ad"], dev)
    if "b3" in groups and libs["bounce_ad"]:
        time_b3(mrt, libs["bounce_ad"], dev)
    if "cluster" in groups and libs["flash"]:
        time_cluster_loop(mrt, libs["flash"], dev)
    if "b5" in groups and libs["hybrid"]:
        time_b5(mrt, libs["hybrid"], dev)
    if "b6" in groups and libs["noise"]:
        time_b6(mrt, libs["noise"], dev)
    print(card)


if __name__ == "__main__":
    main()
