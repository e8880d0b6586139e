"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `miniraytracer_tpu_torch/csrc` and drives
the ported paths on the card:

- the forward render: kernel B1 (`bounce.cu`) against its plain PyTorch
  version and against the real reference renderer's frames, then the Cornell
  box at 500x500, 64 spp, 32 bounces through the public `render` entry point;
- the train step: kernels B2/B3 (`bounce_ad.cu`, the scan step and its
  hand-derived backward) against their plain versions on five scenes lane
  by lane, then three steps of `make_train_step` on the Cornell box at
  500x500, 32 bounces, 128 samples a step, whose loss must fall on a
  held-out sample set;
- the hybrid forward render: kernels B7/B8 (`flash.cu`, the dense nearest
  triangle / nearest sphere sweeps) and B4 (`hybrid.cu`, the step that takes
  their winner as a candidate) against their plain versions on rays and lane
  states of real wave steps at 500x500, whole renders against the plain ones
  and against the reference renderer's frames, then random_spheres (486
  spheres, a material each) at 500x500, 64 spp, 32 bounces through `render`,
  and a procedural scene with 1000 triangles the same way;
- the work-queue forward render: kernels B13/B12 (`flash.cu`, the gated and
  the streamed sphere sweep over Morton clusters) against their plain
  versions and against the dense sweep B8 on rays of real queue steps, B5
  (`hybrid.cu`, the shade step) against its plain version lane by lane in its
  four modes, whole queue renders against the plain ones and book2_final
  against the reference renderer's frame, then earth and book2_final (1006
  spheres, 400 boxes) at 500x500, 64 spp, 32 bounces through `render`, and a
  procedural scene with 5000 spheres for the streamed sweep;
- the renderers whose shading is tensor operations (the work queue without
  its shade kernel, the plain wavefront): kernel B6 (`noise.cu`, Perlin
  turbulence) against its plain version on the points of a real queue step
  and on uniform points, whole renders through B6 and the sweeps against the
  plain ones, random_spheres_2 against the reference renderer's frame, then
  random_spheres_2 (487 spheres, Perlin, an earth map) at 500x500, 64 spp, 32
  bounces through `render`.

- the triangle tiers: kernels B10, B11 and B9 (`flash.cu`, the clustered
  triangle sweeps, one cluster loop with B12 and B13) against their plain
  versions and against the dense sweep B7 on rays of real queue steps of the
  triangles scene (with stand-in meshes of the reference's size, 11,264
  triangles, written by `scenes.write_stand_in_meshes`: the reference's OBJ
  files are not in the repository), whole queue renders against the plain
  ones, then the triangles scene at 500x500, 64 spp, 32 bounces through
  `render`, and a 49,152-triangle scene, past the JAX package's resident
  budget, for B11;
- the reference renderer's 64-spp frames: the work queue at 100x100, 64 spp,
  16 bounces on the five scenes that need no asset file, held to the bounds
  of tests/test_reference_parity.py;
- the hybrid-ext train step (phases 28-30): kernels B2/B3 in their ext,
  ext-material and image modes (the candidate from outside each step an
  input, its cotangent an output) against their plain versions lane by lane
  on states of real scan steps, the whole hybrid-ext scan (the kernels and
  the sweeps of flash.cu under their custom VJPs) against its plain version
  in loss and gradients on the four scenes the JAX package trains with
  fused="ext" and a 200-triangle probe, then `make_train_step(fused_ad="ext")`
  at 500x500, 32 bounces, 8 samples a step: three steps on random_spheres
  whose loss on a held-out sample set must fall, and timed steps on
  triangles (stand-in meshes), earth and book2_final;
- the JAX package's default train step and its progressive renderer (phases
  31-33): the packed scan of `make_train_step(fused_ad=False)` (the bounce
  in tensor operations under autograd, each scan step rematerialised, the
  sweeps of flash.cu under their custom VJPs) against its plain version in
  loss and gradients on random_spheres_2 (B8), triangles (B10),
  book2_final (B13) and two probes (B7, B12), with the recompute of a step
  equal to its forward to the bit; then random_spheres_2 trained at 500x500, 32 bounces on the JAX
  package's AD protocol (`pack=16, spp_step=8`: 2,000,000 items, 125,000
  lanes, 129 scan steps) beside `fused_ad="ext"` on the same protocol, the
  fused Cornell step against the packed scan at 500x500, and
  `render_progressive` against the reference renderer's frames.
- the command line and the BVH (phases 34-35): `python -m
  miniraytracer_tpu_torch` at the JAX package's default path (the triangles
  scene with the stand-in meshes, progressive, 500x500, 32 bounces, 4
  samples, checkpoints) as a subprocess, then `cli.main` in this process
  with each renderer (auto on the Cornell box through B1, its PNG equal to
  `save_png(drago(render(...)))`; hybrid on random_spheres; workqueue on
  book2_final; wavefront on the Cornell box (B1, as the JAX CLI takes its
  fused kernel there) and on earth (tensor operations); progressive on
  random_spheres_2) and a resume from
  the subprocess's pass-2 checkpoint, equal to its straight run to the bit;
  then the BVH (`ops/bvh.py`) built over the triangles scene and walked on
  the rays of phase 23's queue step, against B10 and timed beside it.

With a copy of the parent commit's `miniraytracer_tpu_torch/csrc/` in
`miniraytracer_tpu_torch/_build/parent_csrc/` (git-ignored), the redesigned
kernels are also held against the parent's builds in the same run: B1 bit
for bit on the Cornell and the perlin_spheres 500x500x64x32 frames (phase
5), B2 bit for bit at launch 50 and over the whole Cornell scan and at every
launch of phases 6 and 28, B3's d_f bit for bit at launch 50 of the Cornell
scan (phase 7) and its d_f and d_ext at every launch of phase 28, each mode
timed at its last (d_tab, float atomics, within 2e-4), B4 bit for bit
(phase 9), B5 on earth's and book2_final's queue steps (phase 14) and B6 on
both point sets (phase 18) bit for bit, each timed in turns (B4-B6 by
`queued_ms`: their wrappers take longer than they do); and the cluster loop
of B9-B13 is timed against the parent's (phases 13, 23, 25). Without it
those comparisons are skipped.

Each main path is driven with the kernels' launch counts set to 0 just before
and read just after. Every phase raises on failure, so the exit code is
nonzero and no result line is printed. The last three lines of standard
output are the card's name and power limit, a JSON object with one entry per
kernel (launches on the main path, error against the plain version, time,
the plain version's time, the bound), and a JSON object naming the device.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from miniraytracer_tpu_torch.utils.profiling import device_share

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


def queued_ms(fn, reps=20):
    """Device milliseconds of each of `reps` calls of fn(), between CUDA events
    around each call, all queued behind a spin kernel first: the card then
    runs them back to back whatever the host's pace, so a short kernel's
    time is not its wrapper's (B4-B6 take 0.01-0.04 ms on the card and
    0.05-0.15 ms of Python to enqueue). fn() must not synchronise."""
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of one thread spinning
    t0 = time.perf_counter()
    for start, end in events:
        start.record()
        fn()
        end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    check(host < 0.05, f"enqueueing {reps} calls took {1e3 * host:.1f} ms: the spin ran out")
    return [start.elapsed_time(end) for start, end in events]


# The parent commit's kernels, for holding the redesigned ones against them
# on the same card in the same run (B1-B6 bit for bit, B3's d_f, and the
# cluster loop of B9-B13, each also timed in turns): a copy of the
# parent's `miniraytracer_tpu_torch/csrc/` put into PARENT_CSRC, a git-ignored
# directory, for that run only. Without it (a checkout of the repository) the
# comparisons are skipped and say so. The libraries have the same C
# interface, so the wrappers launch either (`launching`).
PARENT_CSRC = os.path.join(HERE, "miniraytracer_tpu_torch", "_build", "parent_csrc")
PARENT_KERNELS = ("bounce", "bounce_ad", "flash", "hybrid", "noise")
parent_libs: dict = {}


def build_parent(kernels, name):
    """Build csrc/<name>.cu of PARENT_CSRC as `kernels.build` builds the
    checkout's, and load it: the CDLL, or None without PARENT_CSRC."""
    src = os.path.join(PARENT_CSRC, f"{name}.cu")
    if not os.path.exists(src):
        return None
    out = os.path.join(PARENT_CSRC, f"lib{name}.so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"the parent's {name}.cu did not build:\n{proc.stderr}")
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(out)
    lib.mrt_error_string.argtypes = [ctypes.c_int]
    lib.mrt_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def launching(kernels, name, lib):
    """While inside, the wrappers of csrc/<name>.cu launch the library `lib`
    (another build of the same C interface)."""
    saved = kernels.load(name)
    kernels._loaded[name] = lib
    try:
        yield
    finally:
        kernels._loaded[name] = saved


def against_parent(kernels, name, fn, reps, rounds=1, queued=False):
    """fn() timed with this checkout's kernels and with the parent's, in turns
    (parent, new, new, parent; `rounds` times), `reps` calls a timing: (new ms
    list, parent ms list) a call, or None without the parent's build. With
    `queued`, a turn is the median of `queued_ms`: a short kernel's device
    time, not its wrapper's."""
    if parent_libs.get(name) is None:
        return None
    libs = {"parent": parent_libs[name], "new": kernels.load(name)}
    for key in libs:  # a kernel's module loads at its first launch
        with launching(kernels, name, libs[key]):
            fn()
    ms = {"new": [], "parent": []}
    for _ in range(rounds):
        for key in ("parent", "new", "new", "parent"):
            with launching(kernels, name, libs[key]):
                ms[key].append(statistics.median(queued_ms(fn, reps)) if queued else
                               cuda_ms(lambda: [fn() for _ in range(reps)], 1)[0] / reps)
    return ms["new"], ms["parent"]


def equal_outputs(a, b) -> bool:
    """Whether two kernel results (tensors, or tuples and lists of them) are
    equal bit for bit."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(equal_outputs(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and torch.equal(a.view(torch.int32) if a.dtype == torch.float32
                                                  else a, b.view(torch.int32)
                                                  if b.dtype == torch.float32 else b)
    return a == b


def parent_equal(kernels, name, fn, what, check_bits=True, say=True):
    """fn() with this checkout's csrc/<name>.cu and with the parent's: the two
    results, or None without the parent's build. With `check_bits`, fails
    unless they are equal bit for bit."""
    if parent_libs.get(name) is None:
        if say:
            print(f"    {what}: the parent's build absent: not compared")
        return None
    with launching(kernels, name, parent_libs[name]):
        old = fn()
    new = fn()
    if check_bits:
        check(equal_outputs(new, old), f"{what}: differs from the parent's build")
        if say:
            print(f"    {what}: equal to the parent's build bit for bit")
    return new, old


def b3_parent_equal(kernels, fn, what):
    """B3 (`bounce_ad.ad_step_bwd`, fn()) with this checkout's build and the
    parent's: `d_f` (and `d_ext`) bit for bit, `d_tab`, which sums float
    atomics in another order, within 2e-4 of its largest entry. Returns
    whether the parent's build was there to compare."""
    both = parent_equal(kernels, "bounce_ad", fn, what, check_bits=False, say=False)
    if both is None:
        print(f"    {what}: the parent's build absent: not compared")
        return False
    (d_new, tab_new, *ext_new), (d_old, tab_old, *ext_old) = both
    tab_rel = (float((tab_new - tab_old).abs().max() / tab_old.abs().max().clamp_min(1e-30))
               if tab_old.numel() else 0.0)
    same = equal_outputs([d_new, *ext_new], [d_old, *ext_old])
    print(f"    {what}: d_f{' and d_ext' if ext_new else ''} equal to the parent's bit for bit: "
          f"{same}; d_tab max err {tab_rel:.3g} of its largest entry")
    check(same and tab_rel <= 2e-4, f"{what}: B3 differs from the parent's")
    return True


def print_grid(kernels, fn, bounce_ad, meta, cfg, n, t, what):
    """The grid `mrt_<fn>` reports for a launch of the fused class."""
    grid = (ctypes.c_int * 5)()
    getattr(kernels.load("bounce_ad"), fn)(
        (ctypes.c_int * bounce_ad._N_IPARAMS)(*bounce_ad.kernel_params(meta, cfg, n, t)), grid)
    print(f"  {what}'s grid: {grid[0]} blocks of {grid[3]} an SM (occupancy API) x {grid[1]} SMs"
          f" = {grid[2]} blocks, {grid[4]} B of tables in shared memory")


def per_launch(res, launches):
    """against_parent's times of a whole scan, a launch."""
    return None if res is None else tuple([t / launches for t in ms] for ms in res)


def print_against_parent(what, res, card_line):
    if res is None:
        print(f"    {what}: the parent's design not built (no {PARENT_CSRC}): not compared")
        return None
    new, old = res
    print(f"    {what}: new design {new} ms, parent's {old} ms (medians {statistics.median(new):.4f}"
          f" / {statistics.median(old):.4f}, ratio {statistics.median(new) / statistics.median(old):.3f})"
          f" on {card_line}")
    return {"new_ms": statistics.median(new), "parent_ms": statistics.median(old)}


def ptxas_lines(log, entry):
    """ptxas's -v lines (registers, stack, spills) of each entry function of a
    build log whose mangled name holds `entry`, with the template arguments."""
    out, current = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            current = name if entry in name else None
            if current:
                out.append(f"{entry}{name[name.index(entry) + len(entry):][:24]}")
        elif current and ("registers" in line or "stack frame" in line):
            out.append("      " + line.strip())
    return out


def print_ptxas(kernels, name, entry):
    """ptxas's lines of `entry` in this checkout's build of csrc/<name>.cu and,
    where it was built, in the parent's."""
    logs = [("", kernels.build_log(name))]
    parent_log = os.path.join(PARENT_CSRC, f"lib{name}.so.log")
    if parent_libs.get(name) is not None and os.path.exists(parent_log):
        with open(parent_log) as f:
            logs.append(("the parent's ", f.read()))
    for who, log in logs:
        print(f"  {who}{entry}, ptxas -v:")
        for line in ptxas_lines(log, entry):
            print("   ", line)


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
    t_start = time.perf_counter()
    check(torch.cuda.is_available(), "no CUDA device: this script needs a GPU")
    card_line = card()
    print(card_line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    import miniraytracer_tpu_torch as mrt
    from miniraytracer_tpu_torch.ops import bounce, bounce_ad, flash, hybrid, noise
    from miniraytracer_tpu_torch.utils import kernels

    # 2. build the kernels from the sources in this checkout
    t0 = time.perf_counter()
    names = ("bounce", "bounce_ad", "flash", "hybrid", "noise")
    with concurrent.futures.ThreadPoolExecutor(len(names) + len(PARENT_KERNELS)) as pool:
        parents = [pool.submit(build_parent, kernels, n) for n in PARENT_KERNELS]
        list(pool.map(kernels.build, names))  # one nvcc each, side by side
        parent_libs.update(zip(PARENT_KERNELS, (f.result() for f in parents)))
    print(f"phase 2: built {', '.join(f'csrc/{n}.cu' for n in names)} in "
          f"{time.perf_counter() - t0:.2f} s; the parent's design of "
          f"{', '.join(PARENT_KERNELS)}: "
          f"{'built' if all(parent_libs.values()) else 'absent, not compared'}")
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
    kw64 = dict(kw, spp_sq=8)
    run_k = lambda: bounce.render_wavefront_fused_pixels(scene, pix, 0, 4, 1000.0, **kw)
    run_p = lambda: bounce.render_wavefront_fused_pixels_plain(scene, pix, 0, 4, 1000.0, **kw)
    plain_ms, kernel_ms = [], []
    for fn, out in ((run_p, plain_ms), (run_k, kernel_ms), (run_k, kernel_ms),
                    (run_p, plain_ms)):
        out.extend(cuda_ms(fn, 1))
    print(f"  500x500x4spp x32 bounces: kernel {kernel_ms} ms, plain {plain_ms} ms "
          f"on {card_line}")

    # the redesign against the parent's build: the 64-spp frame bit for bit,
    # then B1 alone on it in turns
    print("  B1 (fused_render_kernel<STAGED>), ptxas -v:")
    for line in ptxas_lines(kernels.build_log("bounce"), "fused_render_kernel"):
        print("   ", line)
    meta5, tables5 = bounce.pack_scene(scene)
    grid = (ctypes.c_int * 5)()
    kernels.load("bounce").mrt_fused_render_grid(
        (ctypes.c_int * bounce._N_IPARAMS)(*bounce.kernel_params(meta5, 500 * 500, 0, 64, **kw64)),
        grid)
    print(f"  B1's grid: {grid[0]} blocks of {grid[3]} an SM (occupancy API) x {grid[1]} SMs = "
          f"{grid[2]} blocks, {grid[4]} B of tables in shared memory")
    frame64 = lambda: bounce._launch_kernel(meta5, tables5, pix, 0, 64, 1000.0, **kw64)
    parent_equal(kernels, "bounce", frame64,
                 "B1, the Cornell frame 500x500x64x32 (accum, count, rays of every pixel)")
    b1_vs = print_against_parent("B1 alone, the Cornell frame 500x500x64x32",
                                 against_parent(kernels, "bounce", frame64, 1, rounds=2),
                                 card_line)

    # B1 on perlin_spheres: the turbulence it shares with B6 (physics.cuh)
    # over the Perlin tables it stages
    perlin = mrt.scenes.perlin_spheres(1.0).to(dev)
    meta_p, tables_p = bounce.pack_scene(perlin)
    frame_p = lambda: bounce._launch_kernel(meta_p, tables_p, pix, 0, 64, 1000.0, **kw64)
    parent_equal(kernels, "bounce", frame_p,
                 "B1, the perlin_spheres frame 500x500x64x32 (accum, count, rays of every pixel)")
    b1p_vs = print_against_parent("B1 alone, the perlin_spheres frame 500x500x64x32",
                                  against_parent(kernels, "bounce", frame_p, 1, rounds=1),
                                  card_line)

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
        "frame_ms": b1_vs["new_ms"] if b1_vs else None,
        "parent_frame_ms": b1_vs["parent_ms"] if b1_vs else None,
        "perlin_frame_ms": b1p_vs["new_ms"] if b1p_vs else None,
        "parent_perlin_frame_ms": b1p_vs["parent_ms"] if b1p_vs else None,
    }]

    print(f"phases 1-5 took {time.perf_counter() - t_start:.1f} s")
    tri_step2 = {}
    for name, phases in (
            ("6-7", lambda: train_phases(mrt, bounce, bounce_ad, dev, card_line)),
            ("8-12", lambda: hybrid_phases(mrt, bounce, flash, hybrid, dev, card_line, refs)),
            ("13-17", lambda: queue_phases(mrt, bounce, flash, hybrid, dev, card_line, refs,
                                           kernel_rows[-1])),
            ("18-22", lambda: eager_phases(mrt, flash, hybrid, noise, dev, card_line, refs,
                                           kernel_rows)),
            ("23-26", lambda: triangle_phases(mrt, bounce, flash, hybrid, dev, card_line,
                                              keep=tri_step2)),
            ("27", lambda: reference_gate(mrt, dev, refs)),
            ("28-30", lambda: ext_train_phases(mrt, bounce, bounce_ad, flash, hybrid, dev,
                                               card_line))):
        t0 = time.perf_counter()
        kernel_rows += phases()
        print(f"phase{'s' if '-' in name else ''} {name} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    scan_launches = scan_phases(mrt, flash, dev, card_line, refs)
    print(f"phases 31-33 took {time.perf_counter() - t0:.1f} s")
    # the scan path's launches beside each sweep's row: one phase-32 step
    # (500x500) and one phase-31 loss and gradient (64x64)
    for row in kernel_rows:
        if row["name"] in {name for _, name in SCAN_COUNTERS.values()}:
            row.update({"scan_step_launches": 0, "scan_launches_small": 0,
                        **scan_launches.get(row["name"], {})})
    t0 = time.perf_counter()
    cli_launches = cli_phases(mrt, bounce, flash, hybrid, noise, card_line)
    bvh_walk = bvh_phase(bounce, flash, card_line, tri_step2)
    print(f"phases 34-35 took {time.perf_counter() - t0:.1f} s")
    # the command line's launches beside each kernel's row (all its runs of
    # phase 34), and the BVH walk beside B10's
    for row in kernel_rows:
        if row["name"] in KERNEL_COUNTERS:
            row["cli_launches"] = cli_launches[row["name"]]
        if row["name"] == "flash_tri_hit_resident":
            row["bvh_walk"] = bvh_walk
    t0 = time.perf_counter()
    mesh_launches = mesh_phases(mrt, card_line)
    print(f"phases 36-37 took {time.perf_counter() - t0:.1f} s")
    # the mesh runs' launches (phase 36 and every rank of phase 37) beside
    # each kernel's row
    for row in kernel_rows:
        row["mesh_launches"] = mesh_launches.get(row["name"], 0)
    print(f"all phases took {time.perf_counter() - t_start:.1f} s")

    print(card_line)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def scan_with_grads(mrt, bounce, bounce_ad, scene, w, h, spp, bounces, plain, use_ext=False):
    """One scan of the whole image from the scene's TrainParams, through the
    kernels (the public entry point) or through their plain versions (the
    same scan put together from `scan_forward` and `scan_backward`); with
    `use_ext` the hybrid-ext scan, whose plain version also sweeps and
    replays its candidate with the plain sweeps (`ExtCandidate(plain=True)`).
    Returns (sums, nvalid, rays, grads): grads(target, mask) gives the SSE
    loss over the pixels of `mask` and its gradient for every TrainParams
    leaf."""
    from miniraytracer_tpu_torch.ops import hybrid

    leaves = mrt.TrainParams(*(p.detach().clone().requires_grad_(True)
                               for p in mrt.extract_params(scene)))
    sc = mrt.apply_params(scene, leaves)
    pix = torch.arange(w * h, dtype=torch.int32, device=scene.device)
    if plain:
        cand = images = None
        if use_ext:
            meta, tables = hybrid.pack_scene_hybrid(sc)
            cand = bounce_ad.ExtCandidate(sc, plain=True)
            images = sc.images if meta["image"] else None
        else:
            meta, tables = bounce.pack_scene(sc)
        _, claim, k_sub, outer = bounce_ad.scan_plan(spp, bounces, 0, 1 if use_ext else 0)
        cfg = bounce_ad.StepConfig(w, h, 8, bounces, spp, claim, k_sub)
        sb = torch.zeros_like(pix)
        consts = [t.detach() for t in tables]
        state = bounce_ad.initial_state(sc, pix, sb, spp, width=w, height=h, sq_off=8)
        (f, _, _), residual = bounce_ad.scan_forward(
            meta, cfg, outer, consts, *state, pix, sb, plain=True, candidate=cand,
            images=images)
        f.requires_grad_(True)
        summ, nv = f[bounce_ad.A_SUM:bounce_ad.A_SUM + 3].t(), f[bounce_ad.A_NV].detach()
        rays = int(f[bounce_ad.A_RAYS].detach().to(torch.int64).sum())
    else:
        summ, nv, rays = bounce_ad.sample_pixel_sums_fused(
            sc, pix, 0, spp, width=w, height=h, max_bounces=bounces, use_ext=use_ext)
        rays = int(rays)

    def grads(target, mask):
        err = torch.where((mask & (nv > 0))[:, None],
                          summ / nv.clamp_min(1)[:, None] - target, 0.0)
        loss = (err * err).sum() / (w * h * 3.0)
        if plain:
            cot, = torch.autograd.grad(loss, f)
            if cand is not None:
                cand.start_pullback()
            d_tables = bounce_ad.scan_backward(meta, cfg, outer, consts, residual,
                                               pix, sb, cot, plain=True, candidate=cand,
                                               images=images)
            outs, gs = list(tables), list(d_tables)
            if cand is not None:  # the candidate's inputs: coefficients, scene leaves
                outs, gs = outs + cand.inputs(), gs + cand.grads
            pairs = [(t, g) for t, g in zip(outs, gs) if g is not None and t.requires_grad]
            out = torch.autograd.grad([t for t, _ in pairs], list(leaves),
                                      grad_outputs=[g for _, g in pairs], allow_unused=True)
        else:
            out = torch.autograd.grad(loss, list(leaves), allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, out)]

    return summ.detach(), nv, rays, grads


def compare_scans(mrt, bounce, bounce_ad, scene, w, h, spp, bounces, where, use_ext=False):
    """The whole scan through the kernels against the plain versions (with
    `use_ext` the hybrid-ext scan: B2/B3 in their ext modes and the sweeps
    of flash.cu): ray counts within 0.1%, `nvalid` equal on 99.9% of pixels,
    sums within 1e-5*(1+|sum|) on 99%; then the SSE loss against a flat
    grey target over the pixels that agree (a pixel is one lane with its own
    scan, so the others get no cotangent) and every TrainParams gradient
    within rtol 5e-3, atol 5e-4 of the leaf's largest entry, all finite.
    Returns the leaves whose plain gradient is not zero."""
    sk, nvk, rk, grads_k = scan_with_grads(mrt, bounce, bounce_ad, scene, w, h, spp, bounces,
                                           False, use_ext)
    sp, nvp, rp, grads_p = scan_with_grads(mrt, bounce, bounce_ad, scene, w, h, spp, bounces,
                                           True, use_ext)
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
    return seen


def compare_launch(bounce_ad, args, res, gen, where, ext=None, images=None):
    """One launch of B2 and one of B3 against their plain versions, from the
    entry state `res` = (residual rows (14, N), istate, keys, pix, sb), and
    in an ext mode from the candidate rows `ext` (and the image atlas
    `images`), whose cotangent `d_ext` is held as `d_f` is.

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
    xa = () if ext is None else (ext, images)
    run = {
        "fwd_k": lambda: A.ad_step_fwd(*args, f_in, *lanes, *xa),
        "fwd_p": lambda: A.ad_step_fwd_plain(*args, f_in, *lanes, *xa),
    }
    (fk, ik, kk), (fp, ip, kp) = run["fwd_k"](), run["fwd_p"]()
    err = (fk - fp).abs()
    tol = 1e-5 * (1 + fp.abs())
    ro_scale = float(fp[A.A_RO:A.A_RD].abs().max().clamp_min(1.0))
    tol[A.A_RO:A.A_RD] = 1e-5 * ro_scale
    tol[A.A_ALIVE:] = 0.0  # alive, nvalid, rays: whole numbers
    agree = (ik == ip).all(0) & (kk == kp) & (err <= tol).all(0)
    cot = torch.randn((A.NF, n), device=res_f.device, generator=gen) * agree
    run["bwd_k"] = lambda: A.ad_step_bwd(*args, res_f, *lanes, cot, None, *xa)
    run["bwd_p"] = lambda: A.ad_step_bwd_plain(*args, res_f, *lanes, cot, *xa)
    out_k, out_p = run["bwd_k"](), run["bwd_p"]()
    (dk, tk), (dp, tp) = out_k[:2], out_p[:2]
    if ext is not None:  # d_ext rows beside d_f's
        dk, dp = torch.cat([dk, out_k[2]]), torch.cat([dp, out_p[2]])
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
        "dtab_rel": (float(((tk - tp).abs() / tp.abs().max().clamp_min(1e-30)).max())
                     if tp.numel() else 0.0),
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
    check(tp.numel() == 0
          or ((tk - tp).abs() <= 2e-3 * tp.abs() + 2e-4 * tp.abs().max()).all().item(),
          f"{where}: B3 d_tab differs from plain (rtol 2e-3), max {out['dtab_rel']:.3g} of scale")
    return out


def per_call_scan_forward(bounce_ad, meta, cfg, outer, tables, f0, i0, k0, pix, sb, keep=True,
                          candidate=None, images=None):
    """The forward scan one call of `bounce_ad.ad_step_fwd` a launch (the
    kernel, for CUDA tensors), each launch's entry state (and candidate rows,
    with `candidate`) copied into the residual first: the reference that the
    planned scan (`bounce_ad.FwdPlan`) equals bit for bit. Returns ((f, i,
    k), residual or None), as `bounce_ad.scan_forward`."""
    n, dev = f0.shape[1], f0.device
    residual = None
    if keep:
        residual = (torch.empty((outer, bounce_ad.RES_HI - bounce_ad.RES_LO, n),
                                dtype=torch.float32, device=dev),
                    torch.empty((outer, bounce_ad.NJ, n), dtype=torch.int32, device=dev),
                    torch.empty((outer, n), dtype=torch.int32, device=dev))
        if candidate is not None:
            residual += (torch.empty((outer, bounce_ad.ext_rows(meta), n), dtype=torch.float32,
                                     device=dev),)
    f, i, k = f0, i0, k0
    for t in range(outer):
        ext = None if candidate is None else candidate.rows(f, i)
        if keep:
            residual[0][t].copy_(f[bounce_ad.RES_LO:bounce_ad.RES_HI])
            residual[1][t].copy_(i)
            residual[2][t].copy_(k)
            if ext is not None:
                residual[3][t].copy_(ext)
        f, i, k = bounce_ad.ad_step_fwd(meta, cfg, tables, t, f, i, k, pix, sb, ext, images)
    return (f, i, k), residual


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


def cornell_target(mrt, scene, w, bounces):
    """The train steps' target: the box with other wall albedos (red, white,
    green) rendered at w x w, 64 spp, as (w*w, 3) rows."""
    c0 = scene.tex_c0.clone()
    c0[0] = torch.tensor([0.45, 0.15, 0.10])
    c0[1] = torch.tensor([0.55, 0.55, 0.55])
    c0[2] = torch.tensor([0.20, 0.30, 0.25])
    target, _ = mrt.render(dataclasses.replace(scene, tex_c0=c0), w, w, 64, max_bounces=bounces)
    return target.reshape(-1, 3)


def train_phases(mrt, bounce, bounce_ad, dev, card_line):
    """Phases 6 and 7: the AD step kernels and the train step. Returns the
    two kernels' rows of the result line."""
    from miniraytracer_tpu_torch.utils import kernels

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
            same = parent_equal(kernels, "bounce_ad", c["run"]["fwd_k"], f"B2 {name} launch {t}",
                                say=False)
    print(f"  B2 at those launches of the five scenes: "
          f"{'equal to the parent build bit for bit' if same else 'the parent build absent'}")

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
    target = cornell_target(mrt, scene, w, bounces)
    step = mrt.make_train_step(width=w, height=h, max_bounces=bounces, spp_step=spp_step)
    params0 = params = mrt.extract_params(scene)
    torch.cuda.synchronize()
    bounce_ad.fwd_launches = bounce_ad.bwd_launches = bounce_ad.fwd_plan_launches = 0
    walked0, offered0 = bounce_ad.bwd_lanes_walked(), bounce_ad.bwd_lanes_offered
    losses = []
    for i in range(n_steps):
        # lr: the loss is a mean over pixels and channels, so its curvature in
        # an albedo is about the mean squared irradiance (~0.1): 0.5 is a
        # small step, and the three of them move an albedo by about 0.02
        params, loss, grads = step(params, scene, target, i, lr)
        losses.append(float(loss))
        check(all(torch.isfinite(g).all().item() for g in grads), f"step {i}: grads not finite")
    fwd_launches, bwd_launches = bounce_ad.fwd_launches, bounce_ad.bwd_launches
    plan_launches = bounce_ad.fwd_plan_launches
    walked = bounce_ad.bwd_lanes_walked() - walked0
    offered = bounce_ad.bwd_lanes_offered - offered0
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
          f"backward {bwd_launches}; B3 walked {walked} of the {offered} lanes offered "
          f"({walked / max(offered, 1):.4f}: those alive at their launch's entry)")
    print(f"  wall albedos now {params.tex_c0[:3].tolist()}; last grads, max abs: "
          + ", ".join(f"{k} {float(g.abs().max()):.3g}" for k, g in grads._asdict().items()))
    check(all(np.isfinite(l) for l in losses + same_set + [held_first, held_last]),
          "loss not finite")
    check(held_last < held_first, "the loss on held-out samples did not fall over the steps")
    check(fwd_launches == n_steps * outer and bwd_launches == n_steps * outer,
          "the train step did not launch each kernel once per scan step")
    check(plan_launches == fwd_launches, "a train step's B2 launch went around its scan's plan")
    check(offered == n_steps * outer * w * h and 0 < walked < offered,
          "B3 did not walk the live lanes of each launch it was offered")
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
    print("  B3 (ad_step_bwd_kernel<KS, EXT, EXT_MAT, IMAGE>: KS the records a lane keeps, "
          "<4, false, false, false> the train step's, KS 8 any other count, KS 1 the ext "
          "modes), ptxas -v:")
    for line in ptxas_lines(kernels.build_log("bounce_ad"), "ad_step_bwd_kernel"):
        print("   ", line)

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

    # the redesign against the parent's builds: B2 bit for bit at launch t_mid
    # and over the whole scan, B3's d_f bit for bit and d_tab within its float
    # atomics' spread; each timed in turns
    t_mid = outer // 4
    print("  B2 (ad_step_fwd_kernel<EXT, EXT_MAT, IMAGE, STAGED>), ptxas -v:")
    for line in ptxas_lines(kernels.build_log("bounce_ad"), "ad_step_fwd_kernel"):
        print("   ", line)
    print_grid(kernels, "mrt_ad_step_fwd_grid", bounce_ad, meta, cfg, w * h, t_mid, "B2")
    print_grid(kernels, "mrt_ad_step_bwd_grid", bounce_ad, meta, cfg, w * h, t_mid, "B3")
    zeros = torch.zeros((3, w * h), device=dev)
    f_mid = torch.cat([zeros, res_f[t_mid], zeros[:2]])
    fwd_one = lambda: bounce_ad.ad_step_fwd(meta, cfg, tables, t_mid, f_mid, res_i[t_mid],
                                            res_k[t_mid], pix, sb)
    parent_equal(kernels, "bounce_ad", fwd_one, f"B2 at launch {t_mid}, every row")
    planned = bounce_ad.scan_forward(meta, cfg, outer, tables, *state, pix, sb)
    check(equal_outputs(planned, per_call_scan_forward(bounce_ad, meta, cfg, outer, tables,
                                                       *state, pix, sb)),
          "B2's planned scan differs from its launches one call at a time")
    print(f"    B2's planned scan ({outer} launches, one `FwdPlan`): the last state and every "
          "launch's residual equal to a call of `ad_step_fwd` a launch and its copies, bit "
          "for bit")
    del planned
    parent_equal(kernels, "bounce_ad", lambda: bounce_ad.scan_forward(
        meta, cfg, outer, tables, *state, pix, sb, keep=True),
        "B2 over the whole scan, every launch's state and the last")
    torch.cuda.empty_cache()
    gen_b3 = torch.Generator(device=dev).manual_seed(3)
    cot_mid = torch.randn((bounce_ad.NF, w * h), device=dev, generator=gen_b3)
    bwd_one = lambda: bounce_ad.ad_step_bwd(meta, cfg, tables, t_mid, res_f[t_mid], res_i[t_mid],
                                            res_k[t_mid], pix, sb, cot_mid, None)
    b3_parent_equal(kernels, bwd_one, f"B3 at launch {t_mid}")
    b2_vs = [print_against_parent(what, res, card_line) for what, res in (
        (f"B2 at launch {t_mid}", against_parent(kernels, "bounce_ad", fwd_one, 10, rounds=2)),
        (f"B2 over the scan, a launch", per_launch(
            against_parent(kernels, "bounce_ad", fwd_scan, 1, rounds=2), outer)),
        (f"B3 at launch {t_mid}", against_parent(kernels, "bounce_ad", bwd_one, 5, rounds=2)),
        (f"B3 over the scan, a launch", per_launch(
            against_parent(kernels, "bounce_ad", bwd_scan, 1, rounds=2), outer)))]

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
         "scan_bound_ms_per_launch": b2_mean, "vs_parent": b2_vs[:2], **common},
        {"name": "ad_step_bwd", "replaces": "miniraytracer_tpu/ops/bounce_ad.py:276",
         "launches": bwd_launches, "max_abs_err": max(worst["df_err"], c["df_err"]),
         "err_scale": c["df_scale"], "max_rel_lane_err": max(worst["df_rel"], c["df_rel"]),
         "lanes_agreeing": c["df_close"],
         "ms": statistics.mean(ms["bwd_k"]), "plain_ms": statistics.mean(ms["bwd_p"]),
         "bound_ms": b3_bound, "bound_by": b3_by, "scan_ms_per_launch": b3_scan,
         "scan_bound_ms_per_launch": b3_mean, "vs_parent": b2_vs[2:], **common},
    ]


# ---------------------------------------------------------------------------
# The hybrid forward render: kernels B7, B8 (flash.cu) and B4 (hybrid.cu)
# ---------------------------------------------------------------------------

# fp32 instructions per (ray, primitive) pair of the dense sweeps, counted from
# csrc/flash.cu (a multiply and an add are two: --fmad=false). Sphere: two
# 17-term sums (2 x (17 + 16)), disc 2, the root 1, the two roots 3, the
# tests and the running minimum ~8. Triangle: four 16-term sums (4 x (16 +
# 15)), the sign and three products 4, the division 1, one sum 1, the tests
# and the minimum ~8.
FP32_OPS_PER_SPHERE_PAIR = 80
FP32_OPS_PER_TRI_PAIR = 138


def step_ops_per_ray(meta):
    """fp32 operations of one hybrid step on a live lane, counted as
    FP32_OPS_PER_RAY_FWD was: the sweep over what stays in the tables (27 a
    sphere, 37 a rect, 55 a triangle, 55 a box, 90 a volume; inactive pad
    rows are swept too), hit point 6, shading ~210, the step's algebra and
    the share of a camera ray ~40, the image uv and texel ~60."""
    sweep = (27 * meta["S"] + 37 * meta["R"] + 55 * meta["Tc"] + 55 * meta["Bx"]
             + 90 * meta["V"])
    return sweep + 6 + 210 + 40 + (60 if meta["image"] else 0)


def hybrid_snapshots(bounce, hybrid, scene, w, h, sq, bounces, at, plain=False):
    """Lane states and candidate rows of real wave steps: runs the hybrid
    loop of the whole image (`sq`^2 samples a pixel) and returns (cfg, accel,
    pix, {step: (state, ext)}) for the steps in `at`."""
    meta, tables = hybrid.pack_scene_hybrid(scene)
    cfg = hybrid.StepConfig(meta=meta, tables=tuple(tables), images=scene.images, width=w,
                            height=h, sq=sq, max_bounces=bounces, max_lum=1000.0,
                            sample_lo=0, n_samples=sq * sq)
    accel = hybrid.hybrid_accel(scene)
    pix = torch.arange(w * h, dtype=torch.int32, device=scene.device)
    state = hybrid.initial_state(scene, pix, 0, sq * sq, width=w, height=h, spp_sq=sq)
    step = hybrid.hybrid_step_plain if plain else hybrid.hybrid_step
    snaps = {}
    for t in range(max(at) + 1):
        alive = state[0][hybrid.R_ALIVE] > 0
        ext = torch.stack(hybrid._external_candidate(
            scene, accel, hybrid.state_rays(state[0], state[1]), alive, bounce.TMIN,
            plain=plain))
        if t in at:
            snaps[t] = (state, ext)
        state = step(cfg, *state, pix, ext)
    return cfg, accel, pix, snaps


def in_turns(run_k, run_p, kernel_reps=5):
    """Kernel and plain version timed in turns (plain, kernel, kernel, plain);
    a kernel launch is short, so `kernel_reps` of them are timed at once.
    Returns (kernel ms list, plain ms list)."""
    ms = {"k": [], "p": []}
    for key in ("p", "k", "k", "p"):
        fn, reps = (run_k, kernel_reps) if key == "k" else (run_p, 1)
        ms[key].append(cuda_ms(lambda: [fn() for _ in range(reps)], 1)[0] / reps)
    return ms["k"], ms["p"]


def compare_sweep(where, kernel_out, plain_out, alive):
    """A dense sweep's kernel against its plain version on the same rays: the
    index equal on at least 99.99% of the rays and t equal to 1e-6 relative
    there; on the rest both must be near-ties (|dt| <= 1e-5 relative, or a hit
    against a miss at the tmin edge is not allowed at all); dead lanes miss.
    Returns the largest |dt| over the rays with equal index."""
    (tk, ik), (tp, ip) = kernel_out, plain_out
    same = ik == ip
    rel = (tk - tp).abs() / tp.abs().clamp_min(1e-30)
    hits = int((tp < 3e38).sum())
    share = float(same.float().mean())
    worst_same = float(rel[same].max())
    worst_other = float(rel[~same].max()) if (~same).any() else 0.0
    print(f"  {where}: {tk.numel()} rays ({int(alive.sum())} alive), {hits} hits; index equal on "
          f"{share:.6f}; max rel |dt| there {worst_same:.3g}, elsewhere {worst_other:.3g}")
    check(share >= 0.9999, f"{where}: index differs on more than 0.01% of rays")
    check(worst_same <= 1e-6, f"{where}: t differs by more than 1e-6 relative")
    check(worst_other <= 1e-5, f"{where}: a differing winner is no near-tie")
    check(hits > 0 and not bool((tk[~alive] < 3e38).any()) and not bool(ik[~alive].any()),
          f"{where}: no hits, or a dead lane hit something")
    return float((tk - tp).abs()[same & (tp < 3e38)].max())


def compare_step(where, hybrid, kernel_out, plain_out):
    """One launch of B4 against the plain step on the same state. The two
    round sin, cos, log and exp differently, so a lane in a few thousand takes
    another discrete decision and its floats then differ wholly: a lane agrees
    when its integer rows, key, ray count and alive row are equal, its origin
    is within 1e-5 of the largest coordinate in the state and every other
    float within 1e-5*(1+|plain|). At least 99.9% of lanes must agree.
    Returns (share agreeing, max abs err off the origin rows on them)."""
    (fk, ik, kk, rk), (fp, ip, kp, rp) = kernel_out, plain_out
    err = (fk - fp).abs()
    tol = 1e-5 * (1 + fp.abs())
    ro = slice(hybrid.R_RO, hybrid.R_RD)
    ro_scale = float(fp[ro].abs().max().clamp_min(1.0))
    tol[ro] = 1e-5 * ro_scale
    tol[hybrid.R_ALIVE] = 0.0
    agree = (ik == ip).all(0) & (kk == kp) & (rk == rp) & (err <= tol).all(0)
    other = torch.ones_like(err, dtype=torch.bool)
    other[ro] = False
    share = float(agree.float().mean())
    e_ro, e_other = float(err[ro][:, agree].max()), float((err * other)[:, agree].max())
    print(f"  {where}: {fk.shape[1]} lanes ({int((fp[hybrid.R_ALIVE] > 0).sum())} alive after), "
          f"lanes that agree {share:.5f}; on them max abs err: origin {e_ro:.3g} "
          f"(coordinates up to {ro_scale:.3g}), other rows {e_other:.3g}")
    check(torch.isfinite(fk[:, agree]).all().item(), f"{where}: state not finite")
    check(share >= 0.999, f"{where}: B4 agrees with plain on {share:.5f} of lanes")
    return share, e_other


def hybrid_phases(mrt, bounce, flash, hybrid, dev, card_line, refs):
    """Phases 8 to 12: the dense sweeps, the hybrid step and the hybrid
    render. Returns the three kernels' rows of the result line."""
    from miniraytracer_tpu_torch.utils import kernels

    w = h = 500
    n = w * h
    scenes = {"random_spheres": mrt.scenes.random_spheres(1.0).to(dev),
              "earth": mrt.scenes.earth(1.0).to(dev),
              "hybrid_probe": mrt.scenes.hybrid_probe(1.0, 80, 200).to(dev)}
    probe_1000 = mrt.scenes.hybrid_probe(1.0, 80, 1000).to(dev)

    # 8. B7/B8 vs plain on rays of real wave steps at 500x500 (4 spp, so that
    # a later step has dead lanes, which arrive as NaN rays)
    print("phase 8: dense sweeps vs plain PyTorch on rays of wave steps, 500x500")
    rs = scenes["random_spheres"]
    cfg_rs, accel_rs, pix, snaps_rs = hybrid_snapshots(bounce, hybrid, rs, w, h, 2, 32, (0, 2, 12))
    sweep_err = {"sph": 0.0, "tri": 0.0}
    sweeps = {}

    def nan_rays(state):
        """A state's rays as the sweeps get them: dead lanes NaN."""
        rays = hybrid.state_rays(state[0], state[1])
        alive = state[0][hybrid.R_ALIVE] > 0
        nan = float("nan")
        ro = type(rays.ro)(*(torch.where(alive, c, nan) for c in rays.ro))
        rd = type(rays.rd)(*(torch.where(alive, c, nan) for c in rays.rd))
        return rays, alive, ro, rd

    for t, (state, _) in snaps_rs.items():
        rays, alive, ro, rd = nan_rays(state)
        args = (accel_rs["sph"], ro, rd, rays.time, rays.inside, bounce.TMIN)
        check(t < 12 or (bool((~alive).any()) and bool((rays.inside[alive] > 0).any())),
              "step 12 has no dead lane or no lane inside glass")
        sweep_err["sph"] = max(sweep_err["sph"], compare_sweep(
            f"B8 random_spheres step {t}, {rs.n_spheres} spheres",
            flash.flash_sphere_hit(*args), flash.flash_sphere_hit_plain(*args), alive))
        if t == 2:  # every lane alive, as in most steps of a 64-spp frame
            sweeps["sph"] = (args, alive)
    for label, scene in (("200", scenes["hybrid_probe"]), ("1000", probe_1000)):
        _, accel, _, snaps = hybrid_snapshots(bounce, hybrid, scene, w, h, 2, 32, (2, 6))
        for t, (state, _) in snaps.items():
            rays, alive, ro, rd = nan_rays(state)
            args = (accel["tri"], ro, rd, rays.inside, bounce.TMIN)
            sweep_err["tri"] = max(sweep_err["tri"], compare_sweep(
                f"B7 hybrid_probe step {t}, {scene.n_tris} triangles",
                flash.flash_tri_hit(*args), flash.flash_tri_hit_plain(*args), alive))
            if t == 2:
                sweeps["tri"] = (args, alive, scene.n_tris)
    args, alive = sweeps["sph"]
    b8_k, b8_p = in_turns(lambda: flash.flash_sphere_hit(*args),
                          lambda: flash.flash_sphere_hit_plain(*args))
    n_live = int(alive.sum())
    table_words = sum(t.numel() for t in args[0])
    b8_bound, b8_by = bound(4 * (n * 10 + table_words),
                            n_live * rs.n_spheres * FP32_OPS_PER_SPHERE_PAIR)
    args, alive, n_tris = sweeps["tri"]
    b7_k, b7_p = in_turns(lambda: flash.flash_tri_hit(*args),
                          lambda: flash.flash_tri_hit_plain(*args))
    b7_bound, b7_by = bound(4 * (n * 9 + sum(t.numel() for t in args[0])),
                            int(alive.sum()) * n_tris * FP32_OPS_PER_TRI_PAIR)
    print(f"  B8 at {n} rays ({n_live} alive) x {rs.n_spheres} spheres: kernel {b8_k} ms, plain "
          f"{b8_p} ms, bound {b8_bound:.4f} ms by {b8_by}; B7 at {n} rays "
          f"({int(alive.sum())} alive) x {n_tris} triangles: kernel {b7_k} ms, plain {b7_p} ms, "
          f"bound {b7_bound:.4f} ms by {b7_by}; on {card_line}")

    # 9. B4 vs plain, one step, 250,000 lanes, in its three modes
    print("phase 9: hybrid step kernel vs plain PyTorch, one step, 250,000 lanes")
    step_err, step_share, b4 = 0.0, 1.0, None
    for name, scene in scenes.items():
        if name == "random_spheres":
            cfg, snaps = cfg_rs, snaps_rs
        else:
            cfg, _, _, snaps = hybrid_snapshots(bounce, hybrid, scene, w, h, 2, 32, (0, 2, 12))
        mode = ("11 candidate rows" if cfg.meta.get("ext_mat") else
                "image texels" if cfg.meta["image"] else "5 candidate rows")
        for t, (state, ext) in snaps.items():
            share, err = compare_step(
                f"B4 {name} ({mode}) step {t}", hybrid,
                hybrid.hybrid_step(cfg, *state, pix, ext),
                hybrid.hybrid_step_plain(cfg, *state, pix, ext))
            step_err, step_share = max(step_err, err), min(step_share, share)
        if name == "random_spheres":
            b4 = (cfg, *snaps[2])
    cfg, state, ext = b4
    b4_k, b4_p = in_turns(lambda: hybrid.hybrid_step(cfg, *state, pix, ext),
                          lambda: hybrid.hybrid_step_plain(cfg, *state, pix, ext))
    live = int((state[0][hybrid.R_ALIVE] > 0).sum())
    # words a lane: in 17 + 3 + key + rays + pix + 11 candidate rows, out 22
    b4_bound, b4_by = bound(
        4 * (n * (23 + hybrid.NE_MAT + 22) + sum(t.numel() for t in cfg.tables)),
        live * step_ops_per_ray(cfg.meta))
    print(f"  B4 random_spheres step 2 ({live} lanes alive): kernel {b4_k} ms, plain {b4_p} ms, "
          f"bound {b4_bound:.4f} ms by {b4_by} on {card_line}")
    b4_one = lambda: hybrid.hybrid_step(cfg, *state, pix, ext)
    parent_equal(kernels, "hybrid", b4_one, "B4 random_spheres step 2, every row")
    b4_vs = print_against_parent(
        "B4 random_spheres step 2, device ms a launch (queued, 20 a turn)",
        against_parent(kernels, "hybrid", b4_one, 20, rounds=2, queued=True), card_line)
    del snaps_rs, snaps, sweeps, b4, state, ext, args
    torch.cuda.empty_cache()

    # 10. whole hybrid renders, kernels vs plain versions, 64x64x4x8
    print("phase 10: hybrid render, kernels vs plain PyTorch, 64x64, 4 spp, 8 bounces")
    pix64 = torch.arange(64 * 64, dtype=torch.int32, device=dev)
    kw = dict(width=64, height=64, max_bounces=8, spp_sq=2)
    for name, scene in scenes.items():
        k = hybrid.render_wavefront_hybrid_pixels(scene, pix64, 0, 4, 1000.0, **kw)
        p = hybrid.render_wavefront_hybrid_pixels(scene, pix64, 0, 4, 1000.0, plain=True, **kw)
        compare(name, k, p)

    # 11. against the reference renderer's frames (channel means)
    # The reference rendered earth from its earth map. Without that file (the
    # directory MRT_ASSETS names) the scene takes a procedural map of other
    # colours, as in the JAX package, and the frame cannot meet the reference
    # at test_reference_parity's 0.015: the difference is then printed and
    # held to 0.25, and earth's frame rests on phase 10 and on the CPU tests.
    print("phase 11: hybrid render vs reference renderer, 100x100, 16 spp, 16 bounces")
    assets = os.environ.get("MRT_ASSETS")
    real_map = bool(assets) and os.path.exists(os.path.join(assets, "earthmap.jpg"))
    print(f"  earth map: {'the file' if real_map else 'procedural (no earthmap.jpg)'}")
    for name, tol in (("random_spheres", 0.02), ("earth", 0.015 if real_map else 0.25)):
        frame, _ = hybrid.render_wavefront_hybrid(scenes[name], 100, 100, 16, max_bounces=16)
        ours = frame.cpu().numpy()
        check(np.isfinite(ours).all(), f"{name}: frame not finite")
        ref_mean = refs[name].mean(axis=(0, 1))
        rel = np.abs(ref_mean - ours.mean(axis=(0, 1))) / np.maximum(ref_mean, 1e-6)
        print(f"  {name}: channel means rel diff {rel.max():.4f} (tolerance {tol})")
        check(rel.max() < tol, f"{name}: reference parity")

    # 12. the main path: render() of random_spheres at 500x500x64x32, and of
    # the 1000-triangle scene for the triangle sweep
    print("phase 12: mrt.render(random_spheres, 500, 500, 64, max_bounces=32)")
    scene = mrt.scenes.random_spheres(1.0)
    torch.cuda.synchronize()
    hybrid.step_launches = flash.sphere_launches = flash.tri_launches = 0
    frame, stats = mrt.render(scene, w, h, 64, max_bounces=32)
    b4_launches, b8_launches = hybrid.step_launches, flash.sphere_launches
    check(stats["renderer"] == "hybrid", f"renderer {stats['renderer']}")
    check(b4_launches > 0 and b8_launches > 0 and flash.tri_launches == 0,
          "the render did not launch the step and sphere-sweep kernels")
    check(b4_launches == b8_launches == stats["steps"], "launches and wave steps differ")
    check(frame.shape == (h, w, 3) and frame.is_cuda, "frame shape/device")
    check(torch.isfinite(frame).all().item(), "frame not finite")
    print(f"  renderer {stats['renderer']}, {stats['steps']} wave steps, launches B4 "
          f"{b4_launches} B8 {b8_launches}, rays {stats['rays']}, frame mean "
          f"{frame.mean(dim=(0, 1)).tolist()}")
    scene_d = scene.to(dev)
    one_frame = lambda: mrt.render(scene_d, w, h, 64, max_bounces=32)
    ms = cuda_ms(one_frame, 2)
    med = statistics.median(ms)
    print(f"  forward {stats['rays'] / (med / 1e3) / 1e6:.1f} Mrays/s (median of 2 warm renders, "
          f"{med:.1f} ms each, {med / stats['steps']:.3f} ms a wave step; runs {ms}) on {card_line}")
    wall, busy, by_name = device_share(one_frame)
    named = {"flash_sphere_kernel": 0.0, "hybrid_step_kernel": 0.0}
    for kname, (kms, _) in by_name.items():
        for key in named:
            if key in kname:
                named[key] += kms
    rest = busy - sum(named.values())
    n_rest = sum(c for kname, (_, c) in by_name.items() if not any(k in kname for k in named))
    print(f"  one frame under torch.profiler: wall {wall:.1f} ms, device busy {busy:.1f} ms (idle "
          f"share {max(0.0, 1 - busy / wall):.3f}; without the profiler the same device time is "
          f"{busy / med:.3f} of the median frame): B8 {named['flash_sphere_kernel']:.1f} ms, B4 "
          f"{named['hybrid_step_kernel']:.1f} ms, {n_rest} other launches (candidate assembly, "
          f"row stacking, the alive test) {rest:.1f} ms")
    for kname, (kms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
        print(f"    {kms:8.2f} ms  {100 * kms / busy:5.1f}%  x{count:<6d} {kname[:90]}")

    print("  mrt.render(hybrid_probe with 1000 triangles, 500, 500, 16, max_bounces=32)")
    hybrid.step_launches = flash.sphere_launches = flash.tri_launches = 0
    frame, stats_t = mrt.render(probe_1000, w, h, 16, max_bounces=32)
    b7_launches = flash.tri_launches
    check(stats_t["renderer"] == "hybrid" and b7_launches == stats_t["steps"] > 0,
          "the render did not launch the triangle-sweep kernel once a step")
    check(torch.isfinite(frame).all().item() and frame.is_cuda, "frame not finite")
    ms_t = cuda_ms(lambda: mrt.render(probe_1000, w, h, 16, max_bounces=32), 2)
    print(f"  renderer {stats_t['renderer']}, {stats_t['steps']} wave steps, launches B7 "
          f"{b7_launches}, rays {stats_t['rays']}; "
          f"{stats_t['rays'] / (statistics.median(ms_t) / 1e3) / 1e6:.1f} Mrays/s (median of 2, "
          f"runs {ms_t} ms) on {card_line}")

    common = {"route": "cuda", "library_ms": None}
    src = "miniraytracer_tpu_torch/csrc/"
    return [
        {"name": "flash_tri_hit", "source": src + "flash.cu",
         "replaces": "miniraytracer_tpu/ops/flash.py:295", "launches": b7_launches,
         "max_abs_err": sweep_err["tri"], "ms": statistics.mean(b7_k),
         "plain_ms": statistics.mean(b7_p), "bound_ms": b7_bound, "bound_by": b7_by, **common},
        {"name": "flash_sphere_hit", "source": src + "flash.cu",
         "replaces": "miniraytracer_tpu/ops/flash.py:257", "launches": b8_launches,
         "max_abs_err": sweep_err["sph"], "ms": statistics.mean(b8_k),
         "plain_ms": statistics.mean(b8_p), "bound_ms": b8_bound, "bound_by": b8_by, **common},
        {"name": "hybrid_step", "source": src + "hybrid.cu",
         "replaces": "miniraytracer_tpu/ops/hybrid.py:517", "launches": b4_launches,
         "max_abs_err": step_err, "lanes_agreeing": step_share, "ms": statistics.mean(b4_k),
         "plain_ms": statistics.mean(b4_p), "bound_ms": b4_bound, "bound_by": b4_by,
         "frame_ms": med, "frame_steps": stats["steps"], "vs_parent": b4_vs, **common},
    ]


# ---------------------------------------------------------------------------
# The work-queue forward render: kernels B13, B12 (flash.cu) and B5 (hybrid.cu)
# ---------------------------------------------------------------------------

# fp32 instructions of one (ray, cluster) slab test of the clustered sweeps,
# counted from csrc/flash.cu::slab_gate: per axis two subtractions, two
# products and five compare-and-selects (27), the final three comparisons and
# a select (4).
FP32_OPS_PER_SLAB_TEST = 31


def queue_snapshots(integrator, hybrid, scene, w, h, sq, bounces, lanes):
    """The inputs of every shade step of a whole work-queue render on the
    card: [(cfg, fstate, inside, keys_b, ext)], one entry a queue step."""
    calls = []
    real = hybrid.shade_step

    def record(*args):
        calls.append(args)
        return real(*args)

    hybrid.shade_step = record
    try:
        integrator.render_workqueue_pixels(scene, w * h, lanes, sq * sq, 1000.0, width=w,
                                           height=h, max_bounces=bounces, spp_sq=sq)
    finally:
        hybrid.shade_step = real
    return calls


def snapshot_rays(hybrid, fstate, inside):
    """A shade step's rays as the sweeps get them (dead lanes NaN):
    (ro, rd, time, inside, alive)."""
    from miniraytracer_tpu_torch.ops.vecmath import V3

    alive = fstate[hybrid.SH_ALIVE] > 0
    nan = float("nan")
    ro = V3(*(torch.where(alive, fstate[hybrid.SH_RO + k], nan) for k in range(3)))
    rd = V3(*(torch.where(alive, fstate[hybrid.SH_RD + k], nan) for k in range(3)))
    return ro, rd, fstate[hybrid.SH_TIME].contiguous(), inside, alive


def compare_clustered(where, flash, cull, coeffs, rays, alive, tmin):
    """B13 and B12 on the same rays against their plain versions (index and t
    EQUAL on every ray) and against the dense kernel B8 (equal except on rays
    that graze a cluster's box, where the per-ray gate may drop a hit: at most
    1 in 10,000, and there the clustered t is the larger); B12 again from a
    finite seed on every other ray. Dead lanes miss. Returns the measured
    (B13, B12) max abs difference of t from plain, inf where an index differs."""
    def t_err(t, i, t_ref, i_ref):
        d = torch.where(t == t_ref, torch.zeros_like(t), (t - t_ref).abs())
        d = torch.where((i == i_ref) & ~torch.isnan(d), d, float("inf"))
        return float(d.max())

    tg, ig = flash.flash_sphere_hit_gated(cull, *rays, tmin)
    ts, is_ = flash.flash_sphere_hit_streamed(cull, *rays, tmin)
    tp, ip = flash.flash_sphere_hit_gated_plain(cull, *rays, tmin)
    td, idd = flash.flash_sphere_hit(coeffs, *rays, tmin)
    err_gated, err_streamed = t_err(tg, ig, tp, ip), t_err(ts, is_, tp, ip)
    check(torch.equal(tg, tp) and torch.equal(ig, ip), f"{where}: B13 differs from plain")
    check(torch.equal(ts, tp) and torch.equal(is_, ip), f"{where}: B12 differs from plain")
    hit = tp < 3e38
    off = tp != td
    check(float(off.float().mean()) <= 1e-4 and bool((tp[off] > td[off]).all()),
          f"{where}: the clustered sweeps differ from the dense sweep on "
          f"{int(off.sum())} rays")
    check(torch.equal(ip[hit & ~off], idd[hit & ~off]), f"{where}: winners differ from dense")
    check(int(hit.sum()) > 0 and not bool(hit[~alive].any()) and not bool(ip[~alive].any()),
          f"{where}: no hits, or a dead lane hit something")
    lane = torch.arange(tp.numel(), device=tp.device)
    seed = torch.where((lane % 2 == 0) & hit, 0.8 * td, 3.0e38)
    t2, i2 = flash.flash_sphere_hit_streamed(cull, *rays, tmin, seed)
    t2p, i2p = flash.flash_sphere_hit_streamed_plain(cull, *rays, tmin, seed)
    err_streamed = max(err_streamed, t_err(t2, i2, t2p, i2p))
    check(torch.equal(t2, t2p) and torch.equal(i2, i2p), f"{where}: seeded B12 differs from plain")
    seeded = seed < 3e38
    check(torch.equal(t2[seeded], seed[seeded]) and not bool(i2[seeded].any())
          and torch.equal(t2[~seeded], tp[~seeded]), f"{where}: B12 does not keep its seed")
    print(f"  {where}: {tp.numel()} rays ({int(alive.sum())} alive, "
          f"{int((rays[3][alive] > 0).sum())} inside a medium), {int(hit.sum())} hits; B13 and "
          f"B12 equal plain on every ray; {int(off.sum())} rays differ from the dense sweep; "
          f"seeded B12 equal plain; max abs err of t: B13 {err_gated:.3g}, B12 {err_streamed:.3g}")
    return err_gated, err_streamed


def compare_shade(where, hybrid, kernel_out, plain_out):
    """One launch of B5 against the plain shade step on the same lanes, at
    `compare_step`'s tolerances: a lane agrees when `cont` and `new_inside`
    are equal, its hit point is within 1e-5 of the largest coordinate in the
    state and every other float within 1e-5*(1+|plain|). At least 99.9% of
    lanes must agree. Returns (share agreeing, max abs err off the hit-point
    rows on them)."""
    (fk, ik), (fp, ip) = kernel_out, plain_out
    err = (fk - fp).abs()
    tol = 1e-5 * (1 + fp.abs())
    pt = slice(hybrid.SO_P, hybrid.SO_RD)
    p_scale = float(fp[pt].abs().max().clamp_min(1.0))
    tol[pt] = 1e-5 * p_scale
    tol[hybrid.SO_CONT] = 0.0
    agree = (ik == ip) & (err <= tol).all(0)
    other = torch.ones_like(err, dtype=torch.bool)
    other[pt] = False
    share = float(agree.float().mean())
    e_p, e_other = float(err[pt][:, agree].max()), float((err * other)[:, agree].max())
    print(f"  {where}: {fk.shape[1]} lanes ({int((fp[hybrid.SO_CONT] > 0).sum())} go on), lanes "
          f"that agree {share:.5f}; on them max abs err: hit point {e_p:.3g} (coordinates up "
          f"to {p_scale:.3g}), other rows {e_other:.3g}")
    check(torch.isfinite(fk[:, agree]).all().item(), f"{where}: output not finite")
    check(share >= 0.999, f"{where}: B5 agrees with plain on {share:.5f} of lanes")
    return share, e_other


def compare_queue(name, integrator, scene, w, h, sq, bounces, lanes):
    """A whole work-queue render through the kernels against the plain
    versions: steps, claims and sample counts equal, ray counts within 0.1%,
    99% of pixels within 1e-4, channel means within 1e-3 (the merge adds with
    float atomics, so a frame repeats to rounding only). Returns the steps."""
    kw = dict(width=w, height=h, max_bounces=bounces, spp_sq=sq)
    sk, sp = {}, {}
    ak, ck, rk = integrator.render_workqueue_pixels(scene, w * h, lanes, sq * sq, 1000.0,
                                                    stats=sk, **kw)
    ap, cp, rp = integrator.render_workqueue_pixels(scene, w * h, lanes, sq * sq, 1000.0,
                                                    stats=sp, plain=True, **kw)
    check(sk["claimed"] == sp["claimed"] and torch.equal(ck, cp),
          f"{name}: claims or sample counts differ ({sk} vs {sp})")
    check(int(ck.sum()) == w * h * sq * sq, f"{name}: samples were lost")
    compare(f"{name} ({sk['steps']} steps, plain {sp['steps']}; {sk['claimed']} claims)",
            (ak, ck, rk.reshape(1)), (ap, cp, rp.reshape(1)))
    return sk["steps"]


def queue_phases(mrt, bounce, flash, hybrid, dev, card_line, refs, hybrid_row):
    """Phases 13 to 17: the clustered sphere sweeps, the shade step and the
    work-queue render. Returns the three kernels' rows of the result line."""
    from miniraytracer_tpu_torch.models import integrator
    from miniraytracer_tpu_torch.utils import kernels

    w = h = 500
    n_pix = w * h
    scenes = {"earth": mrt.scenes.earth(1.0).to(dev),
              "book2_final": mrt.scenes.book2_final(1.0).to(dev),
              "hybrid_probe": mrt.scenes.hybrid_probe(1.0, 80, 200).to(dev),
              "random_spheres": mrt.scenes.random_spheres(1.0).to(dev)}
    probe_5000 = mrt.scenes.hybrid_probe(1.0, 5000, 0).to(dev)
    snaps = {name: queue_snapshots(integrator, hybrid, scene, w, h, 2, 32,
                                   integrator.wq_auto_lanes(scene, n_pix))
             for name, scene in list(scenes.items()) + [("probe_5000", probe_5000)]}
    late = lambda calls: len(calls) - 4  # most items claimed: dead lanes

    # 13. B13/B12 vs plain and vs the dense B8 on rays of real queue steps
    print("phase 13: clustered sphere sweeps vs plain PyTorch and vs the dense sweep, on rays of "
          "queue steps at 500x500")
    timed = {}
    clustered_err = {}  # scene -> measured (B13, B12) max abs err over its steps
    for name, scene in (("book2_final", scenes["book2_final"]), ("probe_5000", probe_5000)):
        coeffs = flash.sphere_coefficients(scene)
        cull = flash.sph_cull_build(scene, coeffs)
        calls = snaps[name]
        seen_inside = 0
        for t in (0, 2, late(calls)):
            _, fstate, inside, _, _ = calls[t]
            *rays, alive = snapshot_rays(hybrid, fstate, inside)
            check(t < 3 or bool((~alive).any()), f"{name} step {t} has no dead lane")
            seen_inside += int((inside[alive] > 0).sum())
            errs = compare_clustered(f"{name} step {t} of {len(calls)}, {scene.n_spheres} "
                                     f"spheres in {cull[1].shape[1]} clusters", flash, cull,
                                     coeffs, rays, alive, bounce.TMIN)
            clustered_err[name] = tuple(map(max, clustered_err.get(name, (0.0, 0.0)), errs))
            if t == 2:
                timed[name] = (scene, cull, coeffs, rays, alive)
        check(seen_inside > 0, f"{name}: no lane inside glass in these steps")
    sweep_rows = {}
    for name, kernel, plain in (("book2_final", flash.flash_sphere_hit_gated,
                                 flash.flash_sphere_hit_gated_plain),
                                ("probe_5000", flash.flash_sphere_hit_streamed,
                                 flash.flash_sphere_hit_streamed_plain)):
        scene, cull, coeffs, rays, alive = timed[name]
        k_ms, p_ms = in_turns(lambda: kernel(cull, *rays, bounce.TMIN),
                              lambda: plain(cull, *rays, bounce.TMIN))
        dense_ms = cuda_ms(lambda: [flash.flash_sphere_hit(coeffs, *rays, bounce.TMIN)
                                    for _ in range(5)], 1)[0] / 5
        work = {}
        plain(cull, *rays, bounce.TMIN, count=work)
        nc = cull[1].shape[1]
        block = cull[0][0].shape[0] // nc
        n, n_live = alive.numel(), int(alive.sum())
        ops = (work["clusters"] * block * FP32_OPS_PER_SPHERE_PAIR
               + n_live * nc * FP32_OPS_PER_SLAB_TEST)
        b_ms, b_by = bound(4 * (n * 10 + sum(t.numel() for t in (*cull[0], cull[1], cull[2]))), ops)
        print(f"  {kernel.__name__} at {n} rays ({n_live} alive) x {scene.n_spheres} spheres: a ray "
              f"sweeps {work['clusters'] / max(n_live, 1):.2f} of {nc} clusters; kernel {k_ms} ms, "
              f"plain {p_ms} ms, the dense kernel B8 on the same rays {dense_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}; on {card_line}")
        vs = print_against_parent(f"{kernel.__name__} (the cluster loop)", against_parent(
            kernels, "flash", lambda: kernel(cull, *rays, bounce.TMIN), 5), card_line)
        sweep_rows[name] = dict(ms=statistics.mean(k_ms), plain_ms=statistics.mean(p_ms),
                                bound_ms=b_ms, bound_by=b_by, dense_ms=dense_ms,
                                clusters_per_ray=work["clusters"] / max(n_live, 1),
                                parent_design=vs)
    del timed

    # 14. B5 vs plain, lane by lane, in its four modes
    print("phase 14: shade step kernel vs plain PyTorch on lanes of queue steps at 500x500")
    print_ptxas(kernels, "hybrid", "shade_step_kernel")
    shade_err, shade_share, b5 = 0.0, 1.0, {}
    for name in scenes:
        calls = snaps[name]
        cfg = calls[0][0]
        mode = ("11 candidate rows" if cfg.meta.get("ext_mat") else
                "image texels, outside spheres and boxes" if name == "book2_final" else
                "image texels, no outside set" if cfg.meta["image"] else "5 candidate rows")
        for t in (0, 2, late(calls)):
            args = calls[t]
            share, err = compare_shade(f"B5 {name} ({mode}) step {t}", hybrid,
                                       hybrid.shade_step(*args), hybrid.shade_step_plain(*args))
            shade_err, shade_share = max(shade_err, err), min(shade_share, share)
            if name in ("earth", "book2_final"):
                parent_equal(kernels, "hybrid", lambda: hybrid.shade_step(*args),
                             f"B5 {name} step {t}, every row", say=t == 2)
        if name in ("earth", "book2_final"):
            b5[name] = calls[2]
    grid = (ctypes.c_int * 5)()
    b5_rows = {}
    for name, args in b5.items():
        cfg, fstate, _, _, ext = args
        n, live = fstate.shape[1], int((fstate[hybrid.SH_ALIVE] > 0).sum())
        ip = bounce.kernel_params(cfg.meta, n, 0, 0, width=1, height=1, max_bounces=0, spp_sq=1)
        ip += [int(bool(cfg.meta.get("ext_mat"))), int(cfg.meta["image"]), *cfg.images.shape]
        kernels.load("hybrid").mrt_shade_step_grid((ctypes.c_int * len(ip))(*ip), grid)
        k_ms, p_ms = in_turns(lambda: hybrid.shade_step(*args),
                              lambda: hybrid.shade_step_plain(*args))
        # words a lane: in 15 + inside + key + candidate rows, out 13 + inside
        b_ms, b_by = bound(4 * (n * (17 + ext.shape[0] + 14) + sum(t.numel() for t in cfg.tables)),
                           live * step_ops_per_ray(cfg.meta))
        dev_ms = statistics.median(queued_ms(lambda: hybrid.shade_step(*args)))
        print(f"  B5 {name} step 2 ({n} lanes, {live} alive): grid {grid[2]} blocks of {grid[3]} "
              f"({grid[0]} an SM x {grid[1]} SMs); device {dev_ms:.4f} ms a launch (queued), "
              f"with the wrapper {k_ms} ms, plain {p_ms} ms, bound {b_ms:.4f} ms by {b_by} on "
              f"{card_line}")
        vs = print_against_parent(f"B5 {name} step 2, device ms a launch (queued, 20 a turn)",
                                  against_parent(kernels, "hybrid",
                                                 lambda: hybrid.shade_step(*args), 20, rounds=2,
                                                 queued=True), card_line)
        b5_rows[name] = dict(ms=dev_ms, wrapper_ms=statistics.mean(k_ms),
                             plain_ms=statistics.mean(p_ms), bound_ms=b_ms, bound_by=b_by,
                             vs_parent=vs)
    del snaps, b5
    torch.cuda.empty_cache()

    # 15. whole queue renders, kernels vs plain versions; book2 vs the reference
    print("phase 15: work-queue render, kernels vs plain PyTorch, 64x64, 4 spp, 8 bounces, "
          "1000 lanes")
    for name, scene in list(scenes.items()) + [("probe_5000", probe_5000)]:
        compare_queue(name, integrator, scene, 64, 64, 2, 8, 1000)
    # The reference rendered book2_final with the earth map on one sphere.
    # Without that file (the directory MRT_ASSETS names) the sphere takes the
    # procedural map, as in the JAX package; it covers about a hundredth of
    # the frame, so the channel means move by less than the 0.007 that
    # test_reference_parity holds at 64 spp plus 0.01: 0.017 is held then.
    assets = os.environ.get("MRT_ASSETS")
    real_map = bool(assets) and os.path.exists(os.path.join(assets, "earthmap.jpg"))
    tol = 0.007 if real_map else 0.017
    frame, _ = mrt.render_workqueue(scenes["book2_final"], 100, 100, 64, max_bounces=16)
    ours = frame.cpu().numpy()
    check(np.isfinite(ours).all(), "book2_final: frame not finite")
    ref_mean = refs["book2_final"].mean(axis=(0, 1))
    rel = np.abs(ref_mean - ours.mean(axis=(0, 1))) / np.maximum(ref_mean, 1e-6)
    print(f"  book2_final vs reference renderer, 100x100, 64 spp, 16 bounces (earth map: "
          f"{'the file' if real_map else 'procedural'}): channel means rel diff {rel.max():.4f} "
          f"(tolerance {tol})")
    check(rel.max() < tol, "book2_final: reference parity")

    # 16. the main path: render() of earth and of book2_final at 500x500x64x32,
    # and of the 5000-sphere scene for the streamed sweep
    def main_path(label, scene, spp, profile_spp):
        print(f"phase 16: mrt.render({label}, 500, 500, {spp}, max_bounces=32)")
        torch.cuda.synchronize()
        hybrid.shade_launches = flash.gated_launches = flash.streamed_launches = 0
        flash.sphere_launches = 0
        frame, stats = mrt.render(scene, w, h, spp, max_bounces=32)
        counts = dict(b5=hybrid.shade_launches, b13=flash.gated_launches,
                      b12=flash.streamed_launches, b8=flash.sphere_launches)
        check(stats["renderer"] == "workqueue", f"renderer {stats['renderer']}")
        check(counts["b5"] == stats["steps"] > 0, "the render did not launch the shade kernel "
              "once a queue step")
        check(frame.shape == (h, w, 3) and frame.is_cuda, "frame shape/device")
        check(torch.isfinite(frame).all().item(), "frame not finite")
        check(stats["claimed"] == stats["lanes"] + n_pix * stats["spp"], "claims")
        print(f"  renderer {stats['renderer']}, {stats['lanes']} lanes, {stats['steps']} queue "
              f"steps, launches B5 {counts['b5']} B13 {counts['b13']} B12 {counts['b12']}, rays "
              f"{stats['rays']}, frame mean {frame.mean(dim=(0, 1)).tolist()}")
        scene_d = scene.to(dev)
        one = lambda: mrt.render(scene_d, w, h, spp, max_bounces=32)
        ms = cuda_ms(one, 1 if stats["seconds"] > 60 else 2)
        med = statistics.median(ms)
        print(f"  forward {stats['rays'] / (med / 1e3) / 1e6:.2f} Mrays/s ({len(ms)} warm "
              f"render{'s' if len(ms) > 1 else ''}, median {med:.1f} ms, {med / stats['steps']:.3f} "
              f"ms a queue step; runs {ms}) on {card_line}")
        wall, busy, by_name = device_share(
            lambda: mrt.render(scene_d, w, h, profile_spp, max_bounces=32))
        named = {"shade_step_kernel": [0.0, 0], "flash_sphere_gated_kernel": [0.0, 0],
                 "flash_sphere_streamed_kernel": [0.0, 0]}
        for kname, (kms, count) in by_name.items():
            for key in named:
                if key in kname:
                    named[key][0] += kms
                    named[key][1] += count
        rest = busy - sum(kms for kms, _ in named.values())
        n_rest = sum(c for kname, (_, c) in by_name.items() if not any(k in kname for k in named))
        per = lambda key: (f"{named[key][0]:.1f} ms over {named[key][1]} launches "
                           f"({named[key][0] / max(named[key][1], 1):.4f} ms a launch)")
        print(f"  one {profile_spp}-spp frame under torch.profiler: wall {wall:.1f} ms, device busy "
              f"{busy:.1f} ms (idle share {max(0.0, 1 - busy / wall):.3f}): B5 "
              f"{per('shade_step_kernel')}, B13 {per('flash_sphere_gated_kernel')}, B12 "
              f"{per('flash_sphere_streamed_kernel')}, {n_rest} other launches "
              f"(claiming, merging, camera rays, the box sweep, candidate assembly) {rest:.1f} ms")
        for kname, (kms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
            print(f"    {kms:8.2f} ms  {100 * kms / busy:5.1f}%  x{count:<6d} {kname[:90]}")
        b5_rows.get(label, {})["profile_ms_a_launch"] = (
            named["shade_step_kernel"][0] / max(named["shade_step_kernel"][1], 1))
        return counts, stats, med

    c_earth, st_earth, ms_earth = main_path("earth", mrt.scenes.earth(1.0), 64, 64)
    check(c_earth["b13"] == c_earth["b12"] == c_earth["b8"] == 0, "earth has no outside set")
    # book2's frame is profiled at 16 spp: the profiler keeps every launch of
    # a frame's ~150,000 in memory
    c_book2, st_book2, ms_book2 = main_path("book2_final", mrt.scenes.book2_final(1.0), 64, 16)
    check(c_book2["b13"] == st_book2["steps"] and c_book2["b12"] == 0,
          "book2_final did not launch the gated sweep once a queue step")
    c_5000, st_5000, ms_5000 = main_path("hybrid_probe with 5000 spheres",
                                         mrt.scenes.hybrid_probe(1.0, 5000, 0), 16, 16)
    check(c_5000["b12"] == st_5000["steps"] and c_5000["b13"] == 0,
          "the 5000-sphere scene did not launch the streamed sweep once a queue step")

    # 17. readings that decide nothing yet: earth by lane count, and
    # random_spheres through the queue against the hybrid loop of phase 12
    print("phase 17: lane counts and queue against hybrid loop (one warm frame each, 500x500, "
          f"64 spp, 32 bounces) on {card_line}")
    for lanes in (65_536, 250_000):  # phase 16 read earth's 131,072
        one = lambda: mrt.render_workqueue(scenes["earth"], w, h, 64, max_bounces=32,
                                           n_lanes=lanes)
        _, st = one()
        ms = cuda_ms(one, 1)[0]
        print(f"  earth, {lanes} lanes: {st['steps']} steps, {ms:.1f} ms, "
              f"{st['rays'] / ms / 1e3:.2f} Mrays/s")
    one = lambda: mrt.render_workqueue(scenes["random_spheres"], w, h, 64, max_bounces=32,
                                       fused_shade=True)
    _, st = one()
    ms = cuda_ms(one, 1)[0]
    print(f"  random_spheres through the queue ({st['lanes']} lanes): {st['steps']} steps, "
          f"{ms:.1f} ms, {st['rays']} rays, {st['rays'] / ms / 1e3:.2f} Mrays/s; through the "
          f"hybrid loop (phase 12): {hybrid_row['frame_steps']} steps, "
          f"{hybrid_row['frame_ms']:.1f} ms")

    # B12's and B13's max_abs_err are phase 13's measured maxima, each on the
    # scene whose main path launches it
    common = {"route": "cuda", "library_ms": None}
    src = "miniraytracer_tpu_torch/csrc/"
    return [
        {"name": "shade_step", "source": src + "hybrid.cu",
         "replaces": "miniraytracer_tpu/ops/hybrid.py:611", "launches": c_earth["b5"],
         "launches_book2_final": c_book2["b5"], "lanes_agreeing": shade_share,
         "ms": b5_rows["earth"]["ms"], "plain_ms": b5_rows["earth"]["plain_ms"],
         "bound_ms": b5_rows["earth"]["bound_ms"], "bound_by": b5_rows["earth"]["bound_by"],
         "parent_ms": (b5_rows["earth"]["vs_parent"] or {}).get("parent_ms"),
         "book2_final": b5_rows["book2_final"], "earth": b5_rows["earth"],
         "frame_ms_earth": ms_earth, "frame_steps_earth": st_earth["steps"],
         "frame_ms_book2_final": ms_book2, "frame_steps_book2_final": st_book2["steps"],
         "max_abs_err": shade_err, **common},
        {"name": "flash_sphere_hit_streamed", "source": src + "flash.cu",
         "replaces": "miniraytracer_tpu/ops/flash.py:1175", "launches": c_5000["b12"],
         "frame_ms": ms_5000, "frame_steps": st_5000["steps"],
         "max_abs_err": clustered_err["probe_5000"][1],
         **sweep_rows["probe_5000"], **common},
        {"name": "flash_sphere_hit_gated", "source": src + "flash.cu",
         "replaces": "miniraytracer_tpu/ops/flash.py:1343", "launches": c_book2["b13"],
         "max_abs_err": clustered_err["book2_final"][0], **sweep_rows["book2_final"], **common},
    ]


# ---------------------------------------------------------------------------
# The renderers whose shading is tensor operations: kernel B6 (noise.cu)
# beside the sweeps B8, B13 and B12
# ---------------------------------------------------------------------------

# fp32 instructions of one point of B6, counted from physics.cuh::turbulence
# (--fmad=false, common subexpressions taken once): per octave the lattice of
# three coordinates (floor, fraction, hermite weight: 6 each, 18), the nine
# distinct weights 1-h and offsets fr-1 (9), 8 corners of a 3-term dot (5) and
# the weighted add (3, with ax*ay shared by two corners: 8.5), 68, and the
# octave's sum, weight and scaling (6): ~101 an octave, 7 octaves and the
# final |.|: ~710. The table indexing (integer) is not counted.
FP32_OPS_PER_TURB_POINT = 710


def turbulence_points(integrator, noise, scene, size, step):
    """The points (scaled hit points of every lane) that the work queue hands
    to B6 at queue step `step` of a size x size render with the default lanes
    (1 sample, the bounce cap at `step`: the steps up to it are those of any
    longer render). The shading evaluates every lane's turbulence and selects
    after (`textures.sample_texture`). Returns (tables, points, the lanes
    whose material's texture is Perlin)."""
    from miniraytracer_tpu_torch.models import materials
    from miniraytracer_tpu_torch.scene import types as T

    calls, perlin = [], []
    real, real_tex = noise.flash_turbulence, materials.sample_texture

    def record(ptab, p):
        calls.append((ptab, p))
        return real(ptab, p)

    def record_tex(scene, tex_id, *args, **kw):
        perlin.append(int((scene.tex_type[tex_id.long()] == T.TEX_PERLIN).sum()))
        return real_tex(scene, tex_id, *args, **kw)

    noise.flash_turbulence, materials.sample_texture = record, record_tex
    try:
        integrator.render_workqueue_pixels(
            scene, size * size, integrator.wq_auto_lanes(scene, size * size), 1, 1000.0,
            width=size, height=size, max_bounces=step, spp_sq=1, fused_shade=False)
    finally:
        noise.flash_turbulence, materials.sample_texture = real, real_tex
    check(len(calls) == len(perlin), "sample_texture and B6 were not called once a step each")
    return (*calls[step], perlin[step])


def compare_eager_queue(name, integrator, scene, size, sq, bounces, lanes, counters):
    """A whole work-queue render with its shading in tensor operations through
    the kernels against their plain versions. B6, B8, B10, B12 and B13 equal
    their plain versions to the bit, so steps, claims, sample counts and rays
    must be EQUAL and every pixel within 1e-6*(1+|plain|) (the merge adds with
    float atomics, in another order on every run). `counters` maps a label
    to a function reading a launch count; each must grow by one a step in
    the kernels' run and not at all in the plain one."""
    kw = dict(width=size, height=size, max_bounces=bounces, spp_sq=sq, fused_shade=False)
    read = lambda: [count() for count in counters.values()]
    before = read()
    sk, sp = {}, {}
    ak, ck, rk = integrator.render_workqueue_pixels(scene, size * size, lanes, sq * sq, 1000.0,
                                                    stats=sk, **kw)
    launched = read()
    ap, cp, rp = integrator.render_workqueue_pixels(scene, size * size, lanes, sq * sq, 1000.0,
                                                    stats=sp, plain=True, **kw)
    fk, fp = ak / ck.clamp_min(1)[:, None], ap / cp.clamp_min(1)[:, None]
    err = (fk - fp).abs()
    worst = float((err / (1 + fp.abs())).max())
    steps = [n - b for n, b in zip(launched, before)]
    print(f"  {name}: steps {sk['steps']} (plain {sp['steps']}), claims {sk['claimed']} "
          f"({sp['claimed']}), rays {int(rk)} ({int(rp)}); launches a step "
          f"{'/'.join(counters)} {[n / sk['steps'] for n in steps]}; max abs err "
          f"{float(err.max()):.3g}, over 1+|plain| {worst:.3g}")
    check(sk == sp and int(rk) == int(rp) and torch.equal(ck, cp),
          f"{name}: steps, claims, rays or sample counts differ from plain")
    check(int(ck.sum()) == size * size * sq * sq, f"{name}: samples were lost")
    check(torch.isfinite(fk).all().item() and worst <= 1e-6, f"{name}: frame differs from plain")
    check(all(n == sk["steps"] for n in steps) and read() == launched,
          f"{name}: {'/'.join(counters)} did not launch once a step")
    return float(err.max())


def sphere_counters(flash, noise):
    """The launch counts of the eager queue's kernels on a sphere scene: the
    sphere sweep (whichever tier) and the turbulence."""
    return {"B8+B13+B12": lambda: flash.sphere_launches + flash.gated_launches
            + flash.streamed_launches, "B6": lambda: noise.launches}


def eager_phases(mrt, flash, hybrid, noise, dev, card_line, refs, rows, size=500, spp=64,
                 bounces=32, small=64, ref_size=100, profile_spp=8):
    """Phases 18 to 22: kernel B6 and the renderers whose shading is tensor
    operations. Returns B6's row of the result line; B8's row gains its
    launches in the random_spheres_2 frame."""
    import dataclasses

    from miniraytracer_tpu_torch.models import integrator
    from miniraytracer_tpu_torch.ops.vecmath import V3

    rs2 = mrt.scenes.random_spheres_2(1.0).to(dev)

    # 18. B6 vs plain on the points of queue step 2 of random_spheres_2 and on
    # uniform points whose lattice cells run negative, an odd count of them
    print(f"phase 18: turbulence kernel B6 vs plain PyTorch ({size}x{size} queue step 2, and "
          "uniform points)")
    from miniraytracer_tpu_torch.utils import kernels

    print_ptxas(kernels, "noise", "turbulence_kernel")
    ptab, p_step, n_perlin = turbulence_points(integrator, noise, rs2, size, 2)
    print(f"  queue step 2: {p_step.x.numel()} points, {n_perlin} of them on a Perlin surface")
    gen = torch.Generator(device=dev).manual_seed(5)
    u = torch.rand((3, 1_000_003), generator=gen, device=dev) * 600.0 - 300.0
    b6_err = 0.0
    for label, p in (("random_spheres_2 queue step 2", p_step),
                     ("uniform points in [-300, 300]^3", V3(u[0], u[1], u[2]))):
        parent_equal(kernels, "noise", lambda: noise.flash_turbulence(ptab, p),
                     f"B6 on the {label}")
        k, pl = noise.flash_turbulence(ptab, p), noise.flash_turbulence_plain(ptab, p)
        err = float((k - pl).abs().max())
        tol = 1e-6 * max(1.0, float(pl.abs().max()))
        print(f"  {label}: {p.x.numel()} points, {int((p.x < 0).sum())} with a negative x; max abs "
              f"err {err:.3g} (tolerance {tol:.3g}: 1e-6 of the largest value; 0 expected, both "
              f"round the same operations in the same order)")
        check(torch.isfinite(k).all().item() and err <= tol, f"{label}: B6 differs from plain")
        b6_err = max(b6_err, err)
    n = p_step.x.numel()
    b6_k, b6_p = in_turns(lambda: noise.flash_turbulence(ptab, p_step),
                          lambda: noise.flash_turbulence_plain(ptab, p_step), kernel_reps=20)
    b6_bound, b6_by = bound(16 * n + 4 * ptab.numel(), n * FP32_OPS_PER_TURB_POINT)
    b6_one = lambda: noise.flash_turbulence(ptab, p_step)
    b6_ms = statistics.median(queued_ms(b6_one))
    grid = (ctypes.c_int * 5)()
    kernels.load("noise").mrt_turbulence_grid(n, grid)
    print(f"  B6 at {n} points: grid {grid[2]} blocks of {grid[3]} ({grid[0]} an SM x {grid[1]} "
          f"SMs); device {b6_ms:.4f} ms a launch (queued), with the wrapper {b6_k} ms, plain "
          f"{b6_p} ms, bound {b6_bound:.4f} ms by {b6_by} on {card_line}")
    b6_vs = print_against_parent(f"B6 at {n} points, device ms a launch (queued, 20 a turn)",
                                 against_parent(kernels, "noise", b6_one, 20, rounds=2,
                                                queued=True), card_line)

    # 19. the queue with its shading in tensor operations, kernels vs plain
    print(f"phase 19: work queue with its shading in tensor operations, kernels vs plain PyTorch, "
          f"{small}x{small}, 4 spp, 8 bounces, 1000 lanes")
    book2 = mrt.scenes.book2_final(1.0).to(dev)
    for name, scene in (("random_spheres_2", rs2), ("book2_final", book2)):
        compare_eager_queue(name, integrator, scene, small, 2, 8, 1000,
                            sphere_counters(flash, noise))

    # 20. the plain wavefront on the card: a Perlin scene through B6, kernels
    # vs plain; a fast_perlin scene through render()
    print(f"phase 20: render_wavefront, {small}x{small}, 4 spp, 8 bounces")
    perlin = mrt.scenes.perlin_spheres(1.0).to(dev)
    noise.launches = 0
    fk, sk = integrator.render_wavefront(perlin, small, small, 4, max_bounces=8)
    b6_wave = noise.launches
    fp, sp = integrator.render_wavefront(perlin, small, small, 4, max_bounces=8, plain=True)
    err = float(((fk - fp).abs() / (1 + fp.abs())).max())
    print(f"  perlin_spheres: {sk['steps']} steps, B6 launched {b6_wave} times, rays {sk['rays']} "
          f"(plain {sp['rays']}), max err over 1+|plain| {err:.3g}")
    check(sk["rays"] == sp["rays"] and sk["steps"] == sp["steps"] == b6_wave,
          "perlin_spheres: the wavefront differs from plain or did not launch B6 once a step")
    check(err <= 1e-6, "perlin_spheres: wavefront frame differs from plain")
    fast = dataclasses.replace(mrt.scenes.perlin_spheres(1.0), fast_perlin=True)
    frame, st = mrt.render(fast, small, small, 4, max_bounces=8)
    print(f"  fast_perlin perlin_spheres through render(): renderer {st['renderer']}, "
          f"{st['steps']} steps, rays {st['rays']}, frame mean {frame.mean(dim=(0, 1)).tolist()}")
    check(st["renderer"] == "wavefront" and frame.is_cuda and torch.isfinite(frame).all().item(),
          "fast_perlin: render() did not draw it through the wavefront on the card")

    # 21. random_spheres_2 vs the reference renderer's frame. Its few earth-
    # mapped spheres take the procedural map without the file, as in the
    # JAX package, whose test holds 0.02 at this size
    print(f"phase 21: random_spheres_2 vs reference renderer, {ref_size}x{ref_size}, 16 spp, "
          "16 bounces")
    frame, _ = mrt.render(rs2, ref_size, ref_size, 16, max_bounces=16)
    ours = frame.cpu().numpy()
    check(np.isfinite(ours).all(), "random_spheres_2: frame not finite")
    ref_mean = refs["random_spheres_2"].mean(axis=(0, 1))
    rel = np.abs(ref_mean - ours.mean(axis=(0, 1))) / np.maximum(ref_mean, 1e-6)
    print(f"  channel means rel diff {rel.max():.4f} (tolerance 0.02)")
    check(rel.max() < 0.02, "random_spheres_2: reference parity")

    # 22. the main path: render() of random_spheres_2 at 500x500x64x32
    print(f"phase 22: mrt.render(random_spheres_2, {size}, {size}, {spp}, max_bounces={bounces})")
    scene = mrt.scenes.random_spheres_2(1.0)
    torch.cuda.synchronize()
    noise.launches = hybrid.shade_launches = 0
    flash.sphere_launches = flash.gated_launches = flash.streamed_launches = 0
    frame, stats = mrt.render(scene, size, size, spp, max_bounces=bounces)
    b6, b8 = noise.launches, flash.sphere_launches
    check(stats["renderer"] == "workqueue", f"renderer {stats['renderer']}")
    check(b6 == b8 == stats["steps"] > 0 and hybrid.shade_launches == 0,
          "the render did not launch B6 and B8 once a queue step (and no shade kernel)")
    check(frame.shape == (size, size, 3) and frame.is_cuda, "frame shape/device")
    check(torch.isfinite(frame).all().item(), "frame not finite")
    check(stats["claimed"] == stats["lanes"] + size * size * stats["spp"], "claims")
    print(f"  renderer {stats['renderer']}, {stats['lanes']} lanes, {stats['steps']} queue steps, "
          f"launches B6 {b6} B8 {b8}, rays {stats['rays']}, frame mean "
          f"{frame.mean(dim=(0, 1)).tolist()}")
    scene_d = scene.to(dev)
    ms = cuda_ms(lambda: mrt.render(scene_d, size, size, spp, max_bounces=bounces), 1)
    med = statistics.median(ms)
    print(f"  forward {stats['rays'] / (med / 1e3) / 1e6:.2f} Mrays/s (one warm render, "
          f"{med:.1f} ms, {med / stats['steps']:.3f} ms a queue step) on {card_line}")
    # an 8-spp frame: the profiler keeps every launch of a frame (~1,800 a
    # step) in memory, and reading them back takes longer than the frame
    wall, busy, by_name = device_share(
        lambda: mrt.render(scene_d, size, size, profile_spp, max_bounces=bounces))
    named = {"turbulence_kernel": 0.0, "flash_sphere_kernel": 0.0}
    for kname, (kms, _) in by_name.items():
        for key in named:
            if key in kname:
                named[key] += kms
    rest = busy - sum(named.values())
    n_rest = sum(c for kname, (_, c) in by_name.items() if not any(k in kname for k in named))
    print(f"  one {profile_spp}-spp frame under torch.profiler: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms (idle share {max(0.0, 1 - busy / wall):.3f}): B6 "
          f"{named['turbulence_kernel']:.1f} ms, B8 {named['flash_sphere_kernel']:.1f} ms, "
          f"{n_rest} other launches (intersection and shading in tensor operations, claiming, "
          f"merging, camera rays) {rest:.1f} ms")
    for kname, (kms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"    {kms:8.2f} ms  {100 * kms / busy:5.1f}%  x{count:<6d} {kname[:90]}")

    for row in rows:
        if row["name"] == "flash_sphere_hit":
            row["launches_random_spheres_2"] = b8
    return [{
        "name": "flash_turbulence", "route": "cuda",
        "source": "miniraytracer_tpu_torch/csrc/noise.cu",
        "replaces": "miniraytracer_tpu/ops/noise.py:73", "launches": b6,
        "max_abs_err": b6_err, "ms": b6_ms, "wrapper_ms": statistics.mean(b6_k),
        "plain_ms": statistics.mean(b6_p), "bound_ms": b6_bound, "bound_by": b6_by,
        "library_ms": None, "points": n, "points_on_perlin": n_perlin,
        "parent_ms": b6_vs["parent_ms"] if b6_vs else None,
        "frame_ms": med, "frame_steps": stats["steps"], "frame_rays": stats["rays"],
        "profile_spp": profile_spp, "profile_device_busy_ms": busy,
        "profile_b6_device_ms": named["turbulence_kernel"],
    }]


# ---------------------------------------------------------------------------
# The triangle tiers: kernels B10, B11 and B9 (flash.cu), and the triangles
# scene through the work queue
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def stand_in_assets(mrt):
    """MRT_ASSETS naming a temporary directory of the stand-in meshes of the
    reference's size (`scenes.write_stand_in_meshes`, 11,264 triangles) while
    inside; yields the directory."""
    import tempfile

    old = os.environ.get("MRT_ASSETS")
    with tempfile.TemporaryDirectory() as assets:
        mrt.scenes.write_stand_in_meshes(assets)
        os.environ["MRT_ASSETS"] = assets
        try:
            yield assets
        finally:
            if old is None:
                del os.environ["MRT_ASSETS"]
            else:
                os.environ["MRT_ASSETS"] = old


def triangles_scene(mrt):
    """The triangles scene with the stand-in meshes."""
    with stand_in_assets(mrt):
        return mrt.scenes.triangles(1.0)


def compare_tri_clustered(where, flash, cull, coeffs, ro, rd, inside, alive, seed, tmin):
    """B10, B11 and B9 (rays sorted and not) on the same rays against their
    plain versions (t and index EQUAL on every ray), unseeded and from the
    main path's seed (the nearest rect; 0 on a dead lane), and against the
    dense kernel B7: the hit sets agree but for rays that graze a cluster's
    box (at most 1 in 10,000, and there the clustered t is the larger), t is
    equal to the bit where both hit, the winners agree where the two t are
    equal (else a tie across clusters); from the seed, t is the dense t where
    that is nearer and the seed, with index 0, elsewhere. Dead lanes miss.
    Returns the max |t - plain| over the kernels (0 when equal)."""
    args = (ro, rd, inside, tmin)
    tp, ip = flash.flash_tri_hit_resident_plain(cull, *args)
    tu, iu = flash.flash_tri_hit_culled_plain(cull, *args, sort_rays=False)
    tsp, isp = flash.flash_tri_hit_resident_plain(cull, *args, seed)
    err = 0.0
    for name, (t, i), (t0, i0) in (
            ("B10", flash.flash_tri_hit_resident(cull, *args), (tp, ip)),
            ("B11", flash.flash_tri_hit_streamed(cull, *args), (tp, ip)),
            ("B9", flash.flash_tri_hit_culled(cull, *args), (tp, ip)),
            ("B9 unsorted", flash.flash_tri_hit_culled(cull, *args, sort_rays=False), (tu, iu)),
            ("seeded B10", flash.flash_tri_hit_resident(cull, *args, seed), (tsp, isp)),
            ("seeded B11", flash.flash_tri_hit_streamed(cull, *args, seed), (tsp, isp)),
            ("seeded B9", flash.flash_tri_hit_culled(cull, *args, seed), (tsp, isp))):
        d = torch.where(t == t0, torch.zeros_like(t), (t - t0).abs())
        err = max(err, float(torch.where(i == i0, d, float("inf")).max()))
        check(torch.equal(t, t0) and torch.equal(i, i0), f"{where}: {name} differs from plain")
    td, idd = flash.flash_tri_hit(coeffs, *args)
    hit, hit_d = tp < 3e38, td < 3e38
    off = tp != td
    check(float(off.float().mean()) <= 1e-4 and bool((tp[off] > td[off]).all()),
          f"{where}: the clustered sweeps differ from the dense sweep on {int(off.sum())} rays")
    both = hit & hit_d
    same = float((ip[both & ~off] == idd[both & ~off]).float().mean())
    check(same >= 0.999, f"{where}: winners agree with dense on only {same:.5f} of the hits")
    check(torch.equal(tu, tp), f"{where}: the visiting order changed t")
    check(int(hit.sum()) > 0 and not bool(hit[~alive].any()) and not bool(ip[~alive].any()),
          f"{where}: no hits, or a dead lane hit something")
    nearer = td < seed
    check(torch.equal(tsp[nearer], td[nearer]) and torch.equal(tsp[~nearer], seed[~nearer])
          and not bool(isp[~nearer].any()), f"{where}: the seed is not kept exactly")
    print(f"  {where}: {tp.numel()} rays ({int(alive.sum())} alive, "
          f"{int((inside[alive] > 0).sum())} inside a medium), {int(hit.sum())} hits (dense "
          f"{int(hit_d.sum())}); B10, B11, B9 and B9 unsorted equal plain on every ray, seeded "
          f"too; {int(off.sum())} rays differ from the dense sweep; winner equal to dense on "
          f"{same:.6f} of the common hits (the rest tie across clusters); max |dt| 0 where "
          f"both hit; the seed (the nearest rect) kept on {int((~nearer & alive).sum())} lanes, "
          f"the triangle nearer on {int((nearer & alive).sum())}")
    return err


def triangle_phases(mrt, bounce, flash, hybrid, dev, card_line, size=500, spp=64, bounces=32,
                    small=64, profile_spp=8, late_step=40, keep=None):
    """Phases 23 to 26: the clustered triangle sweeps and the triangles
    scene. Returns the rows of B10, B11 and B9 in the result line. `keep`, a
    dict, receives the scene, its cluster tables and the rays of queue step
    2 (phase 35 walks the BVH on them)."""
    from miniraytracer_tpu_torch.models import integrator
    from miniraytracer_tpu_torch.ops import intersect as ix
    from miniraytracer_tpu_torch.ops.vecmath import V3
    from miniraytracer_tpu_torch.utils import kernels

    scene = triangles_scene(mrt).to(dev)
    cull = flash.scene_tri_cull(scene)
    coeffs = flash.scene_tri_coefficients(scene)
    nc = cull[1].shape[1]
    block = cull[0][0].shape[0] // nc
    check(scene.n_tris == 11264 and flash.resident_ok(cull), "the stand-in meshes")
    lanes = integrator.wq_auto_lanes(scene, size * size)

    # 23. B10/B11/B9 vs plain and vs the dense B7 on rays of queue steps
    # 4 spp: the claims run out after some 30 steps, so that the late step
    # has dead lanes
    calls = queue_snapshots(integrator, hybrid, scene, size, size, 2, bounces, lanes)
    steps_at = (2, min(late_step, len(calls) - 4))
    print(f"phase 23: clustered triangle sweeps vs plain PyTorch and vs the dense sweep B7, on "
          f"rays of queue steps {steps_at} of {len(calls)} of the triangles scene at "
          f"{size}x{size}, 4 spp ({scene.n_tris} stand-in triangles in {nc} clusters of {block})")
    err, timed = 0.0, None
    for t in steps_at:
        _, fstate, inside, _, _ = calls[t]
        ro, rd, time_, inside, alive = snapshot_rays(hybrid, fstate, inside)
        check(t < 3 or bool((~alive).any()), f"step {t} has no dead lane")
        # the main path's seed: the nearest rect (a t-only sweep of the real
        # rays); a dead lane's seed is 0
        real = ix.Rays(ro=V3(*fstate[hybrid.SH_RO:hybrid.SH_RO + 3]),
                       rd=V3(*fstate[hybrid.SH_RD:hybrid.SH_RD + 3]), time=time_, inside=inside)
        inf = torch.full_like(time_, 3.0e38)
        t_r, _ = ix._chunked_min(lambda s, c: ix.rect_ts(scene, real, s, c, bounce.TMIN, inf),
                                 scene.n_rects, time_.numel(), dev)
        seed = torch.where(alive, t_r, 0.0)
        err = max(err, compare_tri_clustered(f"step {t}", flash, cull, coeffs, ro, rd, inside,
                                             alive, seed, bounce.TMIN))
        if t == steps_at[0]:
            timed = (ro, rd, inside, alive, seed)
            if keep is not None:
                keep.update(scene=scene, cull=cull, rays=(ro, rd, time_, inside, alive))
    del calls
    ro, rd, inside, alive, seed = timed
    n, n_live = alive.numel(), int(alive.sum())
    args = (cull, ro, rd, inside, bounce.TMIN)
    dense_ms = cuda_ms(lambda: flash.flash_tri_hit(coeffs, ro, rd, inside, bounce.TMIN), 3)
    rows = {}
    for label, kernel, plain, seeded in (
            ("flash_tri_hit_resident", flash.flash_tri_hit_resident,
             flash.flash_tri_hit_resident_plain, True),
            ("flash_tri_hit_streamed", flash.flash_tri_hit_streamed,
             flash.flash_tri_hit_streamed_plain, True),
            ("flash_tri_hit_culled", flash.flash_tri_hit_culled,
             flash.flash_tri_hit_culled_plain, False)):
        extra = (seed,) if seeded else ()
        k_ms, p_ms = in_turns(lambda: kernel(*args, *extra), lambda: plain(*args, *extra))
        work = {}
        plain(*args, *extra, count=work)
        ops = work["clusters"] * block * FP32_OPS_PER_TRI_PAIR + n_live * nc * FP32_OPS_PER_SLAB_TEST
        b_ms, b_by = bound(4 * (n * 11 + sum(t.numel() for t in (*cull[0], cull[1], cull[2],
                                                                  cull[3]))), ops)
        print(f"  {label} at {n} rays ({n_live} alive){' from the rect seed' if seeded else ''}: "
              f"a ray sweeps {work['clusters'] / max(n_live, 1):.2f} of {nc} clusters; kernel "
              f"{k_ms} ms, plain {p_ms} ms, the dense kernel B7 on the same rays "
              f"{statistics.median(dense_ms):.3f} ms (runs {dense_ms}), bound {b_ms:.4f} ms by "
              f"{b_by}; on {card_line}")
        rows[label] = dict(ms=statistics.mean(k_ms), plain_ms=statistics.mean(p_ms), bound_ms=b_ms,
                           bound_by=b_by, dense_b7_ms=statistics.median(dense_ms),
                           clusters_per_ray=work["clusters"] / max(n_live, 1),
                           pairs_passed=work["clusters"], rays=n, rays_alive=n_live)
    # B10 as the main path launches it (sorted rays, the rect seed): the
    # kernel alone, from a visiting plan made once, and the wrapper's ray sort
    # alone; the kernel against the parent's design in turns
    print("  the cluster loop (flash_tri_clustered_kernel, flash_sphere_*_kernel), ptxas -v:")
    for entry in ("flash_tri_clustered_kernel", "flash_sphere_gated_kernel",
                  "flash_sphere_streamed_kernel"):
        for line in ptxas_lines(kernels.build_log("flash"), entry):
            print("    new design", line)
        if parent_libs.get("flash") is not None:
            with open(os.path.join(PARENT_CSRC, "libflash.so.log")) as f:
                for line in ptxas_lines(f.read(), entry):
                    print("    parent's  ", line)
    plan = flash._visit_plan(ro, rd, cull[1], True)
    b10_alone = lambda: flash.launch_tri_planned(10, cull, ro, rd, inside, bounce.TMIN, seed, *plan)
    check(all(torch.equal(a, b) for a, b in zip(
        b10_alone(), flash.flash_tri_hit_resident(cull, ro, rd, inside, bounce.TMIN, seed))),
        "B10 from a plan differs from B10")
    alone_ms = cuda_ms(lambda: [b10_alone() for _ in range(10)], 3)
    sort_ms = cuda_ms(lambda: [flash._visit_plan(ro, rd, cull[1], True) for _ in range(10)], 3)
    print(f"  B10 on those rays from the rect seed: the kernel alone "
          f"{[m / 10 for m in alone_ms]} ms, the wrapper's ray sort (_visit_plan) alone "
          f"{[m / 10 for m in sort_ms]} ms a launch (10 launches a timing) on {card_line}")
    rows["flash_tri_hit_resident"].update(
        kernel_alone_ms=statistics.median(alone_ms) / 10,
        ray_sort_ms=statistics.median(sort_ms) / 10,
        parent_design=print_against_parent(
            "B10, the kernel alone", against_parent(kernels, "flash", b10_alone, 10, rounds=2),
            card_line))
    del timed, args, ro, rd, inside, alive, seed
    torch.cuda.empty_cache()

    # 24. whole queue renders through the kernels against the plain versions
    print(f"phase 24: triangles through the work queue, kernels vs plain PyTorch, {small}x{small}, "
          "4 spp, 8 bounces, 1000 lanes")
    compare_queue("triangles (shade step B5, outside candidate from B10)", integrator, scene,
                  small, small, 2, 8, 1000)
    compare_eager_queue("triangles (shading in tensor operations)", integrator, scene, small,
                        2, 8, 1000, {"B10": lambda: flash.resident_launches})

    # 25. the main path: render() of the triangles scene at 500x500x64x32
    print(f"phase 25: mrt.render(triangles with stand-in meshes, {size}, {size}, {spp}, "
          f"max_bounces={bounces})")
    host_scene = triangles_scene(mrt)
    torch.cuda.synchronize()
    hybrid.shade_launches = hybrid.step_launches = flash.tri_launches = 0
    flash.resident_launches = flash.tri_streamed_launches = flash.culled_launches = 0
    frame, stats = mrt.render(host_scene, size, size, spp, max_bounces=bounces)
    counts = dict(b5=hybrid.shade_launches, b10=flash.resident_launches,
                  b11=flash.tri_streamed_launches, b9=flash.culled_launches,
                  b7=flash.tri_launches, b4=hybrid.step_launches)
    check(stats["renderer"] == "workqueue", f"renderer {stats['renderer']}")
    check(counts["b5"] == counts["b10"] == stats["steps"] > 0,
          "the render did not launch B5 and B10 once a queue step")
    check(counts["b11"] == counts["b9"] == counts["b7"] == counts["b4"] == 0,
          "the render launched another triangle sweep or step kernel")
    check(frame.shape == (size, size, 3) and frame.is_cuda, "frame shape/device")
    check(torch.isfinite(frame).all().item(), "frame not finite")
    check(stats["claimed"] == stats["lanes"] + size * size * stats["spp"], "claims")
    print(f"  renderer {stats['renderer']}, {stats['lanes']} lanes, {stats['steps']} queue steps, "
          f"launches B5 {counts['b5']} B10 {counts['b10']} (B11 {counts['b11']}, B9 {counts['b9']}), "
          f"rays {stats['rays']}, frame mean {frame.mean(dim=(0, 1)).tolist()}")
    one = lambda: mrt.render(scene, size, size, spp, max_bounces=bounces)
    ms = cuda_ms(one, 2)
    med = statistics.median(ms)
    print(f"  forward {stats['rays'] / (med / 1e3) / 1e6:.2f} Mrays/s (median of 2 warm renders, "
          f"{med:.1f} ms each, {med / stats['steps']:.3f} ms a queue step; runs {ms}) on "
          f"{card_line}")
    frame_vs = print_against_parent("the triangles frame", against_parent(kernels, "flash", one, 1),
                                    card_line)
    wall, busy, by_name = device_share(
        lambda: mrt.render(scene, size, size, profile_spp, max_bounces=bounces))
    named = {"flash_tri_clustered_kernel": [0.0, 0], "shade_step_kernel": [0.0, 0]}
    for kname, (kms, count) in by_name.items():
        for key in named:
            if key in kname:
                named[key][0] += kms
                named[key][1] += count
    sweep_ms, sweep_n = named["flash_tri_clustered_kernel"]
    rest = busy - sweep_ms - named["shade_step_kernel"][0]
    n_rest = sum(c for kname, (_, c) in by_name.items() if not any(k in kname for k in named))
    print(f"  one {profile_spp}-spp frame under torch.profiler: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms (idle share {max(0.0, 1 - busy / wall):.3f}): B10 {sweep_ms:.1f} ms over "
          f"{sweep_n} launches ({sweep_ms / max(sweep_n, 1):.3f} ms a launch, "
          f"{sweep_ms / max(busy, 1e-9):.3f} of device time), B5 {named['shade_step_kernel'][0]:.1f} "
          f"ms, {n_rest} other launches (the ray sort, the rect seed, claiming, merging, camera "
          f"rays, candidate assembly) {rest:.1f} ms")
    for kname, (kms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"    {kms:8.2f} ms  {100 * kms / busy:5.1f}%  x{count:<6d} {kname[:90]}")

    # 26. the other two entry points on paths of their own. B9 has no route
    # in a renderer (the JAX package calls it from its tests and checkup):
    # it is called as they call it, here on the camera rays of the triangles
    # frame, against B7. Past the resident budget (more than 40,960
    # triangles) `render` takes B11, as in the JAX package (here the same
    # loop).
    print(f"phase 26: flash_tri_hit_culled on the {size}x{size} camera rays of the triangles "
          "scene; a 49,152-triangle scene through render() takes B11")
    from miniraytracer_tpu_torch.models import camera as cam_mod
    from miniraytracer_tpu_torch.ops import rng as rng_mod

    pix = torch.arange(size * size, dtype=torch.int64, device=dev)
    zero = torch.zeros_like(pix)
    ss, tt = bounce.film_coords(pix, zero, size, size, 1)
    cam = cam_mod.get_rays(scene.camera, ss, tt, rng_mod.ray_key(pix, zero))
    torch.cuda.synchronize()
    flash.culled_launches = 0
    t9, i9 = flash.flash_tri_hit_culled(cull, cam.ro, cam.rd, cam.inside, bounce.TMIN)
    b9_launches = flash.culled_launches
    t7, i7 = flash.flash_tri_hit(coeffs, cam.ro, cam.rd, cam.inside, bounce.TMIN)
    hit9, off9 = t9 < 3e38, t9 != t7
    check(b9_launches == 1 and int(hit9.sum()) > 0 and float(off9.float().mean()) <= 1e-4
          and bool((t9[off9] > t7[off9]).all()), "B9 on the camera rays differs from B7")
    print(f"  B9 launched {b9_launches} time on {pix.numel()} camera rays: {int(hit9.sum())} hits, "
          f"t equal to B7 on all but {int(off9.sum())} rays, winner equal on "
          f"{float((i9[hit9 & ~off9] == i7[hit9 & ~off9]).float().mean()):.6f} of the hits")
    b = mrt.SceneBuilder()
    b.name = "triangles_49152"
    b.set_camera([0, 3, 12], [0, 1, 0], [0, 1, 0], 40.0, 1.0, aperture=0.0, focus_dist=10.0,
                 t0=0.0, t1=0.0)
    rs = np.random.default_rng(0)
    p = rs.uniform(-5, 5, (49152, 3)).astype(np.float32)
    b.triangles_bulk(p, p + rs.uniform(-0.2, 0.2, (49152, 3)), p + rs.uniform(-0.2, 0.2, (49152, 3)),
                     b.lambertian(b.tex_const([0.5, 0.5, 0.5])))
    big = b.build()
    torch.cuda.synchronize()
    flash.resident_launches = flash.tri_streamed_launches = 0
    frame, st = mrt.render(big, 64, 64, 4, max_bounces=8)
    check(st["renderer"] == "workqueue" and flash.tri_streamed_launches == st["steps"] > 0
          and flash.resident_launches == 0, "the big scene did not launch B11 once a step")
    check(torch.isfinite(frame).all().item(), "frame not finite")
    print(f"  {big.n_tris} triangles: {st['steps']} queue steps, B11 launched "
          f"{flash.tri_streamed_launches} times, rays {st['rays']}")
    b11_launches = flash.tri_streamed_launches

    common = {"route": "cuda", "source": "miniraytracer_tpu_torch/csrc/flash.cu",
              "max_abs_err": err, "library_ms": None}
    return [
        {"name": "flash_tri_hit_resident", "replaces": "miniraytracer_tpu/ops/flash.py:701",
         "launches": counts["b10"], **rows["flash_tri_hit_resident"], "frame_ms": med,
         "frame_parent_design": frame_vs,
         "frame_steps": stats["steps"], "frame_rays": stats["rays"],
         "profile_spp": profile_spp, "profile_device_busy_ms": busy,
         "profile_b10_device_ms": sweep_ms, "profile_wall_ms": wall, **common},
        {"name": "flash_tri_hit_streamed", "replaces": "miniraytracer_tpu/ops/flash.py:918",
         "launches": b11_launches, "launches_path": "render of a 49,152-triangle scene",
         "launches_triangles_frame": counts["b11"], **rows["flash_tri_hit_streamed"], **common},
        {"name": "flash_tri_hit_culled", "replaces": "miniraytracer_tpu/ops/flash.py:462",
         "launches": b9_launches, "launches_path": "the entry point on the camera rays",
         "launches_triangles_frame": counts["b9"], **rows["flash_tri_hit_culled"], **common},
    ]


# ---------------------------------------------------------------------------
# The hybrid-ext train step: kernels B2/B3 (bounce_ad.cu) in their ext,
# ext-material and image modes, with the differentiable sweeps
# ---------------------------------------------------------------------------

# the four scenes outside the fused class that the JAX package trains with
# fused="ext" (benchmarks/ad_scenes.py)
EXT_SCENES = ("random_spheres", "triangles", "earth", "book2_final")
# the kernels' instance each result row reports (bounce_ad.step_mode)
EXT_MODES = ("ext", "ext_mat", "image")


def ext_scene(mrt, name):
    return triangles_scene(mrt) if name == "triangles" else getattr(mrt.scenes, name)(1.0)


def ext_states(bounce_ad, hybrid, scene, w, spp, bounces, at, plain):
    """Entry states and candidate rows of real steps of the hybrid-ext scan
    over the whole image: (meta, cfg, tables, images, pix, sb, outer,
    {t: (res_f, istate, keys, ext)}) for the steps in `at`."""
    plan = hybrid.smem_plan(scene) if hybrid.ext_mat_mode(scene) else None
    meta, tables = hybrid.pack_scene_hybrid(scene, plan)
    tables = [t.detach() for t in tables]
    _, claim, k_sub, outer = bounce_ad.scan_plan(spp, bounces, 0, 1)
    cfg = bounce_ad.StepConfig(w, w, 8, bounces, spp, claim, k_sub)
    pix = torch.arange(w * w, dtype=torch.int32, device=scene.device)
    sb = torch.zeros_like(pix)
    f, i, k = bounce_ad.initial_state(scene, pix, sb, spp, width=w, height=w, sq_off=8)
    cand = bounce_ad.ExtCandidate(scene, plain)
    images = scene.images if meta["image"] else None
    step = bounce_ad.ad_step_fwd_plain if plain else bounce_ad.ad_step_fwd
    states = {}
    with torch.no_grad():
        for t in range(max(at) + 1):
            ext = cand.rows(f, i)
            if t in at:
                states[t] = (f[bounce_ad.RES_LO:bounce_ad.RES_HI].contiguous(), i, k, ext)
            f, i, k = step(meta, cfg, tables, t, f, i, k, pix, sb, ext, images)
    return meta, cfg, tables, images, pix, sb, outer, states


def ext_gradient_check(mrt, bounce_ad, step, scene, params, target, w, spp, bounces):
    """The train step's gradient at `params` against central differences
    (eps 1e-2) of the same loss on the same sample set (set 0), entry by
    entry: the ground's checker colours and the other albedo row with the
    largest gradient must agree within 1e-2 of the entry or 1e-3 of the
    leaf's largest gradient (an albedo scales each path's throughput, so
    the loss is smooth in it). The three mat_param entries with the largest
    gradient are printed beside theirs and not held: the path derivative
    keeps each sampled path's discrete choices fixed (a Fresnel draw, total
    internal reflection, which sphere a ray hits, a fuzzed ray below the
    surface), so in an index of refraction or a fuzz it is not the slope of
    the loss, and the JAX package's gradient is the same
    (tests/test_torch_bounce_ad_ext.py holds the port's to the JAX one's on
    this scene)."""
    pix = torch.arange(w * w, dtype=torch.int32, device=scene.device)

    def loss(p):
        with torch.no_grad():
            summ, nv, _ = bounce_ad.sample_pixel_sums_fused(
                mrt.apply_params(scene, p), pix, 0, spp, width=w, height=w,
                max_bounces=bounces, use_ext=True)
            n = nv[:, None]
            err = torch.where(n > 0, summ / n.clamp_min(1) - target, 0.0)
            return float((err * err).sum() / (w * w * 3.0))

    _, l0, g = step(params, scene, target, 0, 0.0)
    other = g.tex_c0[1:].abs().amax(1).argmax().item() + 1
    entries = [("tex_c0", (0, c)) for c in range(3)] + [("tex_c1", (0, c)) for c in range(3)]
    entries += [("tex_c0", (other, c)) for c in range(3)]
    entries += [("mat_param", (j,)) for j in g.mat_param.abs().argsort(descending=True)[:3].tolist()]
    eps, worst, lines = 1e-2, 0.0, []
    for leaf, idx in entries:
        fd = []
        for sign in (1.0, -1.0):
            q = getattr(params, leaf).clone()
            q[idx] += sign * eps
            fd.append(loss(params._replace(**{leaf: q})))
        fd = (fd[0] - fd[1]) / (2 * eps)
        ad = float(getattr(g, leaf)[idx])
        lines.append(f"{leaf}{list(idx)} {ad:.6g} / {fd:.6g}")
        if leaf != "mat_param":
            scale = float(getattr(g, leaf).abs().max())
            worst = max(worst, abs(ad - fd) / (1e-2 * abs(fd) + 1e-3 * scale))
    print(f"  random_spheres: gradient / central difference (eps {eps}, sample set 0, loss "
          f"{float(l0)}): " + "; ".join(lines) + f"; albedo entries: worst excess {worst:.3g} "
          f"(<= 1 passes); mat_param not held")
    check(worst <= 1.0, "random_spheres: an albedo gradient differs from its central difference")


def ext_train_phases(mrt, bounce, bounce_ad, flash, hybrid, dev, card_line, size=500,
                     small=64):
    """Phases 28-30: B2/B3 in their ext modes, the hybrid-ext scan (at
    `small` x `small`) and `make_train_step(fused_ad="ext")` (at `size` x
    `size`). Returns the rows of the three modes' kernels (forward and
    backward) of the result line."""
    from miniraytracer_tpu_torch.utils import kernels

    A = bounce_ad
    t_phase = time.perf_counter()
    scenes_cpu = {name: ext_scene(mrt, name) for name in EXT_SCENES}
    scenes = {name: scene.to(dev) for name, scene in scenes_cpu.items()}
    # the fifth instance: ext-material with image textures (random_spheres_2;
    # no scene the JAX package trains with fused="ext" takes it)
    scenes["random_spheres_2"] = mrt.scenes.random_spheres_2(1.0).to(dev)
    for name, scene in scenes.items():
        check(A.can_fuse_ad_ext(scene), f"{name} is not in the hybrid-ext class")
    gen = torch.Generator(device=dev).manual_seed(7)

    # 28. each mode against its plain version, launch by launch
    w, spp, bounces = small, 2, 8
    print(f"phase 28: AD step kernels in their ext modes vs plain PyTorch, on states of the "
          f"plain hybrid-ext scan, {w}x{w}, {spp} spp, {bounces} bounces")
    worst = {}
    for name, scene in scenes.items():
        at = (0, 1, 12)
        meta, cfg, tables, images, pix, sb, _, states = ext_states(
            A, hybrid, scene, w, spp, bounces, at, True)
        mode = A.step_mode(meta, True)
        for t in at:
            res_f, res_i, res_k, ext = states[t]
            c = compare_launch(A, (meta, cfg, tables, t), (res_f, res_i, res_k, pix, sb), gen,
                               f"{name} ({mode}) launch {t}", ext, images)
            for key in ("fwd_err", "fwd_rel", "df_err", "df_rel", "dtab_rel"):
                worst[mode, key] = max(worst.get((mode, key), 0.0), c[key])
            same = parent_equal(kernels, "bounce_ad", c["run"]["fwd_k"],
                                f"B2 {name} ({mode}) launch {t}", say=False)
            b3_parent_equal(kernels, c["run"]["bwd_k"], f"B3 {name} ({mode}) launch {t}")
        # the redesigned B3 against the parent's in turns, at this mode's last launch
        print_against_parent(f"B3 {name} ({mode}) launch {at[-1]}, {w}x{w}",
                             against_parent(kernels, "bounce_ad", c["run"]["bwd_k"], 10, rounds=2),
                             card_line)
    print(f"  B2 at those launches in the five modes: "
          f"{'equal to the parent build bit for bit' if same else 'the parent build absent'}")

    print(f"  phase 28 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # 29. the whole scan: kernels vs plain versions, loss and gradients
    print(f"phase 29: hybrid-ext scan, kernels vs plain PyTorch, loss and TrainParams "
          f"gradients, {w}x{w}, {spp} spp, {bounces} bounces")
    probe = mrt.scenes.hybrid_probe(1.0, 80, 200).to(dev)  # 200 triangles: the dense B7
    flash.tri_launches = 0
    compare_scans(mrt, bounce, A, probe, w, w, spp, bounces,
                  "hybrid_probe (80 spheres, 200 triangles)", use_ext=True)
    check(flash.tri_launches > 0, "the 200-triangle probe did not launch B7")
    grads_seen = {}
    for name in EXT_SCENES:
        grads_seen[name] = compare_scans(mrt, bounce, A, scenes[name], w, w, spp, bounces,
                                         name, use_ext=True)
    check("tri_m" in grads_seen["triangles"], "no tri_m gradient on triangles")
    check("sph_c0" in grads_seen["random_spheres"] and "sph_c0" in grads_seen["book2_final"],
          "no sph_c0 gradient on random_spheres or book2_final")
    del scenes["random_spheres_2"]
    print(f"  phase 29 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # 30. make_train_step(fused_ad="ext") at full width
    w, bounces, spp_step = size, 32, 8
    scan_steps, _, _, outer = A.scan_plan(spp_step, bounces, 0, 1)
    print(f"phase 30: make_train_step(fused_ad='ext', {w}x{w}, {bounces} bounces, "
          f"spp_step={spp_step}): scan_steps {scan_steps}, one sub-step a launch, {outer} "
          f"launches each way")
    counters = {"B8 flash_sphere_hit": ("sphere_launches", flash),
                "B13 flash_sphere_hit_gated": ("gated_launches", flash),
                "B10 flash_tri_hit_resident": ("resident_launches", flash),
                "B11 flash_tri_hit_streamed": ("tri_streamed_launches", flash),
                "B7 flash_tri_hit": ("tri_launches", flash)}
    for _, (attr, mod) in counters.items():
        setattr(mod, attr, 0)
    torch.cuda.synchronize()
    A.mode_launches.clear()
    A.fwd_launches = A.bwd_launches = 0
    for name in EXT_SCENES:
        scene_cpu, scene = scenes_cpu[name], scenes[name]
        ne = A.ext_rows(hybrid.pack_scene_hybrid(scene)[0])
        res_bytes = A.residual_bytes(w * w, outer, ne)
        step = mrt.make_train_step(width=w, height=w, max_bounces=bounces, spp_step=spp_step,
                                   fused_ad="ext", scene=scene_cpu)
        before = {k: getattr(mod, attr) for k, (attr, mod) in counters.items()}
        modes_before = A.mode_launches.copy()
        params0 = mrt.extract_params(scene)
        if name == "random_spheres":
            # target: the same scene with another ground checker
            c0, c1 = scene.tex_c0.clone(), scene.tex_c1.clone()
            c0[0] = torch.tensor([0.45, 0.20, 0.10])
            c1[0] = torch.tensor([0.60, 0.60, 0.60])
            target, _ = mrt.render(dataclasses.replace(scene, tex_c0=c0, tex_c1=c1), w, w, 16,
                                   max_bounces=bounces)
            target = target.reshape(-1, 3)
            ext_gradient_check(mrt, A, step, scene, params0, target, w, spp_step, bounces)
            # three steps, then the loss on a held-out sample set (sample
            # index 3), as in phase 7 and at its lr: every albedo (tex_c0,
            # tex_c1) learns; geometry and mat_param keep their values (the
            # path derivative in an index of refraction or a fuzz is not the
            # loss's slope, see ext_gradient_check; the same steps with
            # mat_param learning too are printed after)
            lr, params, losses, t0 = 0.5, params0, [], time.perf_counter()
            for i in range(3):
                new, loss, grads = step(params, scene, target, i, lr)
                new = params0._replace(tex_c0=new.tex_c0, tex_c1=new.tex_c1)
                losses.append(float(loss))
                check(all(torch.isfinite(g).all().item() for g in grads),
                      f"{name} step {i}: grads not finite")
                print(f"    step {i}: loss {losses[-1]}; " + ", ".join(
                    f"{k} max|g| {float(getattr(grads, k).abs().max()):.4g} max|dp| "
                    f"{float((getattr(new, k) - getattr(params, k)).abs().max()):.4g}"
                    for k in ("tex_c0", "tex_c1")))
                params = new
            torch.cuda.synchronize()
            three = time.perf_counter() - t0
            held_first = float(step(params0, scene, target, 3, 0.0)[1])
            held_last = float(step(params, scene, target, 3, 0.0)[1])
            print(f"  {name}: losses of the 3 steps (lr {lr}, every albedo learning) {losses} "
                  f"in {three:.2f} s; held-out sample set 3: loss {held_first} with the first "
                  f"params, {held_last} after 3 updates; ground checker now "
                  f"{params.tex_c0[0].tolist()} / {params.tex_c1[0].tolist()}")
            check(all(np.isfinite(l) for l in losses + [held_first, held_last]), "loss not finite")
            check(held_last < held_first, f"{name}: the held-out loss did not fall")
            p_all = params0
            for i in range(3):
                new = step(p_all, scene, target, i, lr)[0]
                p_all = params0._replace(tex_c0=new.tex_c0, tex_c1=new.tex_c1,
                                         mat_param=new.mat_param)
            moved = (p_all.mat_param - params0.mat_param).abs()
            print(f"    the same 3 steps with mat_param learning too (not held): held-out loss "
                  f"{float(step(p_all, scene, target, 3, 0.0)[1])}; mat_param moved by up to "
                  f"{float(moved.max()):.4g} (entry {int(moved.argmax())})")
        else:
            target = torch.full((w * w, 3), 0.25, device=dev)
            t_warm = time.perf_counter()
            _, loss, grads = step(params0, scene, target, 0, 0.0)  # warm
            check(torch.isfinite(loss).item() and all(torch.isfinite(g).all().item()
                                                      for g in grads),
                  f"{name}: loss or grads not finite")
            warm_s = time.perf_counter() - t_warm
        one_step = lambda: step(params0, scene, target, 0, 0.0)
        # one warm step where a step takes seconds (book2's box sweep)
        step_ms = cuda_ms(one_step, 1 if name != "random_spheres" and warm_s > 3.0 else 2)
        launched = {k: getattr(mod, attr) - before[k] for k, (attr, mod) in counters.items()}
        modes = {f"{d}[{m}]": c - modes_before.get((d, m), 0)
                 for (d, m), c in A.mode_launches.items() if c - modes_before.get((d, m), 0)}
        grads = one_step()[2]
        check(all(torch.isfinite(g).all().item() for g in grads), f"{name}: grads not finite")
        pix = torch.arange(w * w, dtype=torch.int32, device=dev)
        with torch.no_grad():
            _, nv, rays = A.sample_pixel_sums_fused(scene, pix, 0, spp_step, width=w, height=w,
                                                    max_bounces=bounces, use_ext=True)
        rays = int(rays)
        done_frac = float(nv.sum()) / (w * w * spp_step)
        med = statistics.median(step_ms)
        print(f"  {name}: step {med:.1f} ms (median of {len(step_ms)} warm; runs {step_ms}); "
              f"rays {rays}; "
              f"done_frac {done_frac:.4f}; fwd+bwd {rays / (med / 1e3) / 1e6:.2f} Mrays/s; "
              f"residual {res_bytes / 1e9:.2f} GB; grads finite; on {card_line}")
        print(f"    launches in its steps: "
              + ", ".join(f"{k} {v}" for k, v in {**modes, **launched}.items() if v))
        wall, busy, by_name = device_share(one_step)
        print(f"    one step under torch.profiler: wall {wall:.1f} ms, device busy {busy:.1f} ms "
              f"(idle share {max(0.0, 1 - busy / wall):.3f}), "
              f"{sum(c for _, c in by_name.values())} launches on the device")
        # the candidate's share: all but B2/B3 (the sweeps, the record
        # assembly, the replay and its autograd backward), beside the bytes
        # its record work must move a scan step: a lane reads its ray (ro, rd,
        # time, inside, alive: 9 words) and its winner's rows (geometry,
        # material, texture: ~22 words) and writes NE rows; the replay reads
        # the same again and d_ext (NE) and writes the rays' cotangent (7)
        cand = [(ms, c) for k, (ms, c) in by_name.items() if "ad_step_" not in k]
        cand_bound, _ = bound(4 * w * w * (2 * (9 + 22 + ne) + ne + 7), 0)
        print(f"    the candidate and its replay (all but B2/B3): "
              f"{sum(ms for ms, _ in cand) / outer:.3f} ms of device time and "
              f"{sum(c for _, c in cand) / outer:.0f} launches a scan step; the byte bound of "
              f"its record work {cand_bound:.4f} ms a step")
        for kname, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
            print(f"      {ms:8.2f} ms  {100 * ms / busy:5.1f}%  x{count:<5d} {kname[:90]}")
    launches = dict(A.mode_launches)
    print(f"  main path launches: B2/B3 by mode {launches}; "
          + ", ".join(f"{k} {getattr(mod, attr)}" for k, (attr, mod) in counters.items()))
    for mode in EXT_MODES:
        check(launches.get(("fwd", mode), 0) > 0 and launches.get(("bwd", mode), 0) > 0,
              f"the train steps did not launch B2/B3[{mode}]")
    check(launches.get(("fwd", "fused"), 0) == 0, "a hybrid-ext step launched the fused mode")

    print(f"  phase 30's train steps took {time.perf_counter() - t_phase:.1f} s")

    # one launch of each mode at full width against plain, timed in turns,
    # on the state of step outer // 4 of the kernel scan
    rows = []
    for mode, name in (("ext", "triangles"), ("ext_mat", "random_spheres"), ("image", "earth")):
        t_mid = outer // 4
        meta, cfg, tables, images, pix, sb, _, states = ext_states(
            A, hybrid, scenes[name], w, spp_step, bounces, (t_mid,), False)
        res_f, res_i, res_k, ext = states[t_mid]
        c = compare_launch(A, (meta, cfg, tables, t_mid), (res_f, res_i, res_k, pix, sb), gen,
                           f"{name} ({mode}) {w}x{w} launch {t_mid}", ext, images)
        run, n = c["run"], w * w
        ms = {key: [] for key in run}
        for key in ("fwd_p", "fwd_k", "fwd_k", "fwd_p", "bwd_p", "bwd_k", "bwd_k", "bwd_p"):
            reps = 5 if key.endswith("_k") else 1
            ms[key].append(cuda_ms(lambda: [run[key]() for _ in range(reps)], 1)[0] / reps)
        ne = A.ext_rows(meta)
        table_bytes = 4 * sum(t.numel() for t in tables)
        ops = step_ops_per_ray(meta)
        b2_bound, b2_by = bound(4 * n * (48 + ne) + table_bytes, c["rays"] * ops)
        b3_bound, b3_by = bound(4 * n * (57 + 2 * ne) + table_bytes, c["rays"] * 2 * ops)
        print(f"    {c['rays']} rays: B2[{mode}] kernel {ms['fwd_k']} ms, plain {ms['fwd_p']} ms; "
              f"B3[{mode}] kernel {ms['bwd_k']} ms, plain {ms['bwd_p']} ms; bounds B2 "
              f"{b2_bound:.4f} ms by {b2_by}, B3 {b3_bound:.4f} ms by {b3_by} "
              f"({ops} operations a ray forward) on {card_line}")
        common = {"route": "cuda", "source": "miniraytracer_tpu_torch/csrc/bounce_ad.cu",
                  "library_ms": None}
        rows += [
            {"name": f"ad_step_fwd[{mode}]", "replaces": "miniraytracer_tpu/ops/bounce_ad.py:219",
             "launches": launches.get(("fwd", mode), 0),
             "max_abs_err": max(worst[mode, "fwd_err"], c["fwd_err"]),
             "max_rel_lane_err": max(worst[mode, "fwd_rel"], c["fwd_rel"]),
             "lanes_agreeing": c["agree"],
             "ms": statistics.mean(ms["fwd_k"]), "plain_ms": statistics.mean(ms["fwd_p"]),
             "bound_ms": b2_bound, "bound_by": b2_by, **common},
            {"name": f"ad_step_bwd[{mode}]", "replaces": "miniraytracer_tpu/ops/bounce_ad.py:276",
             "launches": launches.get(("bwd", mode), 0),
             "max_abs_err": max(worst[mode, "df_err"], c["df_err"]),
             "err_scale": c["df_scale"],
             "max_rel_lane_err": max(worst[mode, "df_rel"], c["df_rel"]),
             "lanes_agreeing": c["df_close"],
             "ms": statistics.mean(ms["bwd_k"]), "plain_ms": statistics.mean(ms["bwd_p"]),
             "bound_ms": b3_bound, "bound_by": b3_by, **common},
        ]
        del run, c["run"], states
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# The scan AD paths (fused_ad=False) and the progressive renderer
# ---------------------------------------------------------------------------

# the sweeps the scan paths launch, by kernel: (counter, result row's name)
SCAN_COUNTERS = {"B8": ("sphere_launches", "flash_sphere_hit"),
                 "B13": ("gated_launches", "flash_sphere_hit_gated"),
                 "B12": ("streamed_launches", "flash_sphere_hit_streamed"),
                 "B10": ("resident_launches", "flash_tri_hit_resident"),
                 "B11": ("tri_streamed_launches", "flash_tri_hit_streamed"),
                 "B7": ("tri_launches", "flash_tri_hit")}


def sweep_counts(flash):
    return {k: getattr(flash, attr) for k, (attr, _) in SCAN_COUNTERS.items()}


def tensors_of(obj):
    """The tensors of a nest of tuples (PackedState, V3) in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in tensors_of(o)]
    return []


def scan_loss_grads(mrt, train, scene, w, bounces, pack, spp_step, plain, remat_calls=None):
    """`train.scan_loss` (the loss of make_train_step(fused_ad=False)) of the
    scene's TrainParams against a flat grey target, and its gradient for
    every leaf. With `remat_calls`, a list, each rematerialised scan step's
    (fn, args, outputs) is appended to it."""
    from miniraytracer_tpu_torch.models import integrator

    leaves = mrt.TrainParams(*(p.detach().clone().requires_grad_(True)
                               for p in mrt.extract_params(scene)))
    target = torch.full((w * w, 3), 0.25, device=scene.device)
    offsets = integrator.sample_offsets(64, device=scene.device)[0]
    real = integrator._remat

    def recording(remat, fn, *args):
        out = real(remat, fn, *args)
        if remat:
            remat_calls.append((fn, args, [t.detach() for t in tensors_of(out)]))
        return out

    stats = {}
    integrator._remat = real if remat_calls is None else recording
    try:
        loss = train.scan_loss(mrt.apply_params(scene, leaves), target, 0, offsets, width=w,
                               height=w, max_bounces=bounces, pack=pack, spp_step=spp_step,
                               plain=plain, stats=stats)
    finally:
        integrator._remat = real
    grads = torch.autograd.grad(loss, list(leaves), allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)], stats


def scan_phases(mrt, flash, dev, card_line, refs, size=500, small=64):
    """Phases 31-33: the scan AD paths, kernels against plain versions (at
    `small` x `small`); `make_train_step(fused_ad=False)` at `size` x
    `size`, beside the hybrid-ext step and the fused step; the progressive
    renderer against the reference renderer's frames. Returns the scan
    path's launches of each sweep kernel it ran, by result row's name: a
    phase-32 step's ("scan_step_launches") and a phase-31 loss and gradient
    at `small` x `small` on the scene that runs it ("scan_launches_small")."""
    from miniraytracer_tpu_torch.models import integrator
    from miniraytracer_tpu_torch.parallel import train

    t_phase = time.perf_counter()
    # 31. kernels against plain versions, loss, gradients and the recompute
    w, bounces, pack, spp_step = small, 8, 8, 2
    print(f"phase 31: packed scan (make_train_step(fused_ad=False)'s loss), kernels vs plain "
          f"PyTorch, {w}x{w}, {bounces} bounces, pack={pack}, spp_step={spp_step}")
    small_launches = {}
    probes = {"random_spheres_2": ("B8", mrt.scenes.random_spheres_2(1.0)),
              "triangles (stand-in meshes)": ("B10", triangles_scene(mrt)),
              "book2_final": ("B13", mrt.scenes.book2_final(1.0)),
              # no scene of nine routes the scans to B7 or B12
              "hybrid_probe (80 spheres, 200 triangles)": (
                  "B7", mrt.scenes.hybrid_probe(1.0, 80, 200)),
              "hybrid_probe (5000 spheres)": ("B12", mrt.scenes.hybrid_probe(1.0, 5000, 0))}
    for name, (kernel, scene) in probes.items():
        scene = scene.to(dev)
        before = sweep_counts(flash)
        calls = []
        lk, gk, sk = scan_loss_grads(mrt, train, scene, w, bounces, pack, spp_step, False, calls)
        launched = {k: v - before[k] for k, v in sweep_counts(flash).items() if v > before[k]}
        lp, gp, sp = scan_loss_grads(mrt, train, scene, w, bounces, pack, spp_step, True)
        worst, seen = 0.0, []
        for leaf, a, b in zip(mrt.TrainParams._fields, gk, gp):
            check(torch.isfinite(a).all().item(), f"{name}: grad {leaf} not finite")
            if b.numel() and float(b.abs().max()) > 0:
                seen.append(leaf)
            scale = max(float(b.abs().max()) if b.numel() else 0.0, 1e-3)
            if b.numel():
                worst = max(worst, ((a - b).abs() - 5e-3 * b.abs()).max().item() / (5e-4 * scale))
        # the recompute: steps 0, the middle one and the last run again as the
        # backward runs them, every output equal to the forward's to the bit
        same = True
        for j in sorted({0, len(calls) // 2, len(calls) - 1}):
            fn, args, out = calls[j]
            with torch.enable_grad():
                again = [t.detach() for t in tensors_of(fn(*args))]
            same &= len(again) == len(out) and all(torch.equal(a, b) for a, b in zip(again, out))
        del calls
        rk, rp = int(sk["rays"]), int(sp["rays"])
        print(f"  {name}: rays kernel {rk} plain {rp}, done {int(sk['done'])} of "
              f"{w * w * spp_step}; loss kernel {float(lk):.7g} plain {float(lp):.7g}; grads of "
              f"{', '.join(seen)}: worst excess over rtol 5e-3 / atol 5e-4*scale {worst:.3g} "
              f"(<= 1 passes); recompute of steps 0, mid, last equal to the forward bit for bit: "
              f"{same}; sweeps launched {launched}")
        check(launched.get(kernel, 0) > 0, f"{name}: the scan did not launch {kernel}")
        small_launches[kernel] = launched.get(kernel, 0)
        check(abs(rk - rp) <= 1e-3 * rp, f"{name}: ray counts differ by more than 0.1%")
        check(abs(float(lk) - float(lp)) <= 1e-4 * abs(float(lp)), f"{name}: losses differ")
        check(worst <= 1.0, f"{name}: TrainParams grads differ from plain")
        check(same, f"{name}: the recompute differs from the forward")
        check("sph_c0" in seen or "tri_m" in seen, f"{name}: no geometry gradient")
    print(f"  phase 31 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # 32. the JAX package's AD protocol (benchmarks/ad_scenes.py) at full width
    w, bounces, pack, spp_step = size, 32, 16, 8
    scan_steps = pack * 6 + bounces + 1
    n_items = w * w * spp_step
    print(f"phase 32: make_train_step(random_spheres_2, {w}x{w}, {bounces} bounces, "
          f"fused_ad=False, pack={pack}, spp_step={spp_step}): {n_items} items, "
          f"{n_items // pack} lanes, {scan_steps} scan steps")
    scene_cpu = mrt.scenes.random_spheres_2(1.0)
    scene = scene_cpu.to(dev)
    params0 = mrt.extract_params(scene)
    target = torch.full((w * w, 3), 0.25, device=dev)
    scan_launches = {}

    def protocol(label, step, items):
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = sweep_counts(flash)
        t0 = time.perf_counter()
        _, loss, grads = step(params0, scene, target, 0, 0.0, stats=stats)
        torch.cuda.synchronize()
        warm_ms = 1e3 * (time.perf_counter() - t0)
        launched = {k: v - before[k] for k, v in sweep_counts(flash).items() if v > before[k]}
        peak = torch.cuda.max_memory_allocated()
        finite = torch.isfinite(loss).item() and all(torch.isfinite(g).all().item()
                                                     for g in grads)
        rays, done = int(stats["rays"]), int(stats["done"])
        one_step = lambda: step(params0, scene, target, 0, 0.0)
        # after the warm step, two timed ones, or one where a step takes over 20 s
        step_ms = cuda_ms(one_step, 1 if warm_ms > 20e3 else 2)
        med = statistics.median(step_ms)
        wall, busy, by_name = device_share(one_step)
        print(f"  {label}: step {med:.1f} ms (median of {len(step_ms)} after the warm step; "
              f"runs {step_ms}; the warm step {warm_ms:.1f} ms); rays "
              f"{rays}; fwd+bwd {rays / (med / 1e3) / 1e6:.3f} Mrays/s; done_frac "
              f"{done / items:.5f}; peak memory {peak / 2**30:.2f} GiB; every gradient finite: "
              f"{finite}; sweeps launched a step {launched}; on {card_line}")
        print(f"    one step under torch.profiler: wall {wall:.1f} ms, device busy {busy:.1f} ms "
              f"(idle share {max(0.0, 1 - busy / wall):.3f}), "
              f"{sum(c for _, c in by_name.values())} launches on the device")
        for kname, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]:
            print(f"      {ms:8.2f} ms  {100 * ms / busy:5.1f}%  x{count:<6d} {kname[:80]}")
        check(finite, f"{label}: loss or gradients not finite")
        return launched, loss, grads

    step = mrt.make_train_step(width=w, height=w, max_bounces=bounces, fused_ad=False,
                               pack=pack, spp_step=spp_step)
    launched, _, _ = protocol("packed scan", step, n_items)
    check(launched.get("B8", 0) == 2 * scan_steps,
          "the packed scan did not launch B8 once a scan step and once in its recompute")
    scan_launches.update(launched)
    step_ext = mrt.make_train_step(width=w, height=w, max_bounces=bounces, spp_step=spp_step,
                                   fused_ad="ext", scene=scene_cpu)
    protocol("hybrid-ext step (fused_ad='ext', the same protocol)", step_ext, n_items)
    del step, step_ext
    torch.cuda.empty_cache()

    # the Cornell cross-check: the fused step against the packed scan on the
    # same items (sample 0 of every pixel at offset 0), a scan long enough
    # for every item
    cornell = mrt.scenes.cornell_box(1.0).to(dev)
    pack_c, steps_c = 8, 8 * (bounces + 1) + 2
    print(f"  Cornell {w}x{w}, {bounces} bounces, spp_step=1: fused_ad=True against "
          f"fused_ad=False, pack={pack_c}, scan_steps={steps_c}")
    target_c = torch.full((w * w, 3), 0.25, device=dev)
    out = {}
    for label, kw in (("fused", dict(fused_ad=True)),
                      ("packed", dict(fused_ad=False, pack=pack_c, scan_steps=steps_c))):
        st = {}
        stc = mrt.make_train_step(width=w, height=w, max_bounces=bounces, spp_step=1, **kw)
        t0 = time.perf_counter()
        _, loss, grads = stc(mrt.extract_params(cornell), cornell, target_c, 0, 0.0, stats=st)
        torch.cuda.synchronize()
        out[label] = (loss, grads, int(st["done"]), int(st["rays"]),
                      1e3 * (time.perf_counter() - t0))
    (lf, gf, df, rf, tf), (lq, gq, dq, rq, tq) = out["fused"], out["packed"]
    worst = 0.0
    for a, b in zip(gf, gq):
        if b.numel():
            scale = max(float(b.abs().max()), 1e-3)
            worst = max(worst, ((a - b).abs() - 1e-2 * b.abs()).max().item() / (1e-2 * scale))
    print(f"    loss fused {float(lf):.7g} packed {float(lq):.7g} (rel diff "
          f"{abs(float(lf) - float(lq)) / float(lq):.3g}); samples done {df} / {dq} of {w * w}; "
          f"rays {rf} / {rq}; step {tf:.1f} / {tq:.1f} ms (first calls); grads worst excess over "
          f"rtol 1e-2 / atol 1e-2*scale {worst:.3g} (<= 1 passes)")
    check(df == dq == w * w, "Cornell cross-check: a sample was not done")
    check(abs(float(lf) - float(lq)) <= 1e-3 * float(lq), "Cornell cross-check: losses differ")
    check(worst <= 1.0, "Cornell cross-check: gradients differ")
    del out, gf, gq
    torch.cuda.empty_cache()
    print(f"  phase 32 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # 33. the progressive renderer against the reference renderer's frames,
    # at phases 4's and 21's tolerances, and one timed frame
    print("phase 33: render_progressive vs reference renderer, 100x100, 16 spp, 16 bounces")
    for name, tol in (("cornell_box", PARITY_TOL["cornell_box"]), ("random_spheres_2", 0.02)):
        before = sweep_counts(flash)
        frame, st = mrt.render_progressive(getattr(mrt.scenes, name)(1.0), 100, 100, 16,
                                           max_bounces=16)
        launched = {k: v - before[k] for k, v in sweep_counts(flash).items() if v > before[k]}
        ours = frame.cpu().numpy()
        check(np.isfinite(ours).all() and frame.is_cuda, f"{name}: frame not finite")
        ref_mean = refs[name].mean(axis=(0, 1))
        rel = np.abs(ref_mean - ours.mean(axis=(0, 1))) / np.maximum(ref_mean, 1e-6)
        print(f"  {name}: channel means rel diff {rel.max():.4f} (tolerance {tol}), rays "
              f"{st['rays']}, sweeps launched {launched}")
        check(rel.max() < tol, f"{name}: progressive reference parity")
    cornell_cpu = mrt.scenes.cornell_box(1.0)
    mrt.render_progressive(cornell_cpu, w, w, 1, max_bounces=bounces)  # warm
    frame, st = mrt.render_progressive(cornell_cpu, w, w, 16, max_bounces=bounces)
    check(torch.isfinite(frame).all().item(), "progressive Cornell frame not finite")
    print(f"  render_progressive(cornell_box, {w}, {w}, 16, max_bounces={bounces}): "
          f"{1e3 * st['seconds']:.1f} ms, {st['rays']} rays, {st['mrays_per_s']:.2f} Mrays/s on "
          f"{card_line}")
    print(f"  phase 33 took {time.perf_counter() - t_phase:.1f} s")
    rows = {}
    for key, field in ((scan_launches, "scan_step_launches"),
                       (small_launches, "scan_launches_small")):
        for k, v in key.items():
            rows.setdefault(SCAN_COUNTERS[k][1], {})[field] = v
    return rows


# ---------------------------------------------------------------------------
# The reference renderer's 64-spp frames
# ---------------------------------------------------------------------------

# tests/test_reference_parity.py CASES_64: the JAX package's work queue at the
# archive's own 64 spp, channel means within these bounds
PARITY_TOL_64 = {"random_spheres": 0.005, "two_spheres": 0.001, "perlin_spheres": 0.003,
                 "cornell_box": 0.005, "cornell_smoke": 0.003}


def reference_gate(mrt, dev, refs):
    """Phase 27: `render_workqueue(scene, 100, 100, 64, max_bounces=16)` on
    the five scenes that need no asset file, channel means against the
    reference renderer's frames within PARITY_TOL_64. Returns no row."""
    print("phase 27: work queue vs reference renderer, 100x100, 64 spp, 16 bounces")
    misses = []
    for name, tol in PARITY_TOL_64.items():
        frame, st = mrt.render_workqueue(getattr(mrt.scenes, name)(1.0).to(dev), 100, 100, 64,
                                         max_bounces=16)
        ours = frame.cpu().numpy()
        check(np.isfinite(ours).all(), f"{name}: frame not finite")
        ref_mean = refs[name].mean(axis=(0, 1))
        rel = np.abs(ref_mean - ours.reshape(-1, 3).mean(axis=0)) / np.maximum(ref_mean, 1e-6)
        print(f"  {name}: channel means rel diff {rel.max():.5f} (bound {tol}), {st['rays']} rays")
        if rel.max() >= tol:
            misses.append(name)
    check(not misses, f"reference parity at 64 spp missed on {misses}")
    return []


# ---------------------------------------------------------------------------
# The command line (phase 34) and the BVH walk (phase 35)
# ---------------------------------------------------------------------------

# each kernel row's launch counter: (module, attribute)
KERNEL_COUNTERS = {
    "fused_render": ("bounce", "launches"), "flash_tri_hit": ("flash", "tri_launches"),
    "flash_sphere_hit": ("flash", "sphere_launches"),
    "flash_sphere_hit_gated": ("flash", "gated_launches"),
    "flash_sphere_hit_streamed": ("flash", "streamed_launches"),
    "flash_tri_hit_culled": ("flash", "culled_launches"),
    "flash_tri_hit_resident": ("flash", "resident_launches"),
    "flash_tri_hit_streamed": ("flash", "tri_streamed_launches"),
    "hybrid_step": ("hybrid", "step_launches"), "shade_step": ("hybrid", "shade_launches"),
    "flash_turbulence": ("noise", "launches")}


def cli_phases(mrt, bounce, flash, hybrid, noise, card_line, size=500, bounces=32,
               timeout=600):
    """Phase 34: `python -m miniraytracer_tpu_torch` at the JAX package's
    default path (-scene 8, the triangles scene with the stand-in meshes,
    progressive, 500x500, 32 bounces; 4 samples to keep the time) once as a
    subprocess, then `cli.main` in this process with each renderer at
    500x500 and 32 bounces, and a resume from the subprocess's pass-2
    checkpoint whose frame must equal the subprocess's own to the bit.
    Returns {kernel row name: launches over the runs in this process}."""
    import io
    import shutil
    import sys
    import tempfile

    from miniraytracer_tpu_torch import cli
    from miniraytracer_tpu_torch.utils import checkpoint, tonemap
    from miniraytracer_tpu_torch.utils.image import read_png, save_png

    mods = {"bounce": bounce, "flash": flash, "hybrid": hybrid, "noise": noise}
    total = dict.fromkeys(KERNEL_COUNTERS, 0)
    common = ["-width", str(size), "-height", str(size), "-depth", str(bounces)]
    print(f"phase 34: the command line at {size}x{size}, {bounces} bounces")
    with stand_in_assets(mrt) as assets, tempfile.TemporaryDirectory() as tmp:
        out = lambda name: os.path.join(tmp, name)
        # the JAX package's defaults but the sample count, as a user runs it;
        # its pass-2 checkpoint is copied as soon as the line that says it was
        # written comes (pass 3 takes seconds), for the resume below
        argv = [sys.executable, "-u", "-m", "miniraytracer_tpu_torch", "-scene", "8", *common,
                "-samples", "4", "-checkpoint", out("ck"), "-checkpoint-every", "2",
                "-out", out("sub.png")]
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, env=dict(os.environ, MRT_ASSETS=assets))
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                if line.startswith("checkpoint -> ") and not os.path.exists(out("ck2.npz")):
                    shutil.copy(out("ck.npz"), out("ck2.npz"))
            rc = proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        sub_s = time.perf_counter() - t0
        print("\n".join(f"    | {line}" for line in lines))
        check(rc == 0, f"python -m miniraytracer_tpu_torch exited {rc}")
        check(any("Mrays/s" in line and line.startswith("done in") for line in lines),
              "no Mrays/s line")
        check(read_png(out("sub.png")).shape == (size, size, 3), "the PNG is not 500x500 RGB")
        sub_frame, sub_pass, _ = checkpoint.load_checkpoint(out("ck"))
        check(sub_pass == 4 and checkpoint.load_checkpoint(out("ck2"))[1] == 2,
              "the checkpoints are not those of passes 4 and 2")
        print(f"  the subprocess (-scene 8 -samples 4, progressive): exit 0 in {sub_s:.1f} s, its "
              f"start and the kernels' load included; a {size}x{size} PNG; launches not visible "
              f"across processes; on {card_line}")

        runs = [("auto", ["-renderer", "auto", "-scene", "5", "-samples", "64"],
                 ("fused_render",)),
                ("hybrid", ["-renderer", "hybrid", "-scene", "0", "-samples", "16"],
                 ("flash_sphere_hit", "hybrid_step")),
                ("workqueue", ["-renderer", "workqueue", "-scene", "7", "-samples", "16"],
                 ("flash_sphere_hit_gated", "shade_step")),
                ("wavefront", ["-renderer", "wavefront", "-scene", "5", "-samples", "4"],
                 ("fused_render",)),
                ("wavefront_eager", ["-renderer", "wavefront", "-scene", "4", "-samples", "4"],
                 ()),
                ("progressive", ["-scene", "1", "-samples", "4"],
                 ("flash_sphere_hit", "flash_turbulence")),
                ("resume", ["-scene", "8", "-samples", "4", "-resume", out("ck2"), "-checkpoint",
                            out("ck3"), "-checkpoint-every", "2"], ("flash_tri_hit_resident",))]
        for label, flags, expect in runs:
            torch.cuda.synchronize()
            for mod, attr in KERNEL_COUNTERS.values():
                setattr(mods[mod], attr, 0)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(flags + common + ["-out", out(f"{label}.png")])
            seconds = time.perf_counter() - t0
            launched = {name: getattr(mods[mod], attr)
                        for name, (mod, attr) in KERNEL_COUNTERS.items()}
            text = buf.getvalue().splitlines()
            print("\n".join(f"    | {line}" for line in text))
            done = [line for line in text if line.startswith("done in")]
            check(rc == 0 and done and "Mrays/s" in done[0], f"{label}: no Mrays/s line")
            check(all(launched[k] > 0 for k in expect),
                  f"{label}: launched {launched}, expected {expect}")
            check(read_png(out(f"{label}.png")).shape == (size, size, 3), f"{label}: the PNG")
            for k, v in launched.items():
                total[k] += v
            print(f"  {label} ({' '.join(flags[:4])}): {seconds:.2f} s in cli.main, "
                  f"{done[0].split('  ')[1]}, launches "
                  f"{ {k: v for k, v in launched.items() if v} } on {card_line}")

        # auto is B1: its PNG is save_png(drago(render(...))) of the same frame
        frame, _ = mrt.render(mrt.scenes.cornell_box(1.0), size, size, 64, max_bounces=bounces)
        save_png(out("direct.png"), tonemap.drago(frame).cpu().numpy())
        with open(out("auto.png"), "rb") as a, open(out("direct.png"), "rb") as b:
            check(a.read() == b.read(), "-renderer auto's PNG differs from save_png(drago(render))")
        resumed = checkpoint.load_checkpoint(out("ck3"))[0]
        check(np.array_equal(resumed.view(np.int32), sub_frame.view(np.int32)),
              "the resumed frame differs from the straight run's")
        print("  auto's PNG equals save_png(drago(mrt.render(cornell_box, 500, 500, 64))) byte "
              "for byte; the frame resumed from the subprocess's pass-2 checkpoint equals its "
              "straight run's to the bit")
    return total


def bvh_phase(bounce, flash, card_line, keep):
    """Phase 35: the BVH (`ops/bvh.py`) over the triangles scene with the
    stand-in meshes, on the rays of phase 23's queue step 2: the host build
    timed, the walk against B10 (unseeded) on the same rays (hit sets equal
    but for at most 1 ray in 10,000, where a ray grazes a cluster's or a
    node's box; t within rtol 1e-5 and atol 1e-3 where both hit; the winner
    equal on 99.9% of the common hits, the rest ties), both timed. Returns
    the walk's numbers for B10's row."""
    from miniraytracer_tpu_torch.ops import bvh
    from miniraytracer_tpu_torch.ops import intersect as ix

    scene, cull = keep["scene"], keep["cull"]
    ro, rd, time_, inside, alive = keep["rays"]
    print(f"phase 35: the BVH walk against B10 on the {alive.numel()} rays of the triangles "
          f"scene's queue step 2 ({scene.n_tris} stand-in triangles)")
    t0 = time.perf_counter()
    tree = bvh.build_tri_bvh(scene)
    build_ms = 1e3 * (time.perf_counter() - t0)
    rays = ix.Rays(ro=ro, rd=rd, time=time_, inside=inside)
    walk = lambda st=None: bvh.bvh_tri_hit(tree, scene, rays, stats=st)
    b10 = lambda: flash.flash_tri_hit_resident(cull, ro, rd, inside, bounce.TMIN)
    stats, res = {}, []
    warm_ms = cuda_ms(lambda: res.append(walk(stats)), 1)[0]
    (t_w, i_w), (t_k, i_k) = res[0], b10()
    hit_w, hit_k = t_w < 3e38, t_k < 3e38
    off = hit_w != hit_k
    both = hit_w & hit_k
    close = (t_w[both] - t_k[both]).abs() <= 1e-3 + 1e-5 * t_k[both].abs()
    same = float((i_w[both] == i_k[both]).float().mean())
    print(f"  build on the host {build_ms:.1f} ms: {tree.bmin.shape[0]} nodes, leaves of "
          f"{tree.leaf_size}; {int(alive.sum())} rays alive, {int(hit_w.sum())} hits (B10 "
          f"{int(hit_k.sum())}), {int(off.sum())} differ in hit, max |dt| "
          f"{float((t_w[both] - t_k[both]).abs().max()):.3g} where both hit, winner equal on "
          f"{same:.6f} of the common hits")
    check(float(off.float().mean()) <= 1e-4 and bool(close.all()) and same >= 0.999
          and not bool(hit_w[~alive].any()), "the BVH walk disagrees with B10")
    wall, busy, by_name = device_share(walk)
    launches = sum(count for _, count in by_name.values())
    walk_ms = cuda_ms(walk, 1)[0]
    b10_ms = cuda_ms(b10, 3)
    print(f"  the walk: warm call {warm_ms:.1f} ms, timed call {walk_ms:.1f} ms, {stats['steps']} "
          f"steps (one host read each), {launches} launches a call (device busy {busy:.1f} ms "
          f"of {wall:.1f} under the profiler); B10 through its wrapper {b10_ms} ms; on "
          f"{card_line}")
    return {"build_host_ms": build_ms, "nodes": tree.bmin.shape[0], "warm_ms": warm_ms,
            "ms": walk_ms, "steps": stats["steps"], "launches_a_call": launches,
            "device_busy_ms": busy, "b10_wrapper_ms": statistics.median(b10_ms),
            "rays": alive.numel(), "hits": int(hit_w.sum()), "hits_differ": int(off.sum())}


# ---------------------------------------------------------------------------
# The device-parallel layer (phases 36-37)
# ---------------------------------------------------------------------------

# the counters of every kernel row the mesh runs reach
MESH_COUNTERS = {**KERNEL_COUNTERS, "ad_step_fwd": ("bounce_ad", "fwd_launches"),
                 "ad_step_bwd": ("bounce_ad", "bwd_launches")}
# what each run must launch on every rank: B1; B2 and B3; B13 and B6
MESH_EXPECT = {"wavefront": ("fused_render",), "progressive": (),
               "workqueue": ("flash_sphere_hit_gated", "flash_turbulence"),
               "train": ("ad_step_fwd", "ad_step_bwd")}
MESH_SIZE, MESH_BOUNCES = 500, 32


def mesh_counted(fn):
    """fn() with every kernel's launch count set to 0 just before and read
    just after: (its result, wall seconds to the device's end, {row name:
    launches})."""
    from miniraytracer_tpu_torch.ops import bounce, bounce_ad, flash, hybrid, noise

    mods = {"bounce": bounce, "bounce_ad": bounce_ad, "flash": flash, "hybrid": hybrid,
            "noise": noise}
    torch.cuda.synchronize()
    for mod, attr in MESH_COUNTERS.values():
        setattr(mods[mod], attr, 0)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, {name: getattr(mods[mod], attr)
                          for name, (mod, attr) in MESH_COUNTERS.items()}


def mesh_scan_steps():
    """The scan length of phase 37's train steps: twice the default of a
    128-sample step (`scan_plan(128, 32)`, 801 sub-steps). The scan claims
    samples only before a gate that scales with spp_step, so the default
    scans drop a few samples (1,092 of 32,000,000 at 128 a pixel, more at 64
    a cell), a different few for each split; in this scan every sample
    completes, and the meshes and the one device train on the same set."""
    from miniraytracer_tpu_torch.ops import bounce_ad

    return 2 * bounce_ad.scan_plan(128, MESH_BOUNCES)[0]


def mesh_workloads(mrt, render, mesh, target, stats):
    """The runs of phase 37 on `mesh`, by name: the Cornell wavefront through
    B1 at 500x500x64x32, the progressive render of two_spheres at 500x500x4,
    the work queue of book2_final at 500x500x4x32 (B13, B6) and the Cornell
    train step at 500x500x32 (B2, B3) from the scene's params against
    `target`, 128 // n_sp samples a cell in a scan of `mesh_scan_steps()`,
    its "rays" and "done" into `stats`."""
    n, b = MESH_SIZE, MESH_BOUNCES
    cornell = mrt.scenes.cornell_box(1.0)
    step = mrt.make_train_step(width=n, height=n, max_bounces=b, spp_step=128 // mesh.n_sp,
                               scan_steps=mesh_scan_steps(), mesh=mesh)
    return {
        "wavefront": lambda: render.render_wavefront_distributed(cornell, n, n, 64, mesh,
                                                                 max_bounces=b),
        "progressive": lambda: render.render_distributed(mrt.scenes.two_spheres(1.0), n, n, 4,
                                                         mesh, max_bounces=b),
        "workqueue": lambda: render.render_workqueue_distributed(mrt.scenes.book2_final(1.0), n,
                                                                 n, 4, mesh, max_bounces=b),
        "train": lambda: step(mrt.extract_params(cornell), cornell, target, 0, 0.5,
                              stats=stats)}


def mesh_rank(rank, world, port, n_dp, n_sp, tmp):
    """One rank of a phase-37 mesh: a gloo group of `world` ranks, every one on
    cuda:0; runs `mesh_workloads` and saves what each returned."""
    t0 = time.perf_counter()
    import miniraytracer_tpu_torch as mrt
    from miniraytracer_tpu_torch.parallel import mesh as M
    from miniraytracer_tpu_torch.parallel import render

    mesh = M.init_distributed(f"localhost:{port}", world, rank, backend="gloo", device="cuda:0",
                              timeout=600)
    if (mesh.n_dp, mesh.n_sp) != (n_dp, n_sp):
        mesh = M.make_mesh(n_dp, n_sp, device="cuda:0")
    # gloo's all_reduce on CUDA tensors, as every sum of the mesh is one
    f = torch.full((3,), rank + 1.0, device=mesh.device)
    i = torch.full((3,), rank + 1, dtype=torch.int64, device=mesh.device)
    mesh.all_reduce(f, "world")
    mesh.all_reduce(i, "world")
    want = world * (world + 1) // 2
    check(f.is_cuda and i.is_cuda and bool((f == want).all()) and bool((i == want).all()),
          f"rank {rank}: gloo's all_reduce on CUDA tensors gave {f.tolist()}, {i.tolist()}")
    print(f"rank {rank} of {world}, cell ({mesh.dp_index}, {mesh.sp_index}) on {mesh.device}: "
          f"gloo all_reduce of CUDA float32 and int64 tensors sums to {want}; joined in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    target = torch.load(os.path.join(tmp, "target.pt")).to(mesh.device)
    results, stats = {}, {}
    for name, fn in mesh_workloads(mrt, render, mesh, target, stats).items():
        out, seconds, launched = mesh_counted(fn)
        if name == "train":
            new, loss, grads = out
            out = {"loss": float(loss), "grads": [g.cpu() for g in grads],
                   "done": int(stats["done"]), "rays": int(stats["rays"])}
        else:
            out = {"frame": out[0].cpu(), "rays": out[1]["rays"]}
        results[name] = dict(out, seconds=seconds, launches=launched)
        print(f"rank {rank}: {name} {seconds:.2f} s, launches "
              f"{ {k: v for k, v in launched.items() if v} }", flush=True)
    torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_mesh(shape, tmp, timeout=420):
    """Phase 37's ranks of `shape` started side by side, each a process of
    this script on cuda:0; waits for all (every one killed past `timeout`
    seconds or when one fails) and returns their saved results."""
    n_dp, n_sp = shape
    world, port = n_dp * n_sp, free_port()
    logs = [os.path.join(tmp, f"log{n_dp}x{n_sp}_{r}") for r in range(world)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-u", os.path.abspath(__file__), "--mesh-rank", str(r),
                     str(world), str(port), str(n_dp), str(n_sp), tmp],
                    cwd=HERE, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.perf_counter() + timeout
        while any(p.poll() is None for p in procs) and time.perf_counter() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break  # one failed: the others would wait on it
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, log in enumerate(logs):
        with open(log) as f:
            print("\n".join(f"    [{n_dp}x{n_sp} rank {r}] {line}"
                            for line in f.read().splitlines()[-40:]))
    check(all(p.returncode == 0 for p in procs),
          f"mesh {shape}: ranks exited {[p.returncode for p in procs]}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]


def close_frames(what, got, ref, exact):
    """`got` against the single-device frame `ref`: bit for bit where
    `exact`, else within 5e-6 + 1e-5 of each value (the sp sum adds the
    blocks' running averages in another order than one device's average of
    all the samples: a few ulp of a pixel's value). Returns the max abs
    error."""
    err = float((got - ref).abs().max())
    ok = torch.equal(got, ref) if exact else bool(torch.allclose(got, ref, rtol=1e-5,
                                                                 atol=5e-6))
    check(ok, f"{what}: max abs err {err} against the single device "
              f"({'bit for bit' if exact else 'rtol 1e-5, atol 5e-6'})")
    return err


def close_steps(what, loss, grads, ref_loss, ref_grads):
    """A mesh step's loss (rtol 1e-5) and TrainParams gradients (rtol 2e-3,
    atol 2e-4 of the leaf's largest: tests/test_torch_train.py) against the
    single-device step's. Returns the loss's relative error."""
    rel = abs(loss - ref_loss) / abs(ref_loss)
    check(rel <= 1e-5, f"{what}: loss {loss} against {ref_loss}")
    for name, g, r in zip(("tex_c0", "tex_c1", "mat_param", "sph_c0", "sph_radius", "tri_m"),
                          grads, ref_grads):
        g, r = g.cpu(), r.cpu()
        scale = max(float(r.abs().max()) if r.numel() else 0.0, 1e-3)
        check(bool(torch.isfinite(g).all()) and bool(torch.allclose(g, r, rtol=2e-3,
                                                                    atol=2e-4 * scale)),
              f"{what}: grads.{name} differ from the single device's")
    return rel


def mesh_phases(mrt, card_line):
    """Phases 36-37: the device-parallel layer (`parallel/`) on the card.
    36: an NCCL world of one on cuda:0, in this process: the Cornell
    wavefront at 500x500x64x32 through B1 equal to `render`'s frame and rays
    bit for bit, and the mesh train step at 500x500x32, spp_step 128, against
    the single-device step. 37: gloo meshes (2, 1) and (2, 2), every rank a
    process on cuda:0 (the ranks time-share the one card): `mesh_workloads`,
    each held against the single-device result. Returns {row name: launches}
    summed over phase 36 and every rank."""
    import torch.distributed as dist

    from miniraytracer_tpu_torch.parallel import mesh as M
    from miniraytracer_tpu_torch.parallel import render

    n, b = MESH_SIZE, MESH_BOUNCES
    total = dict.fromkeys(MESH_COUNTERS, 0)
    cornell = mrt.scenes.cornell_box(1.0)
    params = mrt.extract_params(cornell)
    target = cornell_target(mrt, cornell, n, b)
    t0 = time.perf_counter()
    ref = {"wavefront": mrt.render(cornell, n, n, 64, max_bounces=b),
           "progressive": mrt.render_progressive(mrt.scenes.two_spheres(1.0), n, n, 4,
                                                 max_bounces=b),
           "workqueue": mrt.render_workqueue(mrt.scenes.book2_final(1.0), n, n, 4,
                                             max_bounces=b, fused_shade=False)}
    single = mrt.make_train_step(width=n, height=n, max_bounces=b, spp_step=128)
    ref_stats = {}
    _, ref_loss, ref_grads = single(params, cornell, target, 0, 0.5, stats=ref_stats)
    ref_loss, ref_done = float(ref_loss), int(ref_stats["done"])
    single = mrt.make_train_step(width=n, height=n, max_bounces=b, spp_step=128,
                                 scan_steps=mesh_scan_steps())
    long_stats = {}
    _, long_loss, long_grads = single(params, cornell, target, 0, 0.5, stats=long_stats)
    long_loss, long_done = float(long_loss), int(long_stats["done"])
    check(long_done == n * n * 128, f"the {mesh_scan_steps()}-sub-step scan completed "
                                    f"{long_done} of {n * n * 128} samples")
    torch.cuda.synchronize()
    print(f"  single-device references (phases 5 and 7's Cornell frame and step, two_spheres "
          f"progressive 500x500x4, book2_final queue 500x500x4 in tensor shading) took "
          f"{time.perf_counter() - t0:.1f} s; the step completed {ref_done} of {n * n * 128} "
          f"samples in its default scan, all in one of {mesh_scan_steps()} sub-steps (loss "
          f"{long_loss})")

    print(f"phase 36: an NCCL world of one on cuda:0: render_wavefront_distributed(cornell_box, "
          f"{n}, {n}, 64, {b} bounces) and the mesh train step ({n}x{n}, {b} bounces, "
          "spp_step 128)")
    mesh = M.init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl",
                              device="cuda:0", timeout=300)
    try:
        check(dist.get_backend() == "nccl" and mesh.distributed and mesh.size == 1,
              f"not an NCCL world of one: {dist.get_backend()}, {mesh}")
        (frame, stats), s_wf, c_wf = mesh_counted(
            lambda: render.render_wavefront_distributed(cornell, n, n, 64, mesh, max_bounces=b))
        close_frames("phase 36 wavefront", frame, ref["wavefront"][0], exact=True)
        check(stats["rays"] == ref["wavefront"][1]["rays"] and c_wf["fused_render"] > 0,
              f"phase 36 wavefront: rays {stats['rays']}, launches {c_wf}")
        step = mrt.make_train_step(width=n, height=n, max_bounces=b, spp_step=128, mesh=mesh)
        st = {}
        (_, loss, grads), s_tr, c_tr = mesh_counted(
            lambda: step(params, cornell, target, 0, 0.5, stats=st))
        rel = close_steps("phase 36 train step", float(loss), grads, ref_loss, ref_grads)
        check(int(st["done"]) == ref_done, f"phase 36 train: {int(st['done'])} samples done, "
                                           f"the single device {ref_done}")
        check(c_tr["ad_step_fwd"] > 0 and c_tr["ad_step_bwd"] > 0, f"phase 36 train: {c_tr}")
    finally:
        dist.destroy_process_group()
    for counts in (c_wf, c_tr):
        for k, v in counts.items():
            total[k] += v
    print(f"  wavefront: frame and {stats['rays']} rays equal to render()'s bit for bit, "
          f"{s_wf:.3f} s, B1 launches {c_wf['fused_render']}; train step: loss {float(loss)} "
          f"(rel err {rel:.2e} against the single device's {ref_loss}), gradients within "
          f"rtol 2e-3 / atol 2e-4 of scale, {s_tr:.3f} s, B2/B3 launches {c_tr['ad_step_fwd']}/"
          f"{c_tr['ad_step_bwd']}; on {card_line}")

    print(f"phase 37: gloo meshes (2, 1) and (2, 2), every rank a process on cuda:0 (the ranks "
          f"time-share one GPU): wavefront cornell_box {n}x{n}x64, progressive two_spheres "
          f"{n}x{n}x4, work queue book2_final {n}x{n}x4, train step cornell_box {n}x{n} "
          f"(spp_step 128 a cell on (2, 1), 64 on (2, 2), against one device at 128, each in a "
          f"scan of {mesh_scan_steps()} sub-steps); {b} bounces")
    torch.cuda.empty_cache()  # the ranks share the card with this process
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(target.cpu(), os.path.join(tmp, "target.pt"))
        for shape in ((2, 1), (2, 2)):
            t0 = time.perf_counter()
            ranks = spawn_mesh(shape, tmp)
            wall = time.perf_counter() - t0
            errs = {}
            for r, res in enumerate(ranks):
                for name, got in res.items():
                    check(all(got["launches"][k] > 0 for k in MESH_EXPECT[name]),
                          f"{shape} rank {r} {name}: launches {got['launches']}")
                    for k, v in got["launches"].items():
                        total[k] += v
                    if name == "train":
                        check(got["done"] == long_done, f"{shape} rank {r} train: "
                                                        f"{got['done']} samples done, one "
                                                        f"device {long_done}")
                        errs[name] = close_steps(f"{shape} rank {r} train", got["loss"],
                                                 got["grads"], long_loss, long_grads)
                        continue
                    # one device's work a pixel at sp = 1; the queue adds with
                    # float atomics
                    frame, stats = ref[name]
                    errs[name] = close_frames(f"{shape} rank {r} {name}", got["frame"],
                                              frame.cpu(),
                                              exact=shape[1] == 1 and name != "workqueue")
                    check(got["rays"] == stats["rays"],
                          f"{shape} rank {r} {name}: rays {got['rays']} against {stats['rays']}")
            print(f"  mesh {shape}: {len(ranks)} ranks in {wall:.1f} s of wall time (their start "
                  "and the kernels' load included); seconds a run, rank by rank: "
                  + "; ".join(f"{name} {[round(res[name]['seconds'], 3) for res in ranks]}"
                              for name in MESH_EXPECT)
                  + f"; rays exact; max abs err of the frames {errs['wavefront']:.3g} "
                    f"(wavefront), {errs['progressive']:.3g} (progressive), "
                    f"{errs['workqueue']:.3g} (queue), train loss rel err {errs['train']:.2e}; "
                    f"on {card_line}, the ranks time-sharing one GPU")
    return total


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        rank, world, port, n_dp, n_sp = map(int, sys.argv[2:7])
        mesh_rank(rank, world, port, n_dp, n_sp, sys.argv[7])
    else:
        main()
