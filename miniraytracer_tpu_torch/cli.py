"""Command-line renderer: the JAX package's CLI (`miniraytracer_tpu/cli.py`)
on the port, headless.

The flags, defaults and choices are the JAX parser's, which mirrors the
reference's cmdline_parser.h (cmdline_parser.h:5-18, flag handling
cmdline_parser.cpp:78-124): -width -height -samples -tilesize -threads -depth
-scene -mode -maxlum (-delay accepted and ignored: it only gated window
capture). There is no window, so the frame goes to a PNG or PPM file
(tone-mapped with the reference's Drago operator by default,
main.cpp:416-444), and what lived in the window title (elapsed, percent,
ETA, Mrays/s and us/ray, main.cpp:393-412) goes to stdout.

Beyond the reference: -out, -tonemap, -renderer (wavefront, workqueue,
hybrid, auto; progressive = passes of one sample with progress lines and
checkpoints), -preview, -live, -checkpoint / -resume, -devices,
-fast-perlin.

The render runs on the GPU; `main(argv, device="cpu")` runs the plain
PyTorch versions of the kernels instead. Under a launcher (`torchrun
--nproc-per-node N`, one process a device) the ranks join a process group
and, as in the JAX CLI, the wavefront renders over their (dp, sp) mesh
(`parallel/render.render_wavefront_distributed`); the other renderers run on
each rank's device, and rank 0 prints the results and writes the image.

Usage: python -m miniraytracer_tpu_torch [flags]
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="miniraytracer_tpu_torch",
        description="GPU path tracer (MiniRayTracer capability set), PyTorch/CUDA port",
    )
    # reference flags + defaults (cmdline_parser.h:5-18)
    p.add_argument("-width", type=int, default=500, help="image width [16,8192]")
    p.add_argument("-height", type=int, default=500, help="image height [16,8192]")
    p.add_argument("-samples", type=int, default=128,
                   help="samples per pixel [1,1000000] (rounded down to a square)")
    p.add_argument("-tilesize", type=int, default=32,
                   help="tile size [1,512]: granularity of the inverted-Hilbert "
                        "preview sweep in progressive -preview mode")
    p.add_argument("-threads", type=int, default=0, help="accepted for parity; unused")
    p.add_argument("-depth", type=int, default=32, help="max bounces")
    p.add_argument("-scene", type=int, default=8, help="scene index 0-8 (scene.h:6-17)")
    p.add_argument("-mode", type=int, default=1,
                   help="0 = one-pass (wavefront), 1 = progressive passes")
    p.add_argument("-maxlum", type=float, default=1000.0, help="luminance clamp")
    p.add_argument("-delay", action="store_true",
                   help="accepted for parity (no window to capture)")
    p.add_argument("-live", action="store_true",
                   help="ANSI truecolor in-terminal live view, refreshed per "
                        "progressive pass (the reference window's headless stand-in)")
    # headless output / runtime extensions
    p.add_argument("-out", type=str, default="render.png",
                   help="output image path (.png or .ppm)")
    p.add_argument("-tonemap", type=str, default="drago",
                   choices=["drago", "reinhard", "gamma", "linear"])
    p.add_argument("-renderer", type=str, default=None,
                   choices=["wavefront", "progressive", "workqueue", "hybrid", "auto"],
                   help="override -mode's renderer choice (workqueue = a global "
                        "sample queue; hybrid = nearest-hit sweeps feeding one "
                        "step kernel; auto = the per-scene rule)")
    p.add_argument("-preview", type=str, default=None,
                   help="progressive mode: write a tone-mapped preview PNG here "
                        "at every checkpoint interval (the headless stand-in for "
                        "the reference's live window)")
    p.add_argument("-checkpoint", type=str, default=None,
                   help="write progressive checkpoints here")
    p.add_argument("-checkpoint-every", type=int, default=16, help="passes between checkpoints")
    p.add_argument("-resume", type=str, default=None, help="resume from a checkpoint file")
    p.add_argument("-devices", type=int, default=0,
                   help="device count, one process each (0 = the launcher's world "
                        "size, 1 without a launcher)")
    p.add_argument("-fast-perlin", action="store_true",
                   help="table-free hash-gradient Perlin (statistically equivalent "
                        "but non-parity noise field)")
    p.add_argument("-seed-check", action="store_true", help=argparse.SUPPRESS)
    return p


def _validate(args):
    # min/max validation like cmdline_parser.cpp:78-107
    def clamp(name, v, lo, hi):
        if v < lo or v > hi:
            print(f"warning: {name}={v} out of [{lo},{hi}], clamping")
        return max(lo, min(hi, v))

    args.width = clamp("width", args.width, 16, 8192)
    args.height = clamp("height", args.height, 16, 8192)
    args.samples = clamp("samples", args.samples, 1, 1_000_000)
    args.tilesize = clamp("tilesize", args.tilesize, 1, 512)
    args.depth = clamp("depth", args.depth, 1, 1024)
    args.scene = clamp("scene", args.scene, 0, 8)
    return args


def _progressive(args, scene, dev, lead=True):
    """The progressive renderer: passes of one sample of every pixel, with
    progress lines, checkpoints, the preview and the live view (written by
    the `lead` rank only). Returns (frame (H, W, 3) tensor, stats)."""
    import torch

    from miniraytracer_tpu_torch.models import integrator as integ
    from miniraytracer_tpu_torch.utils import tonemap as tm
    from miniraytracer_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from miniraytracer_tpu_torch.utils.image import save_png

    w, h = args.width, args.height
    start_pass = 0
    frame_flat = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
    if args.resume:
        ck_frame, start_pass, cfg = load_checkpoint(args.resume)
        if (cfg["width"], cfg["height"], cfg["scene"]) != (w, h, args.scene):
            sys.exit("checkpoint config mismatch: " + str(cfg))
        frame_flat = torch.from_numpy(ck_frame.reshape(-1, 3)).to(dev)
        print(f"resumed at pass {start_pass}")

    offs, ns = integ.sample_offsets(args.samples, device=dev)
    kw = dict(width=w, height=h, max_bounces=args.depth, loop="while")
    # the passes' ray counts stay 0-d device tensors: the host reads them
    # only at a checkpoint interval
    ray_counts = []
    t_start = time.perf_counter()

    # -preview / -live: each pass sweeps the frame in inverted-Hilbert tile
    # batches (work_queue.cpp:84-127), so the preview refines uniformly like
    # the reference's live window; refreshed at most ~2 Hz (main.cpp:387-488
    # refreshes on a timer, not per tile)
    batches = live = None
    last_preview = [0.0]
    if args.preview or args.live:
        from miniraytracer_tpu_torch.utils.runtime import tile_pixel_batches

        batches = [torch.from_numpy(b).to(dev) for b in tile_pixel_batches(w, h, args.tilesize)]
    if args.live:
        from miniraytracer_tpu_torch.utils.terminal import LiveView

        live = LiveView()

    def write_preview(force=False, status=""):
        now = time.perf_counter()
        if not force and now - last_preview[0] < 0.5:
            return
        last_preview[0] = now
        img = tm.drago(frame_flat.reshape(h, w, 3)).cpu().numpy()
        if args.preview and lead:
            save_png(args.preview, img)
        if live is not None:
            live.update(img[::-1], status=status)

    for i in range(start_pass, ns):
        if batches is not None:
            for pix in batches:
                rows, rays = integ.render_tile_pass(scene, frame_flat[pix], pix, i, offs[i],
                                                    args.maxlum, **kw)
                # the last batch repeats its final pixel id; its rows are
                # equal, so the duplicate write is harmless
                frame_flat[pix] = rows
                ray_counts.append(rays)
                write_preview(status=f"pass {i + 1}/{ns}")
        else:
            frame_flat, rays = integ.render_pass(scene, frame_flat, i, offs[i], args.maxlum, **kw)
            ray_counts.append(rays)
        if (i + 1) % max(args.checkpoint_every, 1) == 0 or i == ns - 1:
            rays_so_far = int(torch.stack(ray_counts).sum())  # waits for the device
            elapsed = time.perf_counter() - t_start
            done = i + 1 - start_pass
            pct = 100.0 * (i + 1) / ns
            eta = elapsed / max(done, 1) * (ns - i - 1)
            mrays = rays_so_far / elapsed / 1e6 if elapsed > 0 else 0.0
            print(f"pass {i + 1}/{ns}  {pct:5.1f}%  elapsed {elapsed:6.1f}s  "
                  f"eta {eta:6.1f}s  {mrays:.2f} Mrays/s")
            if args.checkpoint and lead:
                written = save_checkpoint(
                    args.checkpoint, frame_flat.cpu().numpy(), i + 1,
                    {"width": w, "height": h, "scene": args.scene, "samples": ns,
                     "depth": args.depth})
                print(f"checkpoint -> {written}")
            if batches is not None:
                write_preview(force=True,
                              status=f"pass {i + 1}/{ns}  {pct:5.1f}%  {mrays:.2f} Mrays/s")
    rays_total = int(torch.stack(ray_counts).sum()) if ray_counts else 0
    elapsed = time.perf_counter() - t_start
    if live is not None:
        live.close()
    return frame_flat.reshape(h, w, 3), {
        "seconds": elapsed, "spp": ns, "rays": rays_total,
        "mrays_per_s": rays_total / elapsed / 1e6 if elapsed > 0 else 0.0}


def _mesh(args, device):
    """The mesh of this run: the launcher's world (a group already joined,
    or WORLD_SIZE above 1 as torchrun sets it, joined here), else the
    trivial (1, 1) mesh. `-devices` must be 0 or the world size."""
    import os

    import torch.distributed as dist

    from miniraytracer_tpu_torch.parallel import mesh as M

    joined = dist.is_available() and dist.is_initialized()
    launched = joined or int(os.environ.get("WORLD_SIZE", "1")) > 1
    world = int(dist.get_world_size() if joined else os.environ.get("WORLD_SIZE", "1"))
    n = args.devices or world
    if n != world:
        sys.exit(f"-devices {n}: this run has {world} process(es), one a device; start "
                 f"{n} with `torchrun --nproc-per-node {n} -m miniraytracer_tpu_torch ...`")
    if joined:
        return M.make_mesh(*M.auto_mesh_shape(world), device=device)
    if launched:
        return M.init_distributed(device=device)
    return M.make_mesh(device=device)


def main(argv=None, *, device=None):
    """Render as the flags say and write the image. `device` None means the
    GPU (cuda:LOCAL_RANK under a launcher; it raises when there is none);
    the scene is moved there once."""
    args = _validate(build_parser().parse_args(argv))
    mesh = _mesh(args, device)
    if mesh.dp_index or mesh.sp_index:  # only rank 0 prints and writes
        import contextlib
        import io

        with contextlib.redirect_stdout(io.StringIO()):
            return _run(args, mesh, lead=False)
    return _run(args, mesh, lead=True)


def _run(args, mesh, lead):
    import dataclasses

    import numpy as np

    from miniraytracer_tpu_torch.models import integrator as integ
    from miniraytracer_tpu_torch.models import scenes as S
    from miniraytracer_tpu_torch.ops import hybrid
    from miniraytracer_tpu_torch.parallel.render import render_wavefront_distributed
    from miniraytracer_tpu_torch.utils import tonemap as tm
    from miniraytracer_tpu_torch.utils.image import save_png, save_ppm

    dev = mesh.device
    t0 = time.perf_counter()
    scene = S.select_scene(args.scene, args.width / args.height)
    if args.fast_perlin:
        scene = dataclasses.replace(scene, fast_perlin=True)
    scene = scene.to(dev)
    print(f"scene '{scene.name}' built in {time.perf_counter() - t0:.2f} s "
          f"({scene.n_spheres} spheres, {scene.n_rects} rects, "
          f"{scene.n_tris} tris, {scene.n_volumes} volumes); {mesh.size} device(s) mesh "
          f"{mesh.n_dp}x{mesh.n_sp} ({dev})")

    renderer = args.renderer or ("progressive" if args.mode == 1 else "wavefront")
    common = (scene, args.width, args.height, args.samples)
    kw = dict(max_bounces=args.depth, max_lum=args.maxlum)
    if renderer == "workqueue":
        frame, stats = integ.render_workqueue(*common, **kw, device=dev)
    elif renderer == "hybrid":
        frame, stats = hybrid.render_wavefront_hybrid(*common, **kw)
    elif renderer == "auto":
        print(f"auto renderer: {integ.pick_renderer(scene)}")
        frame, stats = integ.render_auto(*common, **kw, device=dev)
    elif renderer == "wavefront":
        # as the JAX CLI: over the mesh, with the fused kernel where the scene
        # is eligible (fused=None)
        frame, stats = render_wavefront_distributed(*common, mesh, **kw)
    else:
        frame, stats = _progressive(args, scene, dev, lead)

    if stats.get("rays"):
        us_per_ray = stats["seconds"] / stats["rays"] * 1e6
        print(f"done in {stats['seconds']:.2f} s  {stats['mrays_per_s']:.2f} Mrays/s  "
              f"{us_per_ray:.3f} us/ray  ({stats['spp']} spp)")
    else:
        print(f"done in {stats['seconds']:.2f} s  ({stats['spp']} spp)")

    # tone map for display (the linear frame is the ground truth, main.cpp:57-58)
    if args.tonemap == "linear":
        out = np.clip(frame.cpu().numpy(), 0.0, 1.0)
    else:
        out = tm.OPERATORS[args.tonemap](frame).cpu().numpy()
    if lead:
        (save_ppm if args.out.endswith(".ppm") else save_png)(args.out, out)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
