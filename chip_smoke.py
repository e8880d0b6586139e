"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from `miniraytracer_tpu_torch/csrc`, holds it
against its plain PyTorch version and against the real reference renderer's
frames, renders the Cornell box at 500x500, 64 spp, 32 bounces through the
public `render` entry point, and checks that this render went through the
kernel. Every phase raises on failure, so the exit code is nonzero and no
result line is printed. The last line of standard output is a JSON object
naming the device.
"""

from __future__ import annotations

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
    from miniraytracer_tpu_torch.ops import bounce
    from miniraytracer_tpu_torch.utils import kernels

    # 2. build the kernels from the sources in this checkout
    t0 = time.perf_counter()
    kernels.build("bounce")
    print(f"phase 2: built csrc/bounce.cu in {time.perf_counter() - t0:.2f} s")
    for line in kernels.build_log("bounce").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

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
    scene = mrt.scenes.cornell_box(1.0).to(dev)
    torch.cuda.synchronize()
    bounce.launches = 0
    frame, stats = mrt.render(scene, 500, 500, 64, max_bounces=32)
    launches = bounce.launches
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

    result = {"kernels": [{
        "name": "fused_render",
        "route": "cuda",
        "source": "miniraytracer_tpu_torch/csrc/bounce.cu",
        "replaces": "miniraytracer_tpu/ops/bounce.py:1171",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": statistics.mean(kernel_ms),
        "plain_ms": statistics.mean(plain_ms),
    }]}
    print(card_line)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
