"""Closed-loop still frames: one client renders the cell's frame back to back.

The mix's file gives the frame (`width`, `height`, `spp`, `max_bounces`),
the warm-up frames, the pixels checked (`check_pixels`) and the frames kept
for the check (`check_frames`, drawn from the first `check_from` frames, and
the window's last). Each frame is timed from the call to `render` to its
return, which waits for the card (the renderer reads its ray count back).

`correct` holds the kept frames' checked pixels against the plain tracer's
(`reference.estimators.frame_pixels`) at the same scene, size and samples.
Two numbers are compared: the median over the checked pixels of the worst
channel's relative error (floor 1e-3 under the reference's value), and the
share of checked pixels whose relative error passes `OFF`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench.harness import scene as scenes
from rtbench.reference import estimators, tracer

KIND = "frames"
LABEL = "frame"
OFF = 1e-3  # a pixel further off than this, relatively, is counted as off


def pixel_errors(got, ref):
    """Per pixel, the worst channel's |got - ref| / max(|ref|, 1e-3); a
    non-finite pixel reads inf."""
    err = (got.double() - ref.double()).abs() / ref.double().abs().clamp_min(1e-3)
    err = torch.where(torch.isfinite(err), err, torch.inf)
    return err.max(dim=1).values


def numbers(got, ref) -> dict:
    err = pixel_errors(got, ref)
    return {"px_err_median": float(err.median()),
            "px_off_share": float((err > OFF).double().mean())}


class Driver:
    kind = KIND
    label = LABEL

    def __init__(self, cell, seed: int, device):
        t0 = time.perf_counter()
        import miniraytracer_tpu_torch as mrt

        t, cfg = cell.traffic, cell.config
        self.w, self.h = int(t["width"]), int(t["height"])
        self.spp, self.bounces = int(t["spp"]), int(t["max_bounces"])
        self.device = device
        self.scene = scenes.seeded_albedos(scenes.build(mrt, cfg), cfg, seed)
        self.active = tracer.active_counts(self.scene)
        self.table_bytes = tracer.table_bytes(tracer.pack(self.scene))
        rng = np.random.default_rng([seed, 1])
        n_px = self.w * self.h
        self.pix = torch.as_tensor(np.sort(rng.choice(n_px, min(int(t["check_pixels"]), n_px),
                                                      replace=False)), dtype=torch.int64)
        self.keep_at = set(int(i) for i in rng.integers(0, int(t["check_from"]),
                                                        int(t["check_frames"])))
        self.kept = []
        self._scene_dev = self.scene.to(device)
        self._render = lambda: mrt.render(self._scene_dev, self.w, self.h, self.spp,
                                          max_bounces=self.bounces, device=device)
        t1 = time.perf_counter()
        for _ in range(int(t["warmup"])):
            self._render()
        self._last = None
        self.setup_parts = {"scene": t1 - t0, "warm-up frames": time.perf_counter() - t1}

    def unit(self, i: int) -> dict:
        t0 = time.perf_counter()
        frame, stats = self._render()
        ms = 1e3 * (time.perf_counter() - t0)
        if i in self.keep_at:
            self.kept.append(frame)
        self._last = frame
        return {"ms": ms, "rays": int(stats["rays"]),
                "samples": self.w * self.h * int(stats["spp"])}

    def close(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def end_to_end(self, units, window_s: float) -> dict:
        ms = [u["ms"] for u in units]
        return {"render_msamples_s": sum(u["samples"] for u in units) / window_s / 1e6,
                "frame_p95_ms": float(np.percentile(ms, 95))}

    def sizes(self) -> dict:
        return {"width": self.w, "height": self.h, "spp": self.spp, "active": self.active,
                "table_bytes": self.table_bytes}

    def free(self):
        """Keep the checked pixels of the kept frames (and of the last), drop
        the program's state."""
        frames = self.kept + ([self._last] if self._last is not None else [])
        idx = self.pix.to(self.device)
        self.got = [f.reshape(-1, 3)[idx].float().cpu() for f in frames]
        del self.kept, self._last, self._render, self._scene_dev, frames
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dt=torch.float32):
        return estimators.frame_pixels(self.scene, self.pix, self.spp, width=self.w,
                                       height=self.h, max_bounces=self.bounces, dt=dt,
                                       device=self.device).float().cpu()

    def check(self) -> dict:
        """The numbers compared, for the worst kept frame."""
        ref = self.reference()
        worst = {}
        for got in self.got:
            for k, v in numbers(got, ref).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    def control(self) -> dict:
        """The same numbers for the reference in bfloat16 put in the program's
        place."""
        return numbers(self.reference(torch.bfloat16), self.reference())
