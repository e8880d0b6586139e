"""Fitting scene parameters: SGD steps of the differentiable render, back to back.

The mix's file gives the step (`width`, `height`, `spp_step`, `max_bounces`,
`lr`) and the target's samples (`target_spp`). Set-up makes the target, the
scene rendered by the plain tracer at the albedos the seed draws (what users
fit to: an image of the scene as it should be), builds the step
(`make_train_step(fused_ad=True)`) and drives it through its first `CHECKED`
steps from the scene's own parameters: the same step object and feed as the
window's, each step on its own samples (`sample0` advancing by one). The
window goes on from there, every step from the parameters those steps
reached, on its own samples: the update each returns is not carried, so the
work of a step stays what the seed fixed. (Carried over hundreds of steps,
the noise of each step's gradient walks an albedo the target does not pin,
the smoke's black medium's, across 0, and its paths' lengths with it: the
smoke cell's rate spread by 14-26% between runs.) No step's result is read
before the window's closing `synchronize`.

`correct` holds those first steps against the plain tracer's
(`reference.estimators.fit_step`), which follows its own three steps from the
same parameters, target and samples. Three numbers are compared: the worst
step's relative loss gap; and by the worst leaf, the gap between the norms of
the first gradient as the optimizer took it ((p0 - p1) / lr) and of the
parameters' change over the three steps, each over the reference's norm of
that leaf or of the median leaf, whichever is larger. Leaves whose reference
gradient is under a thousandth of the median leaf's are left out: they move
by rounding alone.
"""

from __future__ import annotations

import statistics
import time

import torch

from rtbench.harness import scene as scenes
from rtbench.reference import estimators, tracer

KIND = "train"
LABEL = "step"
CHECKED = 3


def compared_leaves(ref_grad: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median non-zero leaf's: the others move by rounding alone."""
    gnorm = {k: float(v.double().norm()) for k, v in ref_grad.items() if v.numel()}
    med = statistics.median([v for v in gnorm.values() if v > 0])
    return [k for k, v in gnorm.items() if v >= 1e-3 * med]


def leaf_gaps(got: dict, ref: dict, ref_grad: dict) -> float:
    """The worst leaf's |‖got‖ - ‖ref‖| / max(‖ref‖, median leaf's ‖ref‖),
    over `compared_leaves`."""
    keep = compared_leaves(ref_grad)
    norms = {k: float(v.double().norm()) for k, v in ref.items()}
    ref_med = statistics.median([norms[k] for k in keep])
    return max(abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], ref_med)
               for k in keep)


def numbers(losses, params, ref_losses, ref_params, lr) -> dict:
    """`params`: the parameters before and after each checked step (CHECKED
    + 1 dicts), the program's and the reference's."""
    grad = {k: (params[0][k] - params[1][k]) / lr for k in params[0]}
    ref_grad = {k: (ref_params[0][k] - ref_params[1][k]) / lr for k in ref_params[0]}
    change = {k: params[-1][k] - params[0][k] for k in params[0]}
    ref_change = {k: ref_params[-1][k] - ref_params[0][k] for k in ref_params[0]}
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            "grad_gap": leaf_gaps(grad, ref_grad, ref_grad),
            "change_gap": leaf_gaps(change, ref_change, ref_grad)}


class Driver:
    kind = KIND
    label = LABEL

    def __init__(self, cell, seed: int, device):
        t0 = time.perf_counter()
        import miniraytracer_tpu_torch as mrt

        t, cfg = cell.traffic, cell.config
        self.w, self.h = int(t["width"]), int(t["height"])
        self.spp, self.bounces, self.lr = int(t["spp_step"]), int(t["max_bounces"]), float(t["lr"])
        self.device = device
        self.scene = scenes.build(mrt, cfg)
        self.active = tracer.active_counts(self.scene)
        self.table_bytes = tracer.table_bytes(tracer.pack(self.scene))
        self.sample0 = seed % 4096
        with torch.no_grad():
            self.target = estimators.frame_pixels(
                scenes.seeded_albedos(self.scene, cfg, seed),
                torch.arange(self.w * self.h), int(t["target_spp"]), width=self.w,
                height=self.h, max_bounces=self.bounces, device=device)
        t1 = time.perf_counter()
        self._step = mrt.make_train_step(width=self.w, height=self.h,
                                         max_bounces=self.bounces, spp_step=self.spp,
                                         device=device)
        self._scene_dev = self.scene.to(device)
        self.params0 = {k: v.detach().clone().cpu()
                        for k, v in mrt.extract_params(self.scene)._asdict().items()}
        params = mrt.extract_params(self._scene_dev)
        self.checked = [params]
        self.losses = []
        for i in range(CHECKED):
            params, loss, _ = self._step(params, self._scene_dev, self.target,
                                         self.sample0 + i, self.lr)
            self.checked.append(params)
            self.losses.append(loss)
        self._params = params
        self._pending = []
        self.close()
        self.setup_parts = {"scene and target": t1 - t0,
                            "checked steps": time.perf_counter() - t1}

    def unit(self, i: int) -> dict:
        stats = {}
        _, loss, _ = self._step(self._params, self._scene_dev, self.target,
                                self.sample0 + CHECKED + i, self.lr, stats=stats)
        self._pending.append((loss, stats))
        return {}

    def close(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def read_units(self, units):
        """Fill the window's records from the tensors kept (after `close`)."""
        for (loss, stats), u in zip(self._pending, units):
            u.update(loss=float(loss), rays=int(stats["rays"]), done=int(stats["done"]),
                     claimed=self.w * self.h * self.spp)

    def end_to_end(self, units, window_s: float) -> dict:
        self.read_units(units)
        return {"train_msamples_s": sum(u["done"] for u in units) / window_s / 1e6}

    def sizes(self) -> dict:
        return {"width": self.w, "height": self.h, "spp": self.spp, "active": self.active,
                "table_bytes": self.table_bytes}

    def free(self):
        self.got_losses = [float(x) for x in self.losses]
        self.got_params = [{k: v.detach().float().cpu() for k, v in p._asdict().items()}
                           for p in self.checked]
        del self._step, self._scene_dev, self._params, self._pending, self.checked
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dt=torch.float32):
        params, losses, trail = dict(self.params0), [], [dict(self.params0)]
        for i in range(CHECKED):
            loss, _, params, _ = estimators.fit_step(
                self.scene, params, self.target, self.sample0 + i, self.lr, width=self.w,
                height=self.h, spp=self.spp, max_bounces=self.bounces, dt=dt)
            params = {k: v.cpu() for k, v in params.items()}
            losses.append(loss)
            trail.append(params)
        return losses, trail

    def check(self) -> dict:
        ref_losses, ref_trail = self.reference()
        self.compared = compared_leaves(
            {k: (ref_trail[0][k] - ref_trail[1][k]) / self.lr for k in ref_trail[0]})
        return numbers(self.got_losses, self.got_params, ref_losses, ref_trail, self.lr)

    def control(self) -> dict:
        ref_losses, ref_trail = self.reference()
        low_losses, low_trail = self.reference(torch.bfloat16)
        return numbers(low_losses, low_trail, ref_losses, ref_trail, self.lr)
