"""Faults planted under the timed path, to read what the check makes of them.

Each fault replaces one entry point of the program (`render` or
`make_train_step`) by a broken form of it: a frame altered where it is
produced, half of a frame's samples left out, a step that returns its state
unchanged, half of a step's pixels left out with the mean taken over the
rest, and a step whose update is altered. `rtbench/calibrate.py --fault`
reads them at a cell's own size on the card; the tests plant them at a tiny
size on the CPU. No run of the benchmark plants any.
"""

from __future__ import annotations

import torch


def altered_frame(render):
    def broken(*a, **kw):
        frame, stats = render(*a, **kw)
        return frame * torch.tensor([1.0, 1.05, 1.0], device=frame.device), stats
    return broken


def half_the_samples(render):
    def broken(scene, w, h, spp, **kw):
        return render(scene, w, h, spp // 2, **kw)
    return broken


def unchanged_state(make):
    def broken(**kw):
        step = make(**kw)

        def run(params, *a, **k):
            _, loss, grads = step(params, *a, **k)
            return params, loss, grads
        return run
    return broken


def half_the_pixels(make):
    def broken(*, width, height, **kw):
        step = make(width=width, height=height // 2, **kw)

        def run(params, scene, target, *a, **k):
            return step(params, scene, target[:width * (height // 2)], *a, **k)
        return run
    return broken


def altered_update(make):
    def broken(**kw):
        step = make(**kw)

        def run(params, scene, target, sample0, lr, **k):
            return step(params, scene, target, sample0, 1.1 * lr, **k)
        return run
    return broken


# name -> (the program's entry point it replaces, the fault)
FAULTS = {
    "altered_frame": ("render", altered_frame),
    "half_the_samples": ("render", half_the_samples),
    "unchanged_state": ("make_train_step", unchanged_state),
    "half_the_pixels": ("make_train_step", half_the_pixels),
    "altered_update": ("make_train_step", altered_update),
}


def plant(mrt, name: str):
    """Replace the entry point on the program's module; returns what undoes it."""
    attr, fault = FAULTS[name]
    original = getattr(mrt, attr)
    setattr(mrt, attr, fault(original))
    return lambda: setattr(mrt, attr, original)
