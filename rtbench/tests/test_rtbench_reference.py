"""The plain reference against the program's CPU path at tiny sizes. The test
imports both; the reference (rtbench/reference/) imports neither the program
nor JAX."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from benchmark_copy import REPO
from rtbench.reference import estimators

import miniraytracer_tpu_torch as mrt

SCENES = ("cornell_box", "cornell_smoke")


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (REPO / "rtbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in {"torch", "rtbench", "__future__", "typing"}, (
                    f"{path.name} imports {name}")


@pytest.mark.parametrize("name", SCENES)
def test_frame_pixels_equal_the_programs_frame(name):
    scene = getattr(mrt.scenes, name)(1.0)
    frame, _ = mrt.render(scene, 20, 14, 9, max_bounces=8, device="cpu")
    pix = torch.arange(20 * 14)
    ref = estimators.frame_pixels(scene, pix, 9, width=20, height=14, max_bounces=8)
    assert torch.equal(frame.reshape(-1, 3), ref)


@pytest.mark.parametrize("name, size, spp, bounces, chunks, gated", [
    ("cornell_box", (32, 32), 2, 16, {}, True),  # a few first paths outlast the claim gate
    ("cornell_smoke", (12, 8), 4, 8, {}, False),
    ("cornell_box", (12, 8), 4, 8, {"chunk": 37, "grad_chunk": 53}, False),  # depths in pieces
])
def test_fit_step_follows_the_programs_step(name, size, spp, bounces, chunks, gated):
    w, h = size
    scene = getattr(mrt.scenes, name)(1.0)
    target = torch.rand(w * h, 3, generator=torch.Generator().manual_seed(5))
    step = mrt.make_train_step(width=w, height=h, max_bounces=bounces, spp_step=spp,
                               device="cpu")
    params = mrt.extract_params(scene)
    stats = {}
    new, loss, grads = step(params, scene, target, 7, 0.5, stats=stats)
    ref_loss, ref_grads, ref_new, done = estimators.fit_step(
        scene, params._asdict(), target, 7, 0.5, width=w, height=h, spp=spp,
        max_bounces=bounces, **chunks)
    assert done == int(stats["done"])
    assert (done < w * h * spp) == gated, "the claim gate dropped samples in both"
    assert float(loss) == pytest.approx(ref_loss, rel=1e-6)
    for k in estimators.PARAMS:
        g, r = getattr(grads, k), ref_grads[k]
        scale = max(float(r.abs().max()), 1e-12)
        assert float((g - r).abs().max()) <= 1e-5 * scale, k
        assert torch.allclose(getattr(new, k), ref_new[k], rtol=1e-6, atol=1e-7), k
