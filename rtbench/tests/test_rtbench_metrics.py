"""The per-layer metrics' arithmetic on a synthetic profile, and the frozen
roofline counts repeating exactly for seeded inputs."""

from __future__ import annotations

import pytest
import torch

from benchmark_copy import REPO
from rtbench import run as rb
from rtbench.harness import roofline, spec
from rtbench.harness import trace as tr
from rtbench.reference import estimators, tracer

MS = 1_000_000  # ns


def fake_trace():
    """A 100-ms window: two B1 frames of 30 ms and 40 ms that overlap a copy,
    a 10-ms gap while the host sat in aten::cat inside the first frame's
    span, and a 5-ms tail in python after the last."""
    device = [(0, 30 * MS, "void fused_render_kernel<true>(...)"),
              (25 * MS, 35 * MS, "Memcpy DtoH (Device -> Pinned)"),
              (45 * MS, 85 * MS, "void fused_render_kernel<true>(...)"),
              (90 * MS, 95 * MS, "void at::native::reduce_kernel<512, 1>(...)")]
    host = [(34 * MS, 46 * MS, "aten::cat"), (36 * MS, 37 * MS, "cudaLaunchKernel"),
            (80 * MS, 90 * MS, "cudaStreamSynchronize")]
    units = [(0, 50 * MS, "frame"), (50 * MS, 95 * MS, "frame")]
    return tr.Trace((0, 100 * MS), device, host, units)


def test_busy_union_and_idle_gaps():
    t = fake_trace()
    assert tr.busy_ns(t) == 35 * MS + 40 * MS + 5 * MS
    gaps = dict((name, s) for name, s in tr.idle_gaps(t))
    assert gaps == {"frame:aten::cat": pytest.approx(0.010), "frame:cudaStreamSynchronize":
                    pytest.approx(0.005), "window:python": pytest.approx(0.005)}
    ops = tr.seconds_by_name(t.device)
    assert ops[0] == ["void fused_render_kernel<true>(...)", pytest.approx(0.070)]
    assert len(tr.kernels(t)) == 3


def _cell_readers(workload):
    cell = spec.load(REPO, workload)
    return {m["name"]: spec.reader(cell, m["name"]) for m in cell.per_layer}


def test_frame_metrics_read_the_synthetic_profile():
    active = {"S": 1, "R": 6, "Tc": 0, "Bx": 1, "V": 0}
    units = [{"ms": 31.0, "rays": 200_000_000, "samples": 70_560_000},
             {"ms": 41.0, "rays": 220_000_000, "samples": 70_560_000}]
    run = rb.Run("frames", units, 0.1, fake_trace(),
                 {"width": 600, "height": 600, "spp": 196, "active": active,
                  "table_bytes": 10_000})
    got = {name: read(run) for name, read in _cell_readers("cornell_frames").items()}
    assert got["rays_per_sample.render"] == pytest.approx(420e6 / 141.12e6)
    assert got["idle_pct.render"] == pytest.approx(20.0)
    least = 420e6 * 560 / roofline.FP32_OPS_PER_S  # bound by operations here
    assert got["b1_roofline"] == pytest.approx(100 * least / 0.070)
    untraced = rb.Run("frames", units, 0.1, None, run.sizes)
    assert {n: r(untraced) for n, r in _cell_readers("cornell_frames").items()} == {
        "rays_per_sample.render": got["rays_per_sample.render"], "idle_pct.render": None,
        "b1_roofline": None}


def test_train_metrics_read_a_synthetic_profile():
    active = {"S": 1, "R": 6, "Tc": 0, "Bx": 1, "V": 0}
    device, t = [], 0
    for _ in range(2):  # two steps: 3 B2 launches, 3 B3 launches, one copy
        for name, ms in (("ad_step_fwd_kernel<0,0,0,1>", 1), ("ad_step_bwd_kernel<4,0,0,0>", 4)):
            for _ in range(3):
                device.append((t, t + ms * MS, name))
                t += ms * MS
        device.append((t, t + MS, "Memset (Device)"))
        t += 2 * MS
    trace = tr.Trace((0, t), device, [], [])
    units = [{"rays": 3_000_000, "done": 990, "claimed": 1000},
             {"rays": 3_000_000, "done": 1000, "claimed": 1000}]
    run = rb.Run("train", units, t / 1e9, trace,
                 {"width": 10, "height": 10, "spp": 10, "active": active, "table_bytes": 0})
    got = {name: read(run) for name, read in _cell_readers("cornell_train").items()}
    assert got["launches_per_step.train"] == 6
    assert got["done_frac.train"] == pytest.approx(0.995)
    assert got["idle_pct.train"] == pytest.approx(100 * 2 / 34)
    b2, b3 = roofline.scan_step(100, 3, 3_000_000, active, 0)
    assert b3 == pytest.approx(2 * b2)
    assert got["b2_roofline"] == pytest.approx(100 * 2 * b2 / 0.006)
    assert got["b3_roofline"] == pytest.approx(100 * 2 * b3 / 0.024)
    assert got["b3_roofline"] == pytest.approx(got["b2_roofline"] / 2)


@pytest.mark.parametrize("name, per_ray", [("cornell_box", 560), ("cornell_smoke", 658)])
def test_frozen_counts_repeat_exactly(name, per_ray):
    import miniraytracer_tpu_torch as mrt

    scene = getattr(mrt.scenes, name)(1.0)
    active = tracer.active_counts(scene)
    assert roofline.ops_per_ray(active) == per_ray  # 560: chip_smoke.py's Cornell count
    sc = tracer.pack(scene)
    pix = torch.arange(12 * 10)
    samp = torch.zeros_like(pix)
    rays = [int(tracer.trace(sc, pix, samp, width=12, height=10, sq=1, max_bounces=8)[1].sum())
            for _ in range(2)]
    assert rays[0] == rays[1]
    _, stats = mrt.render(scene, 12, 10, 1, max_bounces=8, device="cpu")
    assert stats["rays"] == rays[0], "the frozen count reads the program's ray count"
    b1 = roofline.b1_frame(120, rays[0], active, tracer.table_bytes(sc))
    assert b1 == roofline.b1_frame(120, rays[0], active, tracer.table_bytes(sc)) > 0


def test_reference_traces_every_sample_it_is_asked():
    import miniraytracer_tpu_torch as mrt

    scene = mrt.scenes.cornell_box(1.0)
    px = estimators.frame_pixels(scene, torch.tensor([0, 5, 77]), 4, width=12, height=10,
                                 max_bounces=4)
    assert px.shape == (3, 3) and bool(torch.isfinite(px).all())
