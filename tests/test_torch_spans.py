"""The port's spans (`utils/profiling.span`) on the CPU: free when no profiler
runs, and under `profiling.trace("cpu")` the `mrt.*` spans of the fused
frame and of the fused train step, each inside the span of its caller, on
the clock of the operators around them."""

import pytest
import torch

import miniraytracer_tpu_torch as mrt
from miniraytracer_tpu_torch.ops import bounce, bounce_ad
from miniraytracer_tpu_torch.utils import profiling

torch.set_num_threads(1)

W, H, SPP, BOUNCES = 8, 8, 2, 4


def _step_and_frame():
    scene = mrt.scenes.cornell_box(1.0)
    step = mrt.make_train_step(width=W, height=H, max_bounces=BOUNCES, spp_step=SPP,
                               device="cpu")
    _, loss, _ = step(mrt.extract_params(scene), scene, torch.zeros(W * H, 3), 0, 0.1)
    frame, _ = mrt.render(scene, W, H, 1, max_bounces=2, device="cpu")
    return loss, frame


def _inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


@pytest.fixture(scope="module")
def traced():
    """The spans and the bracketing operators of one profiled step and frame:
    {name: [(start, end), ...]} on the profiler's clock."""
    with profiling.trace("cpu") as t:
        torch.zeros(1)
        loss, frame = _step_and_frame()
        torch.ones(1)
    assert torch.isfinite(loss) and torch.isfinite(frame).all()
    by_name = {}
    for ev in t.prof.profiler.kineto_results.events():
        if ev.name().startswith("mrt.") or ev.name() in ("aten::zeros", "aten::ones"):
            by_name.setdefault(ev.name(), []).append((ev.start_ns(), ev.end_ns()))
    for spans in by_name.values():
        spans.sort()
    return by_name


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    def enter(*args, **kwargs):
        raise AssertionError("a span recorded with no profiler running")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", enter)
    with pytest.raises(AssertionError):  # the patch is what record_function calls
        with torch.profiler.record_function("mrt.probe"):
            pass
    assert profiling.span("mrt.render") is profiling.span("mrt.step") is profiling._NO_SPAN
    loss, frame = _step_and_frame()  # every span of both paths, off
    assert torch.isfinite(loss) and torch.isfinite(frame).all()


def test_train_step_records_its_spans(traced):
    outer_steps = bounce_ad.scan_plan(SPP, BOUNCES)[3]
    (step,) = traced["mrt.step"]
    for part in ("mrt.step.forward", "mrt.step.backward", "mrt.step.update"):
        (span,) = traced[part]
        assert _inside(span, step), part
    fwd, bwd = traced["mrt.step.forward"][0], traced["mrt.step.backward"][0]
    assert fwd[1] <= bwd[0] <= bwd[1] <= traced["mrt.step.update"][0][0]
    (init,) = traced["mrt.scan.init"]
    (scan_f,) = traced["mrt.scan.forward"]
    (scan_b,) = traced["mrt.scan.backward"]
    assert _inside(init, fwd) and _inside(scan_f, fwd) and _inside(scan_b, bwd)
    assert len(traced["mrt.b2"]) == len(traced["mrt.b3"]) == outer_steps
    assert all(_inside(s, scan_f) for s in traced["mrt.b2"])
    assert all(_inside(s, scan_b) for s in traced["mrt.b3"])
    # the scene is packed once by the step, once by the frame
    assert sum(_inside(s, fwd) for s in traced["mrt.pack_scene"]) == 1
    (sample_base,) = traced["mrt.wait.sample_base"]
    assert _inside(sample_base, fwd) and sample_base[1] <= scan_f[0]
    indices = traced["mrt.wait.indices"]
    meta = bounce.pack_scene(mrt.scenes.cornell_box(1.0))[0]
    assert len(indices) == len(bounce_ad.diff_indices(meta))
    assert all(_inside(s, scan_b) and s[1] <= traced["mrt.b3"][0][0] for s in indices)


def test_frame_records_its_spans(traced):
    (render,) = traced["mrt.render"]
    (b1,) = traced["mrt.b1"]
    (rays,) = traced["mrt.wait.rays"]
    assert _inside(b1, render) and _inside(rays, render) and b1[1] <= rays[0]
    assert sum(_inside(s, b1) for s in traced["mrt.pack_scene"]) == 1  # the plain B1 packs
    assert traced["mrt.step"][0][1] <= render[0]


def test_spans_lie_on_the_operators_clock(traced):
    # the program makes zeros and ones too: the block's first and last ops
    before, after = traced["aten::zeros"][0], traced["aten::ones"][-1]
    spans = [s for name, ss in traced.items() if name.startswith("mrt.") for s in ss]
    assert len(spans) >= 20
    for start, end in spans:
        assert before[1] <= start <= end <= after[0]
