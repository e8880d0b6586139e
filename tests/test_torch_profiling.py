"""The port's profiling helpers (`utils/profiling.py`) on a CPU workload:
`trace("cpu")` around a small render records the CPU's operators,
`op_summary` gives rows of {name, total_ms, count, avg_us} sorted by total
time, and `format_summary` prints one line a row. Tracing the GPU (the
default, and what `device_share` does) raises without one."""

import pytest
import torch

import miniraytracer_tpu_torch as mrt
from miniraytracer_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_trace_summarizes_a_cpu_render():
    scene = mrt.scenes.cornell_box(1.0)
    with profiling.trace("cpu") as t:
        frame, _ = mrt.render(scene, 8, 8, 1, max_bounces=2, device="cpu")
    assert torch.isfinite(frame).all()
    rows = t.summary(top=10)
    assert 0 < len(rows) <= 10
    for r in rows:
        assert set(r) == {"name", "total_ms", "count", "avg_us"}
        assert r["count"] >= 1 and r["total_ms"] >= 0.0 and r["avg_us"] >= 0.0
    totals = [r["total_ms"] for r in rows]
    assert totals == sorted(totals, reverse=True)
    assert any(r["name"].startswith("aten::") for r in rows)
    assert profiling.op_summary(t, top=3) == rows[:3]
    text = profiling.format_summary(rows)
    assert text.splitlines()[0].split() == ["total", "ms", "n", "avg", "us", "op"]
    assert len(text.splitlines()) == len(rows) + 1


def test_gpu_trace_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace():
            pass
