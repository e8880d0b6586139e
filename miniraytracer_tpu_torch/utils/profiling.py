"""Device profiling: `torch.profiler` around a block, device time by kernel.

The torch.profiler form of `miniraytracer_tpu/utils/profiling.py`. The
reference's tracing channel is an atomic ray counter and the window title's
Mrays/s (the ray counts in every renderer's stats here); this adds the
device's own trace:

    with profiling.trace() as t:
        frame, stats = mrt.render(scene, 500, 500, 64)
    print(profiling.format_summary(t.summary()))

The trace is read from the profiler's raw events
(`prof.profiler.kineto_results.events()`): building its Python event list
takes minutes for the million launches of a train step.

`span(name)` marks a part of the program's host work in that trace, beside
the kernels and on their clock; the fused frame and the fused train step
carry spans named `mrt.<layer>[.<part>]` (PERF.md, section 3, lists them).
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from miniraytracer_tpu_torch.utils.device import resolve

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as a span of the running torch profiler
    (a `record_function`: its trace holds it beside the operators and
    kernels, on their clock); with no profiler running, one shared no-op
    context, so the program records and allocates nothing for tracing.
    `torch.profiler.profile` sets the flag read here, for every thread."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN


class Trace:
    """The handle `trace()` yields; read it after the block has ended."""

    def __init__(self, prof, device_type: str):
        self.prof = prof
        self.device_type = device_type

    def kernel_times(self) -> dict:
        """{name: (total ms, count)} of the events on the traced device:
        kernels on a GPU, operators on the CPU (where nested operators each
        count their own time)."""
        want = (torch.autograd.DeviceType.CUDA if self.device_type == "cuda"
                else torch.autograd.DeviceType.CPU)
        by_name = {}
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() == want:
                ms, count = by_name.get(ev.name(), (0.0, 0))
                by_name[ev.name()] = (ms + ev.duration_ns() / 1e6, count + 1)
        return by_name

    def summary(self, top: int = 25):
        return op_summary(self, top)


@contextlib.contextmanager
def trace(device=None):
    """Trace the block on `device` (None means the GPU, and raises when there
    is none; "cpu" traces the CPU's operators). Yields a `Trace`."""
    dev = resolve(device)
    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        yield Trace(prof, dev.type)


def op_summary(t: Trace, top: int = 25):
    """The `top` kernels (operators on the CPU) of a finished trace by total
    time: a list of {name, total_ms, count, avg_us}."""
    rows = sorted(t.kernel_times().items(), key=lambda kv: -kv[1][0])[:top]
    return [{"name": name, "total_ms": round(ms, 3), "count": count,
             "avg_us": round(1e3 * ms / max(count, 1), 1)} for name, (ms, count) in rows]


def format_summary(rows) -> str:
    lines = [f"{'total ms':>10}  {'n':>6}  {'avg us':>9}  op"]
    for r in rows:
        lines.append(
            f"{r['total_ms']:10.2f}  {r['count']:6d}  {r['avg_us']:9.1f}  {r['name'][:70]}")
    return "\n".join(lines)


def device_share(fn):
    """One fn() traced on the GPU: (wall ms, device busy ms, {kernel name:
    (device ms, launches)}). The wall time ends after a synchronize; the
    profiler itself slows the host, so the idle share it gives is an upper
    bound."""
    torch.cuda.synchronize()
    with trace("cuda") as t:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = t.kernel_times()
    return wall, sum(ms for ms, _ in by_name.values()), by_name
