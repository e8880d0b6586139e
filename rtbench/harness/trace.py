"""The device trace of a run's window, read from `torch.profiler`'s raw events.

The arithmetic of `miniraytracer_tpu_torch/utils/profiling.py`
(`kernel_times`, `device_share`: events on the traced device summed by name,
device busy time against the wall time), copied here so that the yardstick
stays with the benchmark; extended to the union of the device's intervals
(kernels and copies may overlap) and to the idle gaps between them, each named
after what the host was doing in its middle.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "rtbench.window"


class Trace(NamedTuple):
    """Intervals in ns on the profiler's clock."""

    window: tuple  # (start, end)
    device: list  # [(start, end, name)], kernels, copies and sets
    host: list  # [(start, end, name)], host operators and runtime calls
    units: list  # [(start, end, label)], the benchmark's own spans (a frame, a step)


@contextlib.contextmanager
def traced():
    """Profile the block (CPU and CUDA activity); yields a dict that holds the
    `Trace` under "trace" once the block has ended."""
    out = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield out
    out["trace"] = from_events(prof.profiler.kineto_results.events())


def from_events(events, unit_labels=("frame", "step")) -> Trace:
    window, device, host, units = None, [], [], []
    for ev in events:
        iv = (ev.start_ns(), ev.end_ns(), ev.name())
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():  # a span's copy on the device's timeline
                device.append(iv)
        elif ev.name() == WINDOW:
            window = iv[:2]
        elif ev.name() in unit_labels:
            units.append(iv)
        else:
            host.append(iv)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    return Trace(window, device, host, units)


def merged(intervals, lo, hi):
    """The union of (start, end, ...) intervals clipped to [lo, hi], as
    disjoint sorted (start, end) pairs."""
    out = []
    for s, e, *_ in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(t: Trace) -> int:
    return sum(e - s for s, e in merged(t.device, *t.window))


def kernels(t: Trace):
    """Device events that are kernel launches (copies and sets left out)."""
    return [iv for iv in t.device if not iv[2].startswith(("Memcpy", "Memset"))]


def seconds_by_name(intervals, top=10):
    by = {}
    for s, e, name in intervals:
        by[name] = by.get(name, 0) + (e - s)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in rows]


def idle_gaps(t: Trace, top=10):
    """The window's idle time on the device, by what the host was doing in
    the middle of each gap: "<unit>:<innermost host event>" ("python" where no
    host event covers it)."""
    lo, hi = t.window
    busy = merged(t.device, lo, hi)
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    host = sorted(t.host)
    starts = [h[0] for h in host]
    units = sorted(t.units)
    unit_starts = [u[0] for u in units]
    named = []
    for s, e in gaps:
        mid = (s + e) // 2
        name = "python"
        # host events nest: walking back from the last to start before the
        # middle, the first that is still open there is the innermost
        i = bisect.bisect_right(starts, mid)
        for hs, he, hn in reversed(host[max(0, i - 200):i]):
            if he > mid:
                name = hn
                break
        j = bisect.bisect_right(unit_starts, mid) - 1
        unit = units[j][2] if j >= 0 and units[j][1] > mid else "window"
        named.append((s, e, f"{unit}:{name}"))
    return seconds_by_name(named, top)
