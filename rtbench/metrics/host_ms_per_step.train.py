"""The device's idle time inside the program's `mrt.step` spans, in ms a
step: the part of the traced window that the spans cover and no kernel or
copy does (the host's own work in the train step while the card waits), over
the window's steps. None where the program records no such span."""

from rtbench.harness import trace as tr

SPAN = "mrt.step"


def read(run):
    if run.kind != "train" or run.trace is None or not run.units:
        return None
    spans = [h for h in run.trace.host if h[2] == SPAN]
    if not spans:
        return None
    # idle inside the spans = |spans U device| - |device|, both in the window
    union = sum(e - s for s, e in tr.merged(spans + run.trace.device, *run.trace.window))
    return (union - tr.busy_ns(run.trace)) / 1e6 / len(run.units)
