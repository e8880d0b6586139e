"""The device's idle share of the traced frames window, in percent: 100 x (1 -
the union of its kernel and copy intervals over the window)."""

from rtbench.harness import trace as tr


def read(run):
    if run.kind != "frames" or run.trace is None:
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - tr.busy_ns(run.trace) / (hi - lo))
