"""Times a train step makes the host wait for the card: the runtime's
synchronize calls (stream, device, event), of any thread, that lie inside
the program's `mrt.step` spans, over the window's steps. None where the
program records no such span."""

import bisect

SPAN = "mrt.step"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def read(run):
    if run.kind != "train" or run.trace is None or not run.units:
        return None
    steps = sorted((s, e) for s, e, name in run.trace.host if name == SPAN)
    if not steps:
        return None
    starts = [s for s, _ in steps]
    inside = 0
    for s, e, name in run.trace.host:
        if name in SYNCS:
            j = bisect.bisect_right(starts, s) - 1  # steps follow one another
            inside += j >= 0 and e <= steps[j][1]
    return inside / len(run.units)
