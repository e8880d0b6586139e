"""The host's cost of one scan launch, in us: the mean duration of the
program's `mrt.b2` and `mrt.b3` spans (each around one call of the scan's
step, forward or backward: checks, parameter block, allocations, the
launch). None where the program records no such span."""

SPANS = ("mrt.b2", "mrt.b3")


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    times = [e - s for s, e, name in run.trace.host if name in SPANS]
    if not times:
        return None
    return sum(times) / len(times) / 1e3
