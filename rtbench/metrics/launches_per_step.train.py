"""Device kernel launches a train step: the kernels in the traced window over
the steps the window dispatched."""

from rtbench.harness import trace as tr


def read(run):
    if run.kind != "train" or run.trace is None or not run.units:
        return None
    return len(tr.kernels(run.trace)) / len(run.units)
