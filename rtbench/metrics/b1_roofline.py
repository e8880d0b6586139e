"""B1's share of its roofline over the traced frames, in percent: the least
time of every frame (`harness.roofline.b1_frame`, from its ray count and the
scene's active primitives) over B1's device time in the trace."""

from rtbench.harness import roofline
from rtbench.harness import trace as tr

KERNEL = "fused_render_kernel"


def read(run):
    if run.kind != "frames" or run.trace is None:
        return None
    ns = sum(e - s for s, e, name in tr.kernels(run.trace) if KERNEL in name)
    if not ns:
        return None
    z = run.sizes
    least = sum(roofline.b1_frame(z["width"] * z["height"], u["rays"], z["active"],
                                  z["table_bytes"]) for u in run.units)
    return 100.0 * least / (ns / 1e9)
