"""B3's share of its roofline over the traced train steps, in percent: each
step's least time of its B3 launches (`harness.roofline.scan_step`, from the
step's rays and the launches the trace holds) over B3's device time."""

from rtbench.harness import roofline
from rtbench.harness import trace as tr

KERNEL = "ad_step_bwd_kernel"


def read(run):
    if run.kind != "train" or run.trace is None or not run.units:
        return None
    times = [e - s for s, e, name in tr.kernels(run.trace) if KERNEL in name]
    if not times:
        return None
    z = run.sizes
    launches = len(times) / len(run.units)
    least = sum(roofline.scan_step(z["width"] * z["height"], launches, u["rays"], z["active"],
                                   z["table_bytes"])[1] for u in run.units)
    return 100.0 * least / (sum(times) / 1e9)
