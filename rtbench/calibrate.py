"""The readings that the limits of `correct` are set from, in one process.

    python3 rtbench/calibrate.py --workload cornell_frames --seconds 3 \
        --seeds 11 12 13 --control-seeds 21 22 23

For each of `--seeds`: the cell's set-up, a short window of `--seconds`, and
the check against the plain tracer, as a run makes them: the program's
readings, whose largest is the lower reading of each number. For each of
`--control-seeds`: the control, the plain tracer computed in bfloat16 put in
the program's place at the cell's own size, whose smallest reading is the
upper one. With `--fault NAME` (`harness/faults.py`) the seeds' runs have
that fault planted under the timed path, and their smallest readings are
reported as the fault's. Prints one JSON line a seed and a summary line; the
runs of the benchmark never run the control or plant a fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from rtbench.harness import faults, spec  # noqa: E402


def readings(cell, seed: int, seconds: float, device, control: bool) -> dict:
    t0 = time.perf_counter()
    drv = spec.driver(cell).Driver(cell, seed, device)
    units = []
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        units.append(drv.unit(len(units)))
    drv.close()
    t1 = time.perf_counter()
    drv.free()
    got = drv.control() if control else drv.check()
    return {"seed": seed, "control": control, "units": len(units), **got,
            "leaves": getattr(drv, "compared", None),
            "setup_and_window_s": t1 - t0, "check_s": time.perf_counter() - t1}


def main(argv=None, root: Path = ROOT, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = p.parse_args(argv)
    cell = spec.load(root, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("rtbench calibrate: no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if args.fault:
        import miniraytracer_tpu_torch as mrt

        faults.plant(mrt, args.fault)
    rows = []
    for seed, control in ([(s, False) for s in args.seeds]
                          + [(s, True) for s in args.control_seeds]):
        rows.append(readings(cell, seed, args.seconds, device, control))
        print(json.dumps(rows[-1]), flush=True)
    meta = {"seed", "control", "units", "leaves", "setup_and_window_s", "check_s"}
    summary = {}
    program = ("fault", min) if args.fault else ("lower", max)
    for control, (what, pick) in ((False, program), (True, ("upper", min))):
        got = [r for r in rows if r["control"] == control]
        for k in (set(got[0]) - meta if got else ()):
            summary[f"{what}.{k}"] = pick(r[k] for r in got)
    print(json.dumps({"workload": args.workload, "fault": args.fault, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
