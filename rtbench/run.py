"""The benchmark of miniraytracer_tpu_torch: one run of one cell.

    python3 rtbench/run.py --workload cornell_frames --seed 7 --seconds 20 --trace 0

Run from the root of a checkout that holds `BENCHMARK.json`, this folder and
the package. One process, one card: set-up (the cell's scene, inputs and
target from the seed, the kernels built into the package's `_build/` on the
first run, the cell's own shapes warmed up), a window of `--seconds` of the
cell's traffic, then the check of what the window's calls returned against
the plain tracer of `rtbench/reference/`. The last line of standard output is
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics with `--trace 1`,
read under `torch.profiler`), `device`, with `--trace 1` a `breakdown`, and
last `checks`, each number compared beside its limit (also the last lines of
standard error).

Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits 2; it exits 3 if the JAX package or JAX was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

_T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if __name__ == "__main__":
    # The bytecode of what a run imports (torch's ~1,100 modules, the
    # program's) is kept in the checkout, so that only its first run compiles
    # it, whether or not the installation holds bytecode of its own.
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(ROOT / "rtbench" / "_pycache")

_T_TORCH0 = time.perf_counter()
import torch  # noqa: E402

_T_TORCH = time.perf_counter() - _T_TORCH0
from torch.profiler import record_function  # noqa: E402

from rtbench.harness import spec  # noqa: E402
from rtbench.harness import trace as tr  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "miniraytracer_tpu"}


def seconds_since_start() -> float:
    """Seconds since this process started (the kernel's start time, 10 ms
    ticks); since this module's import where /proc is not there."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Run:
    """What a per-layer metric's `read(run)` reads: the cell's kind ("frames"
    or "train"), one record a timed call (`units`), the window's seconds, the
    device trace (None untraced) and the sizes of the work."""

    def __init__(self, kind, units, window_s, trace, sizes):
        self.kind, self.units, self.window_s, self.trace, self.sizes = (
            kind, units, window_s, trace, sizes)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, root: Path = ROOT, device=None) -> int:
    """One run; `device` None means the card (tests pass the CPU)."""
    args = parse(argv)
    cell = spec.load(root, args.workload)
    t_cuda = time.perf_counter()
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"rtbench: {args.workload} needs {cell.chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    t_cuda = time.perf_counter() - t_cuda
    device = torch.device(device)
    torch.set_num_threads(4)
    t_driver = seconds_since_start()
    drv = spec.driver(cell).Driver(cell, args.seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    if forbidden_modules():
        print(f"rtbench: set-up loaded {forbidden_modules()}", file=sys.stderr)
        return 3

    units, out = [], {}
    tracing = tr.traced() if args.trace else contextlib.nullcontext(out)
    with tracing as out:
        setup_s = seconds_since_start()
        t0 = time.perf_counter()
        deadline = t0 + args.seconds
        while time.perf_counter() < deadline:
            with record_function(drv.label) if args.trace else contextlib.nullcontext():
                units.append(drv.unit(len(units)))
        drv.close()
        window_s = time.perf_counter() - t0
    if forbidden_modules():
        print(f"rtbench: the run loaded {forbidden_modules()}", file=sys.stderr)
        return 3

    e2e = dict(drv.end_to_end(units, window_s), setup_s=setup_s)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else 0)}
    result_metrics, breakdown = {}, None
    trace = out.get("trace") if args.trace else None
    if trace is None:
        for m in cell.end_to_end:
            result_metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        run = Run(drv.kind, units, window_s, trace, drv.sizes())
        for m in cell.per_layer:
            value = spec.reader(cell, m["name"])(run)
            if value is not None:
                result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=tr.busy_ns(trace) / 1e9,
                        window_s=(trace.window[1] - trace.window[0]) / 1e9)
        breakdown = {"device_ops": tr.seconds_by_name(trace.device),
                     "idle_gaps": tr.idle_gaps(trace)}

    parts = " ".join(f"{k} {v:.3f}" for k, v in drv.setup_parts.items())
    print(f"rtbench setup_s {setup_s:.3f}: before the driver {t_driver:.3f} (import torch "
          f"{_T_TORCH:.3f}, CUDA's count of cards {t_cuda:.3f}), {parts}", file=sys.stderr)
    failed = sum(1 for u in units if "loss" in u and not u["loss"] == u["loss"])
    drv.free()
    got = drv.check()
    checks = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in got.items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": len(units), "failed": failed,
              "metrics": result_metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        print(f"rtbench check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
