"""Everything of a cell, found by its name in `BENCHMARK.json`.

A checkout holds `BENCHMARK.json` at its root and the benchmark's folder
beside it. A cell (`workloads` entry) names a configuration, whose entry names
its file, and a traffic mix, `<folder>/traffic/<mix>.json`, whose "driver"
names the general loop that reads it (`rtbench/harness/<driver>.py`). A
per-layer metric is `<folder>/metrics/<name>.py` with a `read(run)`; the
limits of a cell's comparison are `<folder>/limits/<workload>.json`. A later
change adds a configuration, a mix, a metric or a cell as new files and new
entries, and edits none of these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple


class Cell(NamedTuple):
    root: Path  # the checkout: BENCHMARK.json and the benchmark's folder
    folder: Path
    name: str
    chips: int
    config: dict  # the configuration file, with "name"
    traffic: dict  # the mix's file, with "name"
    end_to_end: list  # the metric entries this cell reports, in file order
    per_layer: list
    limits: dict  # {number compared: limit}


def _reports(entry: dict, workload: str) -> bool:
    return workload in entry.get("workloads", [workload])


def load(root: Path, workload: str, folder: str = "rtbench") -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (it has "
                       f"{', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(json.loads((root / configs[w["config"]]["file"]).read_text()),
                  name=w["config"])
    base = root / folder
    traffic = dict(json.loads((base / "traffic" / f"{w['traffic']}.json").read_text()),
                   name=w["traffic"])
    limits_file = base / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text())["limits"] if limits_file.exists() else {}
    return Cell(root, base, workload, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)], limits)


def driver(cell: Cell):
    """The module of the mix's general loop."""
    return importlib.import_module(f"rtbench.harness.{cell.traffic['driver']}")


def reader(cell: Cell, metric: str):
    """The `read(run)` of a per-layer metric, from its own file."""
    path = cell.folder / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"rtbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
