"""A copy of the benchmark (BENCHMARK.json and rtbench/) in a temporary
directory, its mixes shrunk to sizes a CPU test run holds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {
    "still_frames": dict(width=24, height=16, spp=9, max_bounces=8, check_pixels=96,
                         check_from=2, warmup=1),
    "fit_steps": dict(width=12, height=8, spp_step=4, max_bounces=8, target_spp=1),
}


def copy_benchmark(dest: Path, shrink: bool = True) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "rtbench", dest / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    if shrink:
        for mix, sizes in TINY.items():
            path = dest / "rtbench" / "traffic" / f"{mix}.json"
            path.write_text(json.dumps(dict(json.loads(path.read_text()), **sizes)))
    return dest
