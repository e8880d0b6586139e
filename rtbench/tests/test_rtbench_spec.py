"""BENCHMARK.json against the benchmark's contract, and discovery by name: a
configuration, a traffic mix and a per-layer metric added as new files and
new entries, with no edit to a file that is there."""

from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path

import pytest

from benchmark_copy import REPO, copy_benchmark
from rtbench.harness import spec

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rtbench"] and BENCH["command"][1].startswith("rtbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("rtbench/")
        assert (REPO / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", CELLS))
    for cell in CELLS:
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_is_found_by_name(workload):
    cell = spec.load(REPO, workload)
    assert cell.traffic["driver"] in ("frames", "train")
    assert spec.driver(cell).KIND == cell.traffic["driver"]
    assert cell.limits, "every cell has the limits of its comparison"
    for m in cell.per_layer:
        assert callable(spec.reader(cell, m["name"]))
    assert "setup_s" in [m["name"] for m in cell.end_to_end]


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_config_a_mix_and_a_metric_are_added_as_new_files(tmp_path):
    root = copy_benchmark(tmp_path, shrink=False)
    before = _digests(root / "rtbench")
    rt = root / "rtbench"
    (rt / "configs" / "two_spheres.json").write_text(json.dumps(
        {"scene": "two_spheres", "aspect": 1.0, "albedo_rows": [0], "albedo_spread": 0.1}))
    (rt / "traffic" / "preview_frames.json").write_text(json.dumps(
        {"driver": "frames", "width": 160, "height": 90, "spp": 4, "max_bounces": 8,
         "warmup": 1, "check_pixels": 64, "check_frames": 1, "check_from": 4}))
    (rt / "metrics" / "frames_per_window.render.py").write_text(
        "def read(run):\n    return float(len(run.units)) if run.kind == 'frames' else None\n")
    (rt / "limits" / "spheres_preview.json").write_text(json.dumps(
        {"limits": {"px_err_median": 1e-4, "px_off_share": 0.05}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "two_spheres", "source": "https://example.org/",
                             "file": "rtbench/configs/two_spheres.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "spheres_preview", "config": "two_spheres",
                               "traffic": "preview_frames", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "render_msamples_s" == m["name"]:
            m["workloads"].append("spheres_preview")
    bench["per_layer"].append({"name": "frames_per_window.render", "unit": "frames",
                               "better": "higher", "source": "host_clock", "layer": "test",
                               "moves": "render_msamples_s",
                               "workloads": ["spheres_preview"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(rt)
    assert all(after[p] == d for p, d in before.items()), "no existing file was edited"

    cell = spec.load(root, "spheres_preview")
    assert cell.config["scene"] == "two_spheres" and cell.traffic["width"] == 160
    assert [m["name"] for m in cell.end_to_end] == ["render_msamples_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["frames_per_window.render"]
    read = spec.reader(cell, "frames_per_window.render")
    fake = type("R", (), {"kind": "frames", "units": [{}, {}, {}]})
    assert read(fake) == 3.0
    assert spec.load(root, "cornell_frames").per_layer == spec.load(REPO, "cornell_frames").per_layer
