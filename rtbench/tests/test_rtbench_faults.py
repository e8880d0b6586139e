"""`correct` comes out false: for the bfloat16 control, and for a run with the
timed path broken underneath (the look for a card skipped, everything else as
a run does it, at sizes a CPU test run holds). Sound runs come out true."""

from __future__ import annotations

import json

import pytest

from benchmark_copy import copy_benchmark
from rtbench import calibrate
from rtbench import run as rb
from rtbench.harness import faults

import miniraytracer_tpu_torch as mrt

SEED = 2_147_483_911


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_benchmark(tmp_path_factory.mktemp("bench"))


def one_run(root, workload, capsys):
    rc = rb.main(["--workload", workload, "--seed", str(SEED), "--seconds", "0.5",
                  "--trace", "0"], root=root, device="cpu")
    out = capsys.readouterr()
    assert rc == 0
    result = json.loads(out.out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("rtbench check ")
    return result


def failing(result):
    return [k for k, c in result["checks"].items()
            if c["limit"] is not None and c["value"] > c["limit"]]


@pytest.mark.parametrize("workload", ["cornell_frames", "smoke_frames", "cornell_train",
                                      "smoke_train"])
def test_sound_run_is_correct(root, workload, capsys):
    result = one_run(root, workload, capsys)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("workload", ["cornell_frames", "smoke_frames"])
@pytest.mark.parametrize("fault", ["altered_frame", "half_the_samples"])
def test_broken_frames_are_not_correct(root, workload, fault, capsys, monkeypatch):
    attr, broken = faults.FAULTS[fault]
    monkeypatch.setattr(mrt, attr, broken(getattr(mrt, attr)))
    result = one_run(root, workload, capsys)
    assert not result["correct"] and failing(result)


@pytest.mark.parametrize("workload", ["cornell_train", "smoke_train"])
@pytest.mark.parametrize("fault", ["unchanged_state", "half_the_pixels", "altered_update"])
def test_broken_steps_are_not_correct(root, workload, fault, capsys, monkeypatch):
    attr, broken = faults.FAULTS[fault]
    monkeypatch.setattr(mrt, attr, broken(getattr(mrt, attr)))
    result = one_run(root, workload, capsys)
    assert not result["correct"] and failing(result)


@pytest.mark.parametrize("workload", ["cornell_frames", "smoke_frames", "cornell_train",
                                      "smoke_train"])
def test_control_fails_a_limit(root, workload, capsys):
    rc = calibrate.main(["--workload", workload, "--seconds", "0", "--control-seeds",
                         str(SEED)], root=root, device="cpu")
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["summary"]
    limits = json.loads((root / "rtbench" / "limits" / f"{workload}.json").read_text())["limits"]
    assert any(summary[f"upper.{k}"] > v for k, v in limits.items())
