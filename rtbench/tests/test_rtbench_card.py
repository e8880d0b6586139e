"""The harness on the card at sizes a test run holds: every cell's run comes
out correct and the bfloat16 control fails one of its limits. Skips without
a card (run on the card: `python -m pytest rtbench/tests -m cuda`)."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark_copy import copy_benchmark
from rtbench import calibrate
from rtbench import run as rb

CELLS = ["cornell_frames", "smoke_frames", "cornell_train", "smoke_train"]


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return copy_benchmark(tmp_path_factory.mktemp("bench"))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_run_on_the_card_is_correct(card_root, workload, capsys):
    assert rb.main(["--workload", workload, "--seed", "2147483977", "--seconds", "1",
                    "--trace", "1"], root=card_root) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0 and result["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card_fails_a_limit(card_root, workload, capsys):
    assert calibrate.main(["--workload", workload, "--seconds", "0", "--control-seeds",
                           "2147483978"], root=card_root) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["summary"]
    limits = json.loads((card_root / "rtbench" / "limits" / f"{workload}.json").read_text())
    assert any(summary[f"upper.{k}"] > v for k, v in limits["limits"].items())
