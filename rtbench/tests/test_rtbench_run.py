"""The entry point's refusals: no card, too few cards, a checkout without the
program, JAX or the JAX package loaded."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from benchmark_copy import REPO, copy_benchmark
from rtbench import run as rb


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "miniraytracer_tpu_torch.fake_sub", object())
    assert rb.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "miniraytracer_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert rb.forbidden_modules() == ["jaxlib", "miniraytracer_tpu"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = rb.main(["--workload", "cornell_frames", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "CUDA" in out.err


def test_too_few_cards_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = rb.main(["--workload", "cornell_train", "--seed", "1", "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_the_set_up_loading_jax_package_ends_the_run(tmp_path, monkeypatch, capsys):
    root = copy_benchmark(tmp_path)
    monkeypatch.setitem(sys.modules, "miniraytracer_tpu", object())
    rc = rb.main(["--workload", "cornell_frames", "--seed", "3", "--seconds", "0.2"],
                 root=root, device="cpu")
    out = capsys.readouterr()
    assert rc == 3 and out.out == "" and "miniraytracer_tpu" in out.err


@pytest.mark.parametrize("workload", ["cornell_frames", "cornell_train"])
def test_a_checkout_of_the_benchmark_alone_fails(tmp_path, workload):
    copy_benchmark(tmp_path)
    proc = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", workload, "--seed", "5",
         "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""
    assert (REPO / "miniraytracer_tpu_torch").exists()


def test_a_run_keeps_the_bytecode_it_compiles_in_its_checkout(tmp_path):
    """Even where the environment asks for no bytecode, a run leaves what it
    compiled (torch's modules among it) under the checkout's
    `rtbench/_pycache/`, for the next run there to read."""
    copy_benchmark(tmp_path)
    subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "cornell_frames", "--seed", "5",
         "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "PYTHONDONTWRITEBYTECODE": "1"})
    cache = tmp_path / "rtbench" / "_pycache"
    assert any(cache.rglob("torch/__init__.cpython-*.pyc"))
