"""The readers of the program's spans (`host_ms_per_frame.render`,
`host_ms_per_step.train`, `launch_us.train`, `host_syncs_per_step.train`) on
synthetic profiles, and on the card a traced run of each cell: every metric
where its `workloads` say, and every wait of a frame or a step on the card
inside a `mrt.wait.*` span."""

from __future__ import annotations

import contextlib
import json

import pytest
import torch

from benchmark_copy import REPO, copy_benchmark
from rtbench import run as rb
from rtbench.harness import spec
from rtbench.harness import trace as tr

MS = 1_000_000  # ns
NEW = ["host_ms_per_frame.render", "host_ms_per_step.train", "launch_us.train",
       "host_syncs_per_step.train"]
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
SIZES = {"width": 10, "height": 10, "spp": 10, "active": {}, "table_bytes": 0}


def _readers(workload):
    cell = spec.load(REPO, workload)
    return {m["name"]: spec.reader(cell, m["name"]) for m in cell.per_layer
            if m["name"] in NEW}


def frames_trace():
    """A 100-ms window, two frames: the device busy over [0, 35], [45, 85]
    and [90, 95]; `mrt.render` spans over [0, 40] and [42, 96], so 5 + 3 + 5
    + 1 ms of idle lie inside them and 2 + 4 ms outside."""
    device = [(0, 30 * MS, "void fused_render_kernel<true>(...)"),
              (25 * MS, 35 * MS, "Memcpy DtoH (Device -> Pinned)"),
              (45 * MS, 85 * MS, "void fused_render_kernel<true>(...)"),
              (90 * MS, 95 * MS, "void at::native::reduce_kernel<512, 1>(...)")]
    host = [(0, 40 * MS, "mrt.render"), (1 * MS, 2 * MS, "mrt.pack_scene"),
            (36 * MS, 39 * MS, "mrt.wait.rays"), (37 * MS, 38 * MS, "cudaStreamSynchronize"),
            (42 * MS, 96 * MS, "mrt.render"), (86 * MS, 89 * MS, "aten::cat")]
    units = [(0, 41 * MS, "frame"), (41 * MS, 97 * MS, "frame")]
    return tr.Trace((0, 100 * MS), device, host, units)


def train_trace():
    """A 60-ms window, two steps (`mrt.step` over [0, 28] and [30, 58]): the
    device busy over [2, 10], [12, 20], [21, 27], [31, 40], [45, 57], so 2 +
    2 + 1 + 1 + 1 + 5 + 1 ms of idle lie inside the steps; three scan
    launches of 2, 3 and 4 ms; two syncs inside the steps (the second on the
    backward's thread), one between them, one that outlasts the second."""
    device = [(2 * MS, 10 * MS, "ad_step_fwd_kernel<0,0,0,1>"),
              (12 * MS, 20 * MS, "ad_step_fwd_kernel<0,0,0,1>"),
              (21 * MS, 27 * MS, "Memcpy DtoD (Device -> Device)"),
              (31 * MS, 40 * MS, "ad_step_bwd_kernel<4,0,0,0>"),
              (45 * MS, 57 * MS, "ad_step_bwd_kernel<4,0,0,0>")]
    host = [(0, 28 * MS, "mrt.step"), (30 * MS, 58 * MS, "mrt.step"),
            (1 * MS, 3 * MS, "mrt.b2"), (9 * MS, 12 * MS, "mrt.b2"),
            (39 * MS, 43 * MS, "mrt.b3"),
            (4 * MS, 7 * MS, "mrt.wait.sample_base"), (5 * MS, 6 * MS, "cudaStreamSynchronize"),
            (28 * MS + MS // 2, 29 * MS + MS // 2, "cudaStreamSynchronize"),
            (41 * MS, 44 * MS, "mrt.wait.indices"), (41 * MS, 44 * MS, "cudaEventSynchronize"),
            (42 * MS, 43 * MS, "cudaMemcpyAsync"),
            (57 * MS, 59 * MS, "cudaDeviceSynchronize")]
    units = [(0, 29 * MS, "step"), (29 * MS, 59 * MS, "step")]
    return tr.Trace((0, 60 * MS), device, host, units)


def test_frames_reader_counts_idle_inside_the_render_spans():
    (read,) = _readers("smoke_frames").values()
    units = [{"ms": 41.0, "rays": 1, "samples": 1}, {"ms": 55.0, "rays": 1, "samples": 1}]
    assert read(rb.Run("frames", units, 0.1, frames_trace(), SIZES)) == pytest.approx(7.0)
    assert read(rb.Run("frames", units, 0.1, None, SIZES)) is None
    no_spans = frames_trace()._replace(host=[h for h in frames_trace().host
                                             if not h[2].startswith("mrt.")])
    assert read(rb.Run("frames", units, 0.1, no_spans, SIZES)) is None


def test_train_readers_read_steps_launches_and_syncs():
    readers = _readers("cornell_train")
    assert sorted(readers) == sorted(NEW[1:])
    units = [{}, {}]
    got = {n: r(rb.Run("train", units, 0.06, train_trace(), SIZES)) for n, r in readers.items()}
    assert got == {"host_ms_per_step.train": pytest.approx(6.5),
                   "launch_us.train": pytest.approx(3000.0),
                   "host_syncs_per_step.train": pytest.approx(1.0)}
    for trace in (None, train_trace()._replace(host=[h for h in train_trace().host
                                                      if not h[2].startswith("mrt.")])):
        run = rb.Run("train", units, 0.06, trace, SIZES)
        assert {n: r(run) for n, r in readers.items()} == dict.fromkeys(readers)
    frames = rb.Run("frames", units, 0.06, train_trace(), SIZES)
    assert {n: r(frames) for n, r in readers.items()} == dict.fromkeys(readers)


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return copy_benchmark(tmp_path_factory.mktemp("bench"))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["cornell_frames", "smoke_frames", "cornell_train",
                                      "smoke_train"])
def test_traced_run_names_every_wait(card_root, workload, capsys, monkeypatch):
    kept, traced = [], tr.traced

    @contextlib.contextmanager
    def keeping():
        with traced() as out:
            yield out
        kept.append(out["trace"])

    monkeypatch.setattr(tr, "traced", keeping)
    assert rb.main(["--workload", workload, "--seed", "2147483979", "--seconds", "1",
                    "--trace", "1"], root=card_root) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"]
    bench = json.loads((card_root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert (m["name"] in result["metrics"]) == (workload in m["workloads"]), m["name"]
    (trace,) = kept
    unit = "mrt.step" if workload.endswith("_train") else "mrt.render"
    units = [h for h in trace.host if h[2] == unit]
    waits = [h for h in trace.host if h[2].startswith("mrt.wait.")]
    syncs = [h for h in trace.host if h[2] in SYNCS
             and any(u[0] <= h[0] and h[1] <= u[1] for u in units)]
    assert units and syncs
    unnamed = [h for h in syncs if not any(w[0] <= h[0] and h[1] <= w[1] for w in waits)]
    assert not unnamed, f"{len(unnamed)} of {len(syncs)} waits outside a mrt.wait span"
