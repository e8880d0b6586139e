"""The port's command line (`miniraytracer_tpu_torch/cli.py`) against the JAX
package's (`miniraytracer_tpu/cli.py`), at 24x24, 4 samples, 3 bounces, on
the CPU (`main(argv, device="cpu")`: the plain versions of the kernels).

- the parser: the same flags, defaults and choices, and `_validate`'s clamps;
- progressive with `-checkpoint` on scene 2 in both packages: the
  checkpointed linear frames' channel means within 1e-5 relative and 99% of
  the pixels within 1e-4 (the port follows JAX op for op; jitted XLA:CPU may
  contract a multiply-add and flip a rare decision);
- the port's straight run equal, bit for bit, to its run resumed from the
  straight run's pass-2 checkpoint (tests/test_cli.py:29);
- `-preview` (passes in Hilbert tile batches) equal to the whole-frame passes
  bit for bit, and `-live` painting ANSI frames;
- `-renderer wavefront|workqueue|hybrid|auto` each writing an image whose
  channel means are within 2e-3 (half an 8-bit step) of JAX's CLI output.
  JAX runs its Pallas kernels on a CPU only in interpret mode, which its CLI
  does not ask for: there its hybrid renderer refuses to run and its auto
  pick is the wavefront, so the port's hybrid and auto images are held
  against JAX's wavefront image (the same estimator, the same RNG streams);
- with no CUDA device and no `device`, `main` raises; `-devices 2` without a
  launcher exits, naming torchrun (tests/test_torch_parallel.py runs the CLI
  on two ranks).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from miniraytracer_tpu import cli as jcli
from miniraytracer_tpu_torch import cli as tcli
from miniraytracer_tpu_torch.utils import checkpoint as tck
from miniraytracer_tpu_torch.utils.image import read_png

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["-scene", "2", "-width", "24", "-height", "24", "-samples", "4", "-depth", "3"]


def _port(argv):
    return tcli.main(argv, device="cpu")


def _jax(argv):
    # one CPU device: the JAX CLI's mesh otherwise spans the test session's
    # eight virtual devices
    return jcli.main(argv + ["-devices", "1"])


def _ppm(path):
    with open(path, "rb") as f:
        data = f.read()
    return np.frombuffer(data[-24 * 24 * 3:], np.uint8).reshape(24, 24, 3)


@pytest.mark.parametrize("argv", [
    [],
    ["-width", "64", "-height", "48", "-samples", "9", "-tilesize", "8", "-threads", "3",
     "-depth", "5", "-scene", "3", "-mode", "0", "-maxlum", "50", "-delay", "-live",
     "-out", "x.ppm", "-tonemap", "gamma", "-renderer", "hybrid", "-preview", "p.png",
     "-checkpoint", "c", "-checkpoint-every", "3", "-resume", "r", "-devices", "1",
     "-fast-perlin", "-seed-check"],
    ["-width", "5", "-height", "9000", "-samples", "0", "-tilesize", "600", "-depth", "0",
     "-scene", "11"],
])
def test_parser_and_clamps_match_jax(argv):
    ours, theirs = tcli.build_parser().parse_args(argv), jcli.build_parser().parse_args(argv)
    assert vars(ours) == vars(theirs)
    assert vars(tcli._validate(ours)) == vars(jcli._validate(theirs))
    actions = lambda p: {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type)
                         for a in p._actions}
    assert actions(tcli.build_parser()) == actions(jcli.build_parser())


def test_progressive_checkpoint_matches_jax(tmp_path, capsys):
    flags = COMMON + ["-checkpoint-every", "2"]
    _jax(flags + ["-checkpoint", str(tmp_path / "j"), "-out", str(tmp_path / "j.png")])
    _port(flags + ["-checkpoint", str(tmp_path / "t"), "-out", str(tmp_path / "t.png")])
    out = capsys.readouterr().out
    for line in ("pass 2/4   50.0%", "pass 4/4  100.0%", f"checkpoint -> {tmp_path / 't.npz'}",
                 "Mrays/s", "us/ray", "(4 spp)", f"wrote {tmp_path / 't.png'}"):
        assert line in out
    fj, sj, cj = tck.load_checkpoint(str(tmp_path / "j"))
    ft, st, ct = tck.load_checkpoint(str(tmp_path / "t"))
    assert (st, ct) == (sj, cj) == (4, {"width": 24, "height": 24, "scene": 2, "samples": 4,
                                        "depth": 3})
    assert ft.shape == fj.shape == (576, 3) and np.isfinite(ft).all()
    np.testing.assert_allclose(ft.mean(0), fj.mean(0), rtol=1e-5)
    assert (np.abs(ft - fj).max(1) <= 1e-4).mean() >= 0.99
    assert read_png(str(tmp_path / "t.png")).shape == (24, 24, 3)


def test_resume_equals_straight_run(tmp_path, monkeypatch, capsys):
    save = tck.save_checkpoint

    def keep_every_pass(path, frame, sample_idx, config):
        save(f"{path}.pass{sample_idx}", frame, sample_idx, config)
        return save(path, frame, sample_idx, config)

    monkeypatch.setattr(tck, "save_checkpoint", keep_every_pass)
    flags = COMMON + ["-scene", "5", "-checkpoint-every", "2"]
    _port(flags + ["-checkpoint", str(tmp_path / "a.npz"), "-out", str(tmp_path / "a.png")])
    _port(flags + ["-resume", str(tmp_path / "a.npz.pass2"), "-checkpoint",
                   str(tmp_path / "b.npz"), "-out", str(tmp_path / "b.png")])
    assert "resumed at pass 2" in capsys.readouterr().out
    fa, sa, _ = tck.load_checkpoint(str(tmp_path / "a.npz"))
    fb, sb, _ = tck.load_checkpoint(str(tmp_path / "b.npz"))
    assert sa == sb == 4 and not os.path.exists(tmp_path / "b.npz.pass2")
    np.testing.assert_array_equal(fa.view(np.int32), fb.view(np.int32))
    assert open(tmp_path / "a.png", "rb").read() == open(tmp_path / "b.png", "rb").read()
    with pytest.raises(SystemExit, match="checkpoint config mismatch"):
        _port(COMMON + ["-resume", str(tmp_path / "a.npz"), "-out", str(tmp_path / "c.png")])


def test_preview_tiles_equal_whole_frame(tmp_path, capsys):
    flags = ["-scene", "2", "-width", "24", "-height", "20", "-samples", "4", "-depth", "3",
             "-tilesize", "8"]
    _port(flags + ["-checkpoint", str(tmp_path / "a"), "-out", str(tmp_path / "a.png")])
    _port(flags + ["-checkpoint", str(tmp_path / "b"), "-out", str(tmp_path / "b.png"),
                   "-preview", str(tmp_path / "pv.png")])
    fa, fb = (tck.load_checkpoint(str(tmp_path / k))[0] for k in "ab")
    np.testing.assert_array_equal(fa.view(np.int32), fb.view(np.int32))
    assert read_png(str(tmp_path / "pv.png")).shape == (20, 24, 3)
    _port(flags + ["-live", "-out", str(tmp_path / "c.png")])
    s = capsys.readouterr().out
    assert s.count("\x1b[2J") == 1  # cleared once
    assert "\x1b[38;2;" in s and "\x1b[48;2;" in s  # truecolor fg + bg
    assert s.count("▀") > 100  # half-block cells


@pytest.fixture(scope="module")
def jax_images(tmp_path_factory):
    """JAX's CLI images by renderer, as 8-bit arrays."""
    d = tmp_path_factory.mktemp("jax_cli")
    for r in ("wavefront", "workqueue"):
        _jax(["-renderer", r] + COMMON + ["-out", str(d / f"{r}.ppm")])
    return {r: _ppm(str(d / f"{r}.ppm")) for r in ("wavefront", "workqueue")}


@pytest.mark.parametrize("renderer,jax_renderer", [
    ("wavefront", "wavefront"), ("workqueue", "workqueue"), ("hybrid", "wavefront"),
    ("auto", "wavefront")])
def test_renderers_match_jax_cli(jax_images, tmp_path, capsys, renderer, jax_renderer):
    _port(["-renderer", renderer] + COMMON + ["-out", str(tmp_path / "t.ppm")])
    out = capsys.readouterr().out
    assert "Mrays/s" in out and "us/ray" in out
    if renderer == "auto":
        assert "auto renderer: fused" in out
    ours, theirs = _ppm(str(tmp_path / "t.ppm")) / 255.0, jax_images[jax_renderer] / 255.0
    assert ours.max() > 0
    np.testing.assert_allclose(ours.mean((0, 1)), theirs.mean((0, 1)), rtol=0, atol=2e-3)


def test_wavefront_takes_the_fused_kernel_where_jax_does(tmp_path, monkeypatch):
    """JAX's CLI renders -renderer wavefront over its mesh with the fused
    kernel where the scene is eligible (`render_wavefront_distributed(
    fused=None)`), else the wavefront of tensor operations; so does the
    port's, on its trivial mesh without a launcher."""
    from miniraytracer_tpu_torch.models import integrator
    from miniraytracer_tpu_torch.ops import bounce

    taken = []
    for mod, name in ((bounce, "render_wavefront_fused_pixels"),
                      (integrator, "render_wavefront_pixels")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, name=name, **k: (
            taken.append(name), real(*a, **k))[1])
    for scene in ("2", "4"):
        _port(["-renderer", "wavefront", "-scene", scene, "-width", "16", "-height", "16",
               "-samples", "1", "-depth", "2", "-out", str(tmp_path / f"{scene}.png")])
    assert taken == ["render_wavefront_fused_pixels", "render_wavefront_pixels"]


def test_main_runs_on_the_gpu_or_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(COMMON + ["-out", str(tmp_path / "x.png")])
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        tcli.main(COMMON + ["-devices", "2"], device="cpu")
    assert not os.path.exists(tmp_path / "x.png")


def test_module_entry_point():
    proc = subprocess.run([sys.executable, "-m", "miniraytracer_tpu_torch", "-h"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "usage: miniraytracer_tpu_torch" in proc.stdout
